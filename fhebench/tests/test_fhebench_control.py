"""The control of the comparison that decides `correct`: the reference put
in the program's place, with the guarantee the configuration states
(FIPS-197, every bit) broken as an evaluation below its precision breaks
it, one bit of one byte of each answer decoded the wrong way.  At each
shipped cell's own size (2048-block batches, the answers of a 30-second
window) and on several seeds it reads `wrong_bytes` >= 1 and fails; the
reference itself reads 0 and passes."""
import json

import pytest

from fhebench import traffic
from fhebench.reference import check
from fhebench.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# the batches of a 30-second window's answers, by mix: one answer a
# request (a whole cipher)
WINDOWS = {"aes10": [0, 1],
           "round1": [i % 4 for i in range(21)]}
SEEDS = [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13, 4_000_000_001]


def _cell(w):
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    mix = traffic.load(ROOT / "fhebench" / "traffic" / f"{w['traffic']}.json")
    return config, mix


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_control_fails_and_reference_passes(w, seed):
    config, mix = _cell(w)
    key = bytes.fromhex(config["aes_key"])
    pts = {b: traffic.plaintexts(seed, b, config["blocks_per_batch"],
                                 config["fips_block0"])
           for b in range(mix["batches"])}
    shape = WINDOWS[w["traffic"]]
    sound = [check.Answer(b, check.expected(
        pts[b], key, mix["direction"], mix["rounds_per_cipher"]))
        for b in shape]
    args = (pts, key, mix["direction"], mix["rounds_per_cipher"])
    assert check.passes(check.judge(sound, *args))
    verdict = check.judge(check.control(sound, *args, seed), *args)
    print(f"{w['name']} seed {seed}: control wrong_bytes "
          f"{verdict['wrong_bytes']}")
    assert verdict["wrong_bytes"] == len(shape)
    assert not check.passes(verdict)
