"""The inverse cells: the plain AES's `decrypt` against FIPS-197 Appendix
C.1's inverse cipher listing round by round, and its InvMixColumns against
the equivalent inverse cipher's; the control at the new cells' own window
sizes; and a whole run of the `bitsliced_inv` adapter on the CPU at a small
cell, sound and with a planted fault (each run a process of its own in a
temporary checkout, as the benchmark's runs are)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fhebench import traffic
from fhebench.reference import aes, check
from fhebench.run import ROOT
from fhebench.tests.conftest import make_checkout

KEY = bytes(range(16))
PT = bytes.fromhex("00112233445566778899aabbccddeeff")
CT = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
# FIPS-197 C.1, INVERSE CIPHER: round[k].is_box is the state after the
# inverse of AES round 11 - k, i.e. AES's state after round 10 - k;
# round[k].ik_add the same with AddRoundKey(w[10 - k]) applied
INV_IS_BOX = {1: "bd6e7c3df2b5779e0b61216e8b10b689",
              2: "fde3bad205e5d0d73547964ef1fe37f1",
              10: "00102030405060708090a0b0c0d0e0f0"}
INV_IS_ROW = {1: "7a9f102789d5f50b2beffd9f3dca4ea7",
              2: "5411f4b56bd9700e96a0902fa1bb9aa1"}
INV_IK_ADD = {1: "e9f74eec023020f61bf2ccf2353c21c7",
              2: "baa03de7a1f9b56ed5512cba5f414d23"}
INV_ISTART = {1: "7ad5fda789ef4e272bca100b3d9ff59f",
              2: "54d990a16ba09ab596bbf40ea111702f"}
# EQUIVALENT INVERSE CIPHER: round[k].is_row -> round[k].im_col
EQ_IM_COL = {"bd6e7c3df2b5779e0b61216e8b10b689":
             "4773b91ff72f354361cb018ea1e6cf2c",
             "fde3bad205e5d0d73547964ef1fe37f1":
             "2d7e86a339d9393ee6570a1101904e16",
             "d1876c0f79c4300ab45594add66ff41f":
             "39daee38f4f1a82aaf432410c36d45b9"}
# the equivalent inverse cipher's round keys: round[k].ik_sch = dw[10 - k]
EQ_IK_SCH = {0: "13111d7fe3944a17f307a78b4d2b30c5",
             1: "13aa29be9c8faff6f770f58000f7bf03",
             2: "1362a4638f2586486bff5a76f7874a83",
             3: "8d82fc749c47222be4dadc3e9c7810f5",
             4: "72e3098d11c5de5f789dfe1578a2cccb",
             9: "8c56dff0825dd3f9805ad3fc8659d7fd",
             10: "000102030405060708090a0b0c0d0e0f"}


def hexs(a) -> str:
    return np.asarray(a, dtype=np.uint8).tobytes().hex()


def block(h: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(h), dtype=np.uint8).reshape(1, 16)


def test_decrypt_round_by_round_fips197_c1():
    """The listing's state after each listed inverse round is AES's state
    after round 10 - k, and decrypt takes it back to the plaintext in the
    rounds left; the first two rounds' steps, one by one."""
    rk = aes.expand_key(KEY)
    assert hexs(aes.decrypt(CT, KEY)) == PT.hex()
    for k, h in INV_IS_BOX.items():
        assert hexs(aes.encrypt(PT, KEY, 10 - k)) == h
        assert hexs(aes.decrypt(block(h), KEY, 10 - k)) == PT.hex()
    s = block(CT.hex())
    for k in (1, 2):
        s = s ^ rk[11 - k]
        if k > 1:
            s = aes.inv_mix_columns(s)
        assert hexs(s) == INV_ISTART[k]
        s = s[:, aes._INV_SHIFT]
        assert hexs(s) == INV_IS_ROW[k]
        s = aes.INV_SBOX[s]
        assert hexs(s) == INV_IS_BOX[k]
        assert hexs(s ^ rk[10 - k]) == INV_IK_ADD[k]


def test_equivalent_inverse_listing_fips197_c1():
    """InvMixColumns of the equivalent inverse cipher's is_row states, and
    its round keys dw[r] = InvMixColumns(w[r]) (w[0] and w[10] as they
    are); one whole round: istart(2) = im_col(1) ^ ik_sch(1)."""
    rk = aes.expand_key(KEY)
    for row, col in EQ_IM_COL.items():
        assert hexs(aes.inv_mix_columns(block(row))) == col
    for k, h in EQ_IK_SCH.items():
        r = 10 - k
        dw = rk[r] if r in (0, 10) else aes.inv_mix_columns(rk[r][None])
        assert hexs(dw) == h
    im_col = block(EQ_IM_COL["bd6e7c3df2b5779e0b61216e8b10b689"])
    assert hexs(im_col ^ block(EQ_IK_SCH[1])) == INV_ISTART[2]


# the answers of a 30-second window, by mix: dec10 holds 2-3 ciphers,
# inv1 ~5 requests
WINDOWS = {"dec10": [0, 1, 2], "inv1": [i % 4 for i in range(6)]}
SEEDS = [2 ** 31 + 11, 4_000_000_001]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["bitsliced-inv-prod_boot.dec10",
                                  "zeta-prod_boot.inv1"])
def test_control_of_the_inverse_cells(cell, seed):
    """As test_fhebench_control, at the inverse cells' own sizes: the
    reference passes, the control (one bit of each answer flipped) fails."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    mix = traffic.load(ROOT / "fhebench" / "traffic" /
                       f"{w['traffic']}.json")
    assert mix["direction"] == "decrypt"
    key = bytes.fromhex(config["aes_key"])
    pts = {b: traffic.plaintexts(seed, b, config["blocks_per_batch"],
                                 config["fips_block0"])
           for b in range(mix["batches"])}
    # what the program is handed decrypts to the batch's plaintexts
    given = traffic.program_input(mix, pts[0], key)
    assert hexs(aes.decrypt(given, key, mix["rounds_per_cipher"])) == \
        hexs(pts[0].reshape(-1, 16))
    if w["traffic"] == "dec10":
        assert given[:16].tobytes() == CT
    args = (pts, key, mix["direction"], mix["rounds_per_cipher"])
    shape = WINDOWS[w["traffic"]]
    sound = [check.Answer(b, check.expected(pts[b], *args[1:]))
             for b in shape]
    assert check.passes(check.judge(sound, *args))
    verdict = check.judge(check.control(sound, *args, seed), *args)
    assert verdict["wrong_bytes"] == len(shape)
    assert not check.passes(verdict)


SMALL_CONFIG = {
    "name": "bitsliced-inv-deep",
    "source": "the port's deep profile: N=2^12, 48 levels, no bootstrap",
    "profile": "deep",
    "params": {"n": 4096, "max_level": 48, "scale_bits": 28,
               "num_special_primes": 6, "alpha": 6, "dnum": 9,
               "secret_hamming": None, "error_std": 3.2},
    "pipeline": "bitsliced_inv",
    "refresh": {"bootstrap": "none"},
    "blocks_per_batch": 128,
    "aes_key": "000102030405060708090a0b0c0d0e0f",
    "fips_block0": True,
    "guarantee": "every block equals FIPS-197 InvCipher exactly",
    "assumed": [],
    "reduced": [],
}
SMALL_MIX = {"loop": "closed", "clients": 1, "direction": "decrypt",
             "rounds_per_cipher": 1, "batches": 2, "refresh": False}
SMALL_CELL = "bitsliced-inv-deep.dec1"


@pytest.fixture
def inv_checkout(tmp_path):
    dest = make_checkout(tmp_path)
    h = dest / "fhebench"
    (h / "configs" / "bitsliced-inv-deep.json").write_text(
        json.dumps(SMALL_CONFIG))
    (h / "traffic" / "dec1.json").write_text(json.dumps(SMALL_MIX))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bitsliced-inv-deep",
                             "source": SMALL_CONFIG["source"],
                             "file": "fhebench/configs/bitsliced-inv-deep."
                                     "json",
                             "reduced": [], "why": "a CPU-sized config"})
    bench["workloads"].append({"name": SMALL_CELL,
                               "config": "bitsliced-inv-deep",
                               "traffic": "dec1", "chips": 1,
                               "why": "a CPU-sized cell"})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


DRIVE = ("import json, sys\n"
         "from fhebench import cell, run\n"
         "from fhebench.tests.test_fhebench_faults import FAULTS\n"
         f"c = cell.load({SMALL_CELL!r}, run.ROOT)\n"
         "fault = FAULTS[sys.argv[1]]\n"
         "if fault is not None:\n"
         "    c.pipeline.System.run = fault(c.pipeline.System.run)\n"
         "print(json.dumps(run.run_cell(c, 2 ** 31 + 7, 0.1, False, "
         "device='cpu')))\n")


@pytest.mark.parametrize("name", ["sound", "altered"])
def test_inverse_adapter_run_on_the_cpu(inv_checkout, name):
    """A whole run of the bitsliced_inv adapter (one inverse round on the
    deep profile): the sound program reads correct, a planted fault (one
    answer's byte altered where it is produced) reads not correct."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", DRIVE, name],
                         cwd=inv_checkout, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["attempted"] >= 1
    checks = {k: v["value"] for k, v in res["checks"].items()}
    if name == "sound":
        assert res["correct"] and res["failed"] == 0
        assert checks == {"wrong_bytes": 0, "unchecked_answers": 0}
    else:
        assert not res["correct"] and checks["wrong_bytes"] >= 1
