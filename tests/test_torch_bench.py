"""`python -m aesfhe_tpu_torch bench` against the root bench.py (the
reference's harness, loaded by path and left as it is).

- The flagship mapping: from a recorded run_full_aes result, the
  reference's field names exactly (read from bench.py's source) and the
  stated arithmetic; a failed, timed-out, malformed or inexact flagship
  exits non-zero with nothing on stdout (no fallback to the one-round
  metric, unlike the reference).
- The bitplane and zeta legs at AESFHE_BENCH_LOGN=10 on the CPU: one JSON
  line with the reference's keys, and each step's output residues, level
  and scale equal to the reference's same step on the same seed-0 keys
  and input (the port's complex64 device encode is routed through the
  reference's, as tests/test_torch_drift.py does, since the two packages
  round it differently), and the bytes equal to the plain AES oracle.

    python -m pytest tests/test_torch_bench.py -q
"""
import ast
import importlib.util
import json
import os
import subprocess

import numpy as np
import pytest
import torch

from aesfhe_tpu.core import dev_encoding as jdev
from aesfhe_tpu.core import keys as jkeys
from aesfhe_tpu_torch import bench, interop
from aesfhe_tpu_torch.core import dev_encoding as tdev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BENCH = os.path.join(REPO, "bench.py")
LOGN, LEVELS = 10, 16
LEG_KEYS = {"metric", "value", "unit", "vs_baseline", "iters", "t_min_s",
            "t_median_s", "t_max_s"}
LEG_METRICS = dict(bitplane="aes_fhe_full_round_blocks_per_s",
                   zeta="aes_fhe_ark_subbytes_round_step_blocks_per_s")
# a run_full_aes result as the flagship prints it (fields the mapping reads
# and a few it does not)
RECORD = dict(
    rounds=10, blocks=2048, work_level=15, encrypt_s=1.3, wall_s=116.57,
    blocks_per_s=2048 / 116.57, s_per_round=11.657,
    round_s=[1.71, 18.9, 12.1, 12.43, 12.55, 12.15, 12.0, 12.31, 12.48,
             11.04],
    bootstraps=36, bootstrap_s=[8.89] + [2.5] * 35, keyswitches=6846,
    ks_inner_launches=6846,
    counters=dict(rotate=3936, keyswitch=6846, bootstrap=36),
    exact=True, bad_bytes=0, fips_block0=True, profile="prod_boot")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference_flagship_fields() -> set:
    """The keys of the dict literal bench.py prints for the flagship."""
    tree = ast.parse(open(REF_BENCH).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if "ms_per_round" in keys:
                return keys
    raise AssertionError("bench.py prints no flagship record")


def test_flagship_record_maps_the_references_fields():
    rec = bench.flagship_record(dict(RECORD))
    assert set(rec) == _reference_flagship_fields()
    wall = RECORD["wall_s"]
    assert rec["metric"] == "aes_fhe_10round_blocks_per_s"
    assert rec["value"] == RECORD["blocks_per_s"]
    assert rec["vs_baseline"] == 0.0 and rec["warmup_s"] == 0.0
    assert rec["ms_per_round"] == 1000 * RECORD["s_per_round"]
    assert rec["blocks_per_s_steady"] == 2048 / (10 * float(
        np.median(RECORD["round_s"][1:])))
    assert rec["rotations_per_s"] == 3936 / wall
    assert rec["keyswitches_per_s"] == 6846 / wall
    assert rec["bootstrap_s_total"] == sum(RECORD["bootstrap_s"])
    assert "36 bootstraps" in rec["unit"] and "N=2^16" in rec["unit"]
    assert "warmup_s is 0.0" in rec["unit"]


def _child(rc=0, record=None, stdout=None):
    if stdout is None:
        stdout = "keygen ...\n" + (json.dumps(record) + "\n" if record
                                   else "")
    return subprocess.CompletedProcess([], rc, stdout=stdout,
                                       stderr="Traceback: boom\n")


def _timeout(*a, **k):
    raise subprocess.TimeoutExpired(a[0], 1, output="round 3 ...",
                                    stderr="")


@pytest.mark.parametrize("case", ["inexact", "fips_false", "child_failed",
                                  "timeout", "no_result"])
def test_failed_flagship_exits_nonzero_without_fallback(case, monkeypatch,
                                                        capsys):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        if case == "timeout":
            _timeout(cmd)
        if case == "inexact":
            return _child(record=dict(RECORD, exact=False, bad_bytes=3))
        if case == "fips_false":
            return _child(record=dict(RECORD, fips_block0=False))
        if case == "child_failed":
            return _child(rc=1, record=dict(RECORD, exact=False))
        return _child(stdout="keygen ...\n")

    monkeypatch.setenv("AESFHE_BENCH_MODE", "flagship")
    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    assert bench.main("cpu") == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no fallback" in out.err
    assert len(calls) == 1
    assert calls[0][1:3] == ["-m", "aesfhe_tpu_torch.run_full_aes"]
    assert calls[0][3:] == ["--device", "cpu"]


def test_flagship_success_prints_one_line(monkeypatch, capsys):
    monkeypatch.setenv("AESFHE_BENCH_MODE", "flagship")
    monkeypatch.setattr(bench.subprocess, "run",
                        lambda cmd, **kw: _child(record=dict(RECORD)))
    assert bench.main("cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == bench.flagship_record(dict(RECORD))


@pytest.fixture(scope="module")
def ref_bench():
    """The root bench.py as a module (its MODE is read at import)."""
    spec = importlib.util.spec_from_file_location("_reference_bench",
                                                  REF_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def routed_encode():
    """The port's device encode through the reference's (residue-equal
    plaintexts and fresh encryptions)."""
    from aesfhe_tpu.core import ops_impl as jops
    from aesfhe_tpu.core.params import CKKSParams as JParams
    jp = JParams(n=1 << LOGN, max_level=LEVELS, scale_bits=28,
                 num_special_primes=4)
    jt = jops.DeviceTables.build(jp)

    def ref_encode(params, tabs, vec, level, scale):
        assert params.all_primes == jp.all_primes
        return interop.to_tensor(np.asarray(jdev.encode_eval_dev(
            jp, jt, vec, level, scale)), device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdev, "encode_eval_dev", ref_encode)
        yield


@pytest.fixture(scope="module")
def port_legs(routed_encode):
    """The port's leg of each mode at N=2^10 on the CPU, built once; it
    runs under the routed encode whenever a test of this module runs."""
    legs = {}

    def get(mode):
        if mode not in legs:
            legs[mode] = bench.SETUPS[mode](LOGN, LEVELS, "cpu")
        return legs[mode]

    return get


def _reference_step(ref_bench, mode):
    """The reference's step output on bench.py's own seed-0 keys and
    input (generated, not read from the test run's key cache)."""
    setup = dict(bitplane=ref_bench._setup_bitplane,
                 zeta=ref_bench._setup_zeta)[mode]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkeys, "_rng", jkeys._rng)       # bench.py reseeds it
        mp.delenv("AESFHE_KEY_CACHE", raising=False)
        step, args, blocks = setup(LOGN, LEVELS)
        return step(*args), blocks


def _u32(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


# the reference's bit-sliced round compiles ~33 s of JAX programs on the
# CPU, the zeta step ~20 s: the round's compare is `slow`
@pytest.mark.parametrize("mode", [
    "zeta", pytest.param("bitplane", marks=pytest.mark.slow)])
def test_leg_step_matches_reference(mode, port_legs, ref_bench):
    """The step's output ciphertexts equal the reference's residue for
    residue, and decrypt to the plain AES oracle."""
    leg = port_legs(mode)
    want, blocks = _reference_step(ref_bench, mode)
    assert blocks == leg.blocks == (1 << LOGN) // 32
    out = leg.step(*leg.args)
    cts = out.bits if mode == "bitplane" else [out.hi, out.lo]
    assert len(cts) == len(want)
    for ct, w in zip(cts, want, strict=True):
        assert torch.equal(ct.data, interop.to_tensor(_u32(w),
                                                      device="cpu"))
    assert bench.check_leg(leg, out) == 0


@pytest.mark.parametrize("mode", ["bitplane", "zeta"])
def test_leg_prints_one_json_line(mode, port_legs, monkeypatch, capsys):
    """`bench` in the leg's mode on --device cpu: one JSON line with the
    reference's keys and metric name, from an output that decrypts to the
    AES oracle (the leg built once, by the fixture)."""
    leg = port_legs(mode)
    for k, v in dict(AESFHE_BENCH_MODE=mode, AESFHE_BENCH_LOGN=str(LOGN),
                     AESFHE_BENCH_LEVELS=str(LEVELS), AESFHE_BENCH_ITERS="1",
                     AESFHE_BENCH_SKIP_CPU="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("AESFHE_BENCH_CHILD", raising=False)
    monkeypatch.setitem(bench.SETUPS, mode, lambda logn, levels, device: leg)
    assert bench.main("cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == LEG_KEYS
    assert rec["metric"] == LEG_METRICS[mode]
    assert rec["iters"] == 1 and rec["vs_baseline"] == 0.0
    assert rec["t_min_s"] == rec["t_median_s"] == rec["t_max_s"] > 0
    assert rec["value"] == leg.blocks / rec["t_median_s"]


def test_cli_bench_needs_a_card_unless_told_cpu(monkeypatch):
    """`python -m aesfhe_tpu_torch bench` runs on the card by default."""
    from aesfhe_tpu_torch.__main__ import main
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    monkeypatch.setenv("AESFHE_BENCH_MODE", "zeta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["bench"])
