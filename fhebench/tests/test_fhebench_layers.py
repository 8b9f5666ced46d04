"""The readers of the program's own spans and counters on a synthetic run:
the bootstrap's three phase times from the engine's counters, and the idle
time the pipeline's and the primitives' ranges hold, where a gap under
the harness's request range alone counts for neither."""
import pytest

from fhebench import cell, tracing
from fhebench.run import ROOT, Run


def _reader(name):
    return cell.load_module(ROOT / "fhebench" / "metrics" / f"{name}.py",
                            name)


def _run(counters=None, trace=None):
    return Run(cell="c", config={}, mix={}, seconds=2.0, setup_s=40.0,
               requests=1, rounds=10, block_rounds=10 * 2048,
               peak_bytes=0, counters=counters or {}, launches={},
               device_name="NVIDIA H100 80GB HBM3", trace=trace)


# window [0, 100) ns.  Gaps: [10, 15) under the request alone, [20, 25)
# under the round, [30, 41) under SubBytes, [43, 47) under ckks.rescale,
# [50, 66) under the round again, [68, 80) under the bootstrap's phase,
# [85, 100) under the request alone
OPS = [("k", 0, 10), ("k", 15, 20), ("k", 25, 30), ("k", 41, 43),
       ("k", 47, 50), ("k", 66, 68), ("k", 80, 85)]
SPANS = [(0, 100, tracing.WINDOW), (2, 98, "fhebench.request"),
         (12, 60, "ckks.aes.round"), (22, 40, "ckks.aes.sub_bytes"),
         (41, 49, "ckks.rescale"), (62, 75, "ckks.boot"),
         (63, 70, "ckks.boot.cts")]


def _trace(spans=SPANS):
    return tracing.Trace((0, 100), OPS, spans)


@pytest.mark.parametrize("phase", ["cts", "evalmod", "stc"])
def test_bootstrap_phase_readers(phase):
    r = _reader(f"bootstrap.{phase}_ms")
    counters = {"bootstrap": 8, f"boot.{phase}_ns": 8 * 150_000_000}
    assert r.read(_run(counters)) == pytest.approx(150.0)
    # a program without the counter, or a window without a bootstrap
    assert r.read(_run({"bootstrap": 8})) is None
    assert r.read(_run({"bootstrap": 0, f"boot.{phase}_ns": 0})) is None


def test_idle_shares_by_range():
    run = _run(trace=_trace())
    pipeline = _reader("pipeline.idle_share").read(run)
    engine = _reader("engine.idle_share").read(run)
    idle = _reader("device.idle_share").read(run)
    assert pipeline == pytest.approx(5 + 11 + 16)
    assert engine == pytest.approx(4)
    assert idle == pytest.approx(68)
    assert pipeline + engine <= idle
    # the harness's own range holds the rest beside the bootstrap's phase
    gaps = dict(run.trace.idle_gaps())
    assert gaps["fhebench.request"] == pytest.approx(20e-9)
    assert gaps["ckks.boot.cts"] == pytest.approx(12e-9)


def test_idle_shares_without_the_programs_spans():
    """A program without the pipeline's spans (its gaps fall to the request
    and the primitives): the pipeline's share is left out; an untraced run
    reads neither."""
    spans = [s for s in SPANS if not s[2].startswith("ckks.aes.")]
    run = _run(trace=_trace(spans))
    assert _reader("pipeline.idle_share").read(run) is None
    assert _reader("engine.idle_share").read(run) == pytest.approx(4)
    for name in ("pipeline.idle_share", "engine.idle_share"):
        assert _reader(name).read(_run()) is None
