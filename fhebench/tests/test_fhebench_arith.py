"""The harness's arithmetic on synthetic inputs: intervals, the trace's
busy and idle time, rates over a window, the roofline bytes and shares, the
traffic plan and the comparison that decides `correct`."""
import numpy as np
import pytest

from fhebench import cell, roofline, tracing, traffic
from fhebench.reference import aes, check, formulas
from fhebench.run import ROOT, Run


def test_union_and_gaps():
    busy = tracing.union(sorted([(0, 10), (5, 12), (12, 15), (20, 30),
                                 (22, 25)]))
    assert busy == [(0, 15), (20, 30)]
    assert tracing.gaps_of(busy, (-5, 40)) == [(-5, 0), (15, 20), (30, 40)]
    assert tracing.gaps_of([], (0, 7)) == [(0, 7)]


def test_innermost_span():
    spans = [(0, 100, "outer"), (10, 20, "a"), (30, 60, "b"), (40, 50, "c")]
    assert tracing.innermost(spans, [5, 15, 25, 45, 55, 200]) == \
        ["outer", "a", "outer", "c", "b", None]


def _trace():
    # window [0, 100) ns; kernels overlap; one starts before the window
    ops = [("ntt_cluster<true>", 10, 30), ("ks_inner_kernel", 20, 45),
           ("elementwise", 60, 70), ("ntt_block<false>", 80, 90)]
    return tracing.Trace((0, 100), ops,
                         [(0, 100, tracing.WINDOW), (55, 75, "ckks.rescale")])


def test_trace_busy_idle_and_breakdown():
    t = _trace()
    assert t.busy_s() == pytest.approx(55e-9)
    assert t.window_s == pytest.approx(100e-9)
    assert [n for n, _, _ in t.matching(
        r"ntt_(cluster16|cluster|block|cols|runs)")] == \
        ["ntt_cluster<true>", "ntt_block<false>"]
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(45e-9)
    assert gaps["ckks.rescale"] == pytest.approx(10e-9)
    assert gaps[tracing.WINDOW] == pytest.approx(35e-9)
    assert t.top_ops()[0] == ["ks_inner_kernel", pytest.approx(25e-9)]


def _run(**kw):
    base = dict(cell="c", config={}, mix={}, seconds=2.0, setup_s=40.0,
                requests=4, rounds=20, block_rounds=20 * 2048,
                peak_bytes=3 * 2 ** 30, counters={"keyswitch": 1000,
                                                  "bootstrap": 8},
                launches={"ntt_fwd": 3, "ntt_inv": 1, "ks_inner": 1},
                device_name="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return Run(**base)


def _reader(name):
    return cell.load_module(ROOT / "fhebench" / "metrics" / f"{name}.py",
                            name)


def test_end_to_end_readers():
    r = _run()
    assert _reader("block_rounds_per_s").read(r) == 20 * 2048 / 2.0
    assert _reader("peak_mem_gib").read(r) == 3.0
    assert _reader("setup_s").read(r) == 40.0


def test_layer_readers():
    r = _run(refresh_s=[0.1] * 8, trace=_trace())
    assert _reader("pipeline.round_ops_s").read(r) == \
        pytest.approx((2.0 - 0.8) / 20)
    assert _reader("bootstrap.s_per_boot").read(r) == pytest.approx(0.1)
    assert _reader("engine.keyswitches_per_round").read(r) == 50.0
    assert _reader("device.idle_share").read(r) == pytest.approx(45.0)
    assert _reader("bootstrap.s_per_boot").read(
        _run(counters={"keyswitch": 0, "bootstrap": 0})) is None


def test_roofline_share_and_its_agreement_checks():
    bw = formulas.HBM_BYTES_PER_S["NVIDIA H100 80GB HBM3"]
    nbytes = int(bw * 30e-9 * 0.4)          # 40% of the bound in 30 ns
    r = _run(trace=_trace(), tally={"ntt_fwd": (1, nbytes),
                                    "ntt_inv": (1, 0)},
             launches={"ntt_fwd": 1, "ntt_inv": 1})
    pat = r"ntt_(cluster16|cluster|block|cols|runs)"
    assert roofline.share(r, "ntt_roofline", ("ntt_fwd", "ntt_inv"),
                          pat) == pytest.approx(40.0, rel=1e-6)
    # the tally and the launch counters disagree: left out, with a note
    r.launches = {"ntt_fwd": 3, "ntt_inv": 1}
    assert roofline.share(r, "ntt_roofline", ("ntt_fwd", "ntt_inv"),
                          pat) is None
    assert "4 counted" in r.notes[-1]
    # the trace holds another number of kernels than were launched
    r.launches = {"ntt_fwd": 2, "ntt_inv": 1}
    r.tally = {"ntt_fwd": (2, nbytes), "ntt_inv": (1, 0)}
    assert roofline.share(r, "ntt_roofline", ("ntt_fwd", "ntt_inv"),
                          pat) is None
    assert "2 kernels in the trace" in r.notes[-1]


def test_frozen_byte_formulas():
    # [7, 63, 2^16] int32 in, int64 out; ks_inner at J = 7, M = 63
    assert formulas.ntt_bytes(7, 63, 1 << 16, 4, 8) == 12 * 7 * 63 * 65536
    assert formulas.ntt_launches(1 << 16) == 1
    assert formulas.ntt_launches(1 << 18) == 1
    assert formulas.ntt_launches(1 << 19) == 2
    assert formulas.ks_inner_bytes(7, 63, 1 << 16) == \
        (3 * 7 * 63 + 2 * 63) * 65536 * 4


def test_tally_counts_graph_replays_once_per_replay():
    state = tracing.Tallies()
    state.add("ntt_fwd", 1, 100)
    owner = object()
    state.graphs[id(owner)] = [("ntt_fwd", 2, 50), ("ks_inner", 1, 7)]
    state.replay(owner)
    state.replay(owner)
    assert state.totals == {"ntt_fwd": [5, 200], "ks_inner": [2, 14]}


def test_requests_cycle_batches():
    plan = traffic.requests(dict(rounds_per_cipher=10, batches=3))
    assert [next(plan) for _ in range(7)] == [0, 1, 2, 0, 1, 2, 0]
    one = traffic.requests(dict(rounds_per_cipher=1, batches=4))
    assert [next(one) for _ in range(6)] == [0, 1, 2, 3, 0, 1]


def test_batches_come_from_the_seed():
    a = traffic.plaintexts(2 ** 31 + 5, 0, 2048, True)
    assert np.array_equal(a, traffic.plaintexts(2 ** 31 + 5, 0, 2048, True))
    assert not np.array_equal(a, traffic.plaintexts(2 ** 31 + 5, 1, 2048,
                                                    True))
    assert a[:16].tobytes() == traffic.FIPS_PT
    assert a.shape == (2048 * 16,)


@pytest.mark.parametrize("mix", ["aes10", "round1", "inv1"])
def test_shipped_mixes_load(mix):
    m = traffic.load(ROOT / "fhebench" / "traffic" / f"{mix}.json")
    assert set(m) == traffic.KEYS


def test_judge_counts_wrong_bytes_and_missing_answers():
    key = bytes(range(16))
    pts = {0: traffic.plaintexts(1, 0, 4, True),
           1: traffic.plaintexts(1, 1, 4, False)}
    right = [check.Answer(0, aes.encrypt(pts[0], key, 10)),
             check.Answer(1, aes.encrypt(pts[1], key, 10))]
    v = check.judge(right, pts, key, "encrypt", 10)
    assert v == dict(wrong_bytes=0, unchecked_answers=0, failed=0)
    assert check.passes(v)
    bad = right[1].got.copy().reshape(-1)
    bad[5] ^= 0x10
    v = check.judge([right[0], check.Answer(1, bad), check.Answer(0, None)],
                    pts, key, "encrypt", 10)
    assert v == dict(wrong_bytes=1, unchecked_answers=1, failed=2)
    assert not check.passes(v)
    three = [check.Answer(1, aes.encrypt(pts[1], key, 3))]
    assert check.passes(check.judge(three, pts, key, "encrypt", 3))
    inv = [check.Answer(0, pts[0])]
    assert check.passes(check.judge(inv, pts, key, "decrypt", 1))
