"""Card-only checks of the port's CUDA kernels against their plain versions
(the LUT sums inside a captured graph too), of the fused bootstrap's CUDA
graph against the eager bootstrap, and of a captured key-switch against the
eager one.

Skipped without a CUDA card.  This file imports no JAX, so it also runs on
a machine without the reference package's dependencies:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.bootstrap import FusedBootstrap
from aesfhe_tpu_torch.context import EngineContext
from aesfhe_tpu_torch.core import (ks_inner, ks_legs, lut_sum, ntt, ops_impl,
                                   rns)
from aesfhe_tpu_torch.core.params import CKKSParams, get_params


@pytest.mark.parametrize("J,dnum,rows,Mk", [
    (7, 7, np.arange(63), 63),                  # full layout, top level
    (2, 3, np.r_[0:15, 18:26], 26),             # capped key, fewer digits
])
def test_ks_inner_kernel_equals_plain(J, dnum, rows, Mk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = get_params("prod_boot")
    dev = torch.device("cuda")
    rows = rows.astype(np.int32)
    qk = np.asarray([p.all_primes[i % p.L_tot] for i in range(Mk)],
                    dtype=np.int64)
    qs = qk[rows]
    rng = np.random.default_rng(J)
    d = rng.integers(0, 1 << 62, (J, len(rows), p.n)) % qs[:, None]
    kb, ka = (rng.integers(0, 1 << 62, (dnum, Mk, p.n)) % qk[:, None]
              for _ in range(2))
    qinv = [rns.montgomery_consts(int(q))[0] for q in qs]
    t = [interop.to_tensor(np.asarray(a, dtype=np.uint32), dev)
         for a in (d, kb, ka, qs, qinv)]
    before = ks_inner.launches
    got = ks_inner.ks_inner(t[0], t[1], t[2], rows, t[3], t[4])
    want = ks_inner.ks_inner_plain(t[0], t[1], t[2], rows, t[3], t[4])
    torch.cuda.synchronize()
    assert ks_inner.launches == before + 1
    assert torch.equal(got, want)


def _ntt_rows_case(rows_obj, shape, q, rng, spread=False, view=None):
    """Kernel vs plain version, forward and inverse, on one input in every
    variant of the contract (int32/int64 in and out, the Montgomery factors
    folded in or not; int64 in only for inputs outside [0, q)); view(x)
    takes a strided view of the input.  Returns the int64 input and its
    forward transform."""
    x = rng.integers(0, 1 << 62, shape) % q.reshape(-1, 1)
    if spread:                   # outside [0, q): the kernels reduce on load
        x = rng.integers(-(1 << 31), 1 << 31, shape)
    xd = torch.as_tensor(x, device="cuda")
    view = view or (lambda a: a)
    for ind in (torch.int64,) if spread else (torch.int32, torch.int64):
        xi = view(xd.to(ind))
        for outd in (torch.int32, torch.int64):
            for mont in (False, True):
                f0, i0 = ntt.launches_fwd, ntt.launches_inv
                t0 = ntt.launches_two_pass
                c0 = ntt.launches_cluster16
                got = ntt.ntt_fwd(xi, rows_obj, mont, outd)
                inv = ntt.ntt_inv(xi, rows_obj, mont, outd)
                torch.cuda.synchronize()
                k = ntt.launches_per_transform(xi.shape[-1])
                assert (ntt.launches_fwd, ntt.launches_inv) == (f0 + k,
                                                                i0 + k)
                assert ntt.launches_two_pass - t0 == (2 * k if k == 2
                                                      else 0)
                c16 = xi.shape[-1] == 1 << ntt.CLUSTER16_LOGN
                assert ntt.launches_cluster16 - c0 == (2 if c16 else 0)
                assert got.dtype == inv.dtype == outd
                xc = xi.cpu()
                assert torch.equal(got.cpu(), ntt.ntt_fwd_plain(
                    xc, rows_obj.w().cpu(), rows_obj.q.cpu(),
                    rows_obj.r.cpu() if mont else None, outd))
                assert torch.equal(inv.cpu(), ntt.ntt_inv_plain(
                    xc, rows_obj.wi().cpu(), rows_obj.q.cpu(),
                    rows_obj.ninv.cpu(),
                    rows_obj.rinv.cpu() if mont else None, outd))
    xi = view(xd)
    return xi, ntt.ntt_fwd(xi, rows_obj)


def _ring_rows(logn, count=3):
    """A DeviceNTT of `count` primes of the ring 2^logn on the card, rows
    in another order than the tables'."""
    n = 1 << logn
    primes = tuple(rns.find_ntt_primes(30, 2 * n, count))
    t = ntt.NTTTables(n, primes)
    d = ntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, "cuda")
    sel = list(range(count))[::-1]
    return d.rows(sel), np.asarray(primes, dtype=np.int64)[sel]


def test_ntt_kernel_equals_plain():
    """ntt_fwd/ntt_inv kernels torch.equal to their plain versions in every
    variant of the contract: at prod_boot (N=2^16, the cluster path) a
    key-switch decomposition's J digits over a non-contiguous q|specials
    row set, a rescale's two components over 55 rows and through a
    strided view, one row, inputs outside [0, q); a 2^17 row (cluster);
    the one-block path at 2^13, 2^14, 2^15 and the DistNTT's size-256
    transforms over [R, L, 256]; the round trips, plain and fused; and a
    fused forward captured in a CUDA graph, replayed on new input, equal to
    eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aesfhe_tpu_torch.parallel.dist_ntt import local_tables
    p = get_params("prod_boot")
    tabs = ops_impl.DeviceTables(p, "cuda")
    rng = np.random.default_rng(16)
    qa = np.asarray(p.all_primes, dtype=np.int64)
    level = 29
    rows = ops_impl._rows(p, level, True)
    J = len(p.ks_tables(level)["groups"])
    _ntt_rows_case(tabs.ntt.rows(rows), (J, len(rows), p.n), qa[rows], rng)
    r55 = tabs.ntt.rows(range(55))
    xd, fwd = _ntt_rows_case(r55, (2, 55, p.n), qa[:55], rng)
    assert torch.equal(ntt.ntt_inv(fwd, r55), xd)
    x32 = xd.int()
    back = ntt.ntt_inv(ntt.ntt_fwd(x32, r55, True, torch.int32), r55, True,
                       torch.int32)
    assert torch.equal(back, x32)
    _ntt_rows_case(tabs.ntt.rows([54]), (2, 1, p.n), qa[54:55], rng,
                   spread=True)
    # a strided view: limbs 53, 54 of a [2, 55, N] tensor
    _ntt_rows_case(tabs.ntt.rows([53, 54]), (2, 55, p.n), qa[:55], rng,
                   view=lambda a: a[:, -2:])
    for logn, shape in ((17, (2, 3)), (15, (2, 3)), (14, (3, 3)),
                        (13, (5, 3))):
        tr, q = _ring_rows(logn)
        x, f = _ntt_rows_case(tr, shape + (1 << logn,), q, rng)
        assert torch.equal(ntt.ntt_inv(f, tr), x)
    A, L = 256, 55
    w, wi, ninv = local_tables(p, A, L)
    small = ntt.DeviceNTT(w, wi, ninv, p.q_primes[:L], "cuda").rows(range(L))
    xd, fwd = _ntt_rows_case(small, (A // 2, L, A), qa[:L], rng)
    assert torch.equal(ntt.ntt_inv(fwd, small), xd)
    # a graph capture of the fused forward, replayed on a new input
    src = x32.clone()
    want = ntt.ntt_fwd(x32.flip(0), r55, True, torch.int32)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ntt.ntt_fwd(src, r55, True, torch.int32)
    src.copy_(x32.flip(0))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("logn,shape", [(18, (2, 3)), (19, (2, 2)),
                                        (20, (1, 2)), (21, (1, 2)),
                                        (25, (1, 1))])
def test_two_pass_ntt_kernel_equals_plain(logn, shape):
    """The rings above 2^17: 2^18 on a cluster of 16 blocks (one launch a
    transform) and the two-pass path (N >= 2^19, two launches a transform)
    torch.equal to the plain versions in every variant of the contract
    (int32/int64 in and out, the Montgomery factors folded in or not; int64
    inputs outside [0, q)), rows in another order than the tables'; at
    2^18 also through a strided view; the round trips, plain and fused; and
    a fused forward to int32 and an inverse to int64 (on the two-pass path
    each with an int32 scratch of its own between its launches) captured in
    one CUDA graph, replayed on a new input, equal to eager.  2^25 is the
    kernels' largest ring (ntt.MAX_LOGN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert ntt.MAX_LOGN == 25
    rng = np.random.default_rng(logn)
    tr, q = _ring_rows(logn, shape[1])
    x, f = _ntt_rows_case(tr, shape + (1 << logn,), q, rng)
    assert torch.equal(ntt.ntt_inv(f, tr), x)
    _ntt_rows_case(tr, shape + (1 << logn,), q, rng, spread=True)
    if logn == 18:
        _ntt_rows_case(tr.tabs.rows([0, 1]), (2, 3, 1 << logn), q[::-1], rng,
                       view=lambda a: a[:, :2])
    x32 = x.int()
    back = ntt.ntt_inv(ntt.ntt_fwd(x32, tr, True, torch.int32), tr, True,
                       torch.int32)
    assert torch.equal(back, x32)
    src = x32.clone()
    want = ntt.ntt_fwd(x32.flip(0), tr, True, torch.int32)
    want64 = ntt.ntt_inv(x32.flip(0), tr, True, torch.int64)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ntt.ntt_fwd(src, tr, True, torch.int32)
        out64 = ntt.ntt_inv(src, tr, True, torch.int64)
    src.copy_(x32.flip(0))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(out64, want64)


def test_ntt_limit_and_occupancy():
    """A ring above 2^MAX_LOGN raises before any launch, with the limit in
    the message; ntt.occupancy reports both passes of the two-pass path
    (the split a + b = logN, each pass resident), 2^18 as one launch on
    clusters of 16 blocks (the card holds some at once), one launch below,
    and raises above the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 1 << (ntt.MAX_LOGN + 1)
    zero = np.zeros((1, n), dtype=np.uint32)
    d = ntt.DeviceNTT(zero, zero, [1], [2013265921], "cuda").rows([0])
    x = torch.zeros((1, n), dtype=torch.int64, device="cuda")
    f0 = ntt.launches_fwd
    with pytest.raises(ValueError, match=f"above the kernels' largest ring "
                                         f"2\\^{ntt.MAX_LOGN}"):
        ntt.ntt_fwd(x, d)
    assert ntt.launches_fwd == f0
    del d, x
    torch.cuda.empty_cache()
    for logn, split in ((19, (9, 10)), (20, (10, 10)), (25, (10, 15))):
        occ = ntt.occupancy(logn)
        assert occ["split"] == split and sum(split) == logn
        assert occ["blocks_per_sm"] >= 1 and occ["runs"]["blocks_per_sm"] >= 1
        assert occ["smem_bytes"] <= 232448 >= occ["runs"]["smem_bytes"]
    occ = ntt.occupancy(ntt.CLUSTER16_LOGN)
    assert "runs" not in occ and occ["clusters"] > 0
    assert occ["blocks_per_sm"] >= 1 and occ["smem_bytes"] <= 232448
    assert ntt.launches_per_transform(1 << 18) == 1
    assert ntt.launches_per_transform(1 << 19) == 2
    assert "runs" not in ntt.occupancy(17)
    with pytest.raises(RuntimeError, match="ntt_occupancy"):
        ntt.occupancy(ntt.MAX_LOGN + 1)


def test_bitplane_leg_at_2_18_exact():
    """bench's bitplane leg at AESFHE_BENCH_LOGN=18 on the card (8192
    blocks, one full middle round): every byte equals the AES oracle, one
    ks_inner launch per key-switch, the 16-block NTT launched and the
    two-pass one not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aesfhe_tpu_torch import bench, kernels
    leg = bench.SETUPS["bitplane"](18, 16, "cuda")
    eng = leg.wrap.engine
    eng.reset_counters()
    kernels.zero_launches()
    _, _, out, leg = bench.run_leg("bitplane", 18, 16, 1, "cuda", leg=leg)
    assert leg.blocks == 8192
    assert bench.check_leg(leg, out) == 0
    assert ks_inner.launches == eng.counters["keyswitch"] > 0
    counts = kernels.variant_counts()
    assert counts["ntt_cluster16"] > 0 and counts["ntt_two_pass"] == 0


def _boot_chain():
    """tests/test_bootstrap.py's boot chain (n=2^9, 34 levels) on the card:
    the engine, its bootstrap keys and three packed level-0 inputs."""
    params = CKKSParams(n=1 << 9, max_level=34, scale_bits=27,
                        first_prime_bits=30, num_special_primes=4,
                        secret_hamming=16)
    ctx = EngineContext(params=params, device="cuda", rotation_steps=(),
                        use_bootstrap=True, rng=np.random.default_rng(3))
    eng = ctx.engine
    keys = (ctx.relinearization_key, ctx.conjugation_key, ctx.bootstrap_key)
    rng = np.random.default_rng(9)
    ins = []
    for _ in range(3):
        p0, p1 = (1.0 - 2.0 * rng.integers(0, 2, eng.slot_count)
                  for _ in range(2))
        ins.append(eng.add(eng._drop(eng.encrypt(p0, ctx.public_key), 0),
                           eng.multiply_i(eng._drop(
                               eng.encrypt(p1, ctx.public_key), 0))))
    return eng, keys, ins


def test_fused_bootstrap_graph_equals_eager():
    """On the boot chain the captured
    graph's warm-up and two back-to-back replays on other inputs equal the
    eager bootstrap bit for bit, each replay with its own output; every
    replay counts the capture's key-switches and kernel launches (the NTT
    kernels' too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng, keys, ins = _boot_chain()
    fb = FusedBootstrap(eng, *keys, ins[0])
    assert fb.graph is not None and fb.pool_bytes > 0
    assert fb.deltas["ks_inner_launches"] == fb.deltas["keyswitch"] > 0
    assert fb.deltas["ntt_fwd_launches"] > 0
    assert fb.deltas["ntt_inv_launches"] > 0
    assert torch.equal(fb.warm_out.data, eng.bootstrap(ins[0], *keys).data)
    before = ks_inner.launches
    nb = ntt.launches_fwd + ntt.launches_inv
    outs = [fb(ins[1]), fb(ins[2])]
    torch.cuda.synchronize()
    assert ks_inner.launches - before == 2 * fb.deltas["ks_inner_launches"]
    assert ntt.launches_fwd + ntt.launches_inv - nb == 2 * (
        fb.deltas["ntt_fwd_launches"] + fb.deltas["ntt_inv_launches"])
    for ct, out in zip(ins[1:], outs):
        want = eng.bootstrap(ct, *keys)
        assert torch.equal(out.data, want.data)
        assert out.scale == want.scale == fb.out_scale
    assert not torch.equal(outs[0].data, outs[1].data)


def test_profiled_replay_times_its_phases():
    """A replay under the profiler adds the three `boot.*_ns` counters from
    the graph's own event nodes, their sum within 10% of the replay's time
    between CUDA events around the call; a replay without the profiler
    adds none, and the capture left them out of the replay's deltas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng, keys, ins = _boot_chain()
    fb = FusedBootstrap(eng, *keys, ins[0])
    names = [f"boot.{p}_ns" for p in ("cts", "evalmod", "stc")]
    assert not set(names) & set(fb.deltas)
    before = [eng.counters[k] for k in names]
    fb(ins[1])
    torch.cuda.synchronize()
    assert [eng.counters[k] for k in names] == before
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        e0.record()
        out = fb(ins[1])
        e1.record()
        torch.cuda.synchronize()
    got = [eng.counters[k] - b for k, b in zip(names, before)]
    replay_ns = e0.elapsed_time(e1) * 1e6
    assert all(v > 0 for v in got)
    assert abs(sum(got) - replay_ns) <= 0.1 * replay_ns, (got, replay_ns)
    assert torch.equal(out.data, eng.bootstrap(ins[1], *keys).data)


@pytest.mark.parametrize("d", [2, 4])
def test_ks_inner_kernel_on_mesh_shards(d):
    """The kernel at a mesh rank's shape: J = pad/D digits of prod_boot's
    top level (J = 4 at D = 2, J = 2 at D = 4, M = 63), for every rank, the
    last rank's padded digits (and the key rows behind them) zero; and a
    rank whose whole shard is padding (level 15) returns zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aesfhe_tpu_torch.core import ops_impl
    from aesfhe_tpu_torch.parallel.mesh import digit_pad
    p = get_params("prod_boot")
    dev = torch.device("cuda")
    J = digit_pad(p.dnum, d) // d
    rng = np.random.default_rng(d)
    for level in (p.top_level, 15):
        live = len(p.ks_tables(level)["groups"])
        rows = ops_impl._key_rows(p, level, None)
        qs = np.asarray(p.all_primes, dtype=np.int64)[rows]
        qk = np.asarray(p.all_primes, dtype=np.int64)
        qinv = [rns.montgomery_consts(int(q))[0] for q in qs]
        for rank in range(d):
            dig = rng.integers(0, 1 << 62, (J, len(rows), p.n)) % qs[:, None]
            kb, ka = (rng.integers(0, 1 << 62, (J, p.L_tot, p.n))
                      % qk[:, None] for _ in range(2))
            zero = [j for j in range(J) if rank * J + j >= live]
            for a in (dig, kb, ka):
                a[zero] = 0
            t = [interop.to_tensor(np.asarray(a, dtype=np.uint32), dev)
                 for a in (dig, kb, ka, qs, qinv)]
            got = ks_inner.ks_inner(t[0], t[1], t[2], rows, t[3], t[4])
            want = ks_inner.ks_inner_plain(t[0], t[1], t[2], rows, t[3],
                                           t[4])
            torch.cuda.synchronize()
            assert torch.equal(got, want), (level, rank)
            if len(zero) == J:
                assert not got.any()


def test_dryrun_multichip_on_the_card():
    """graft_entry.dryrun_multichip(2) on the card: two ranks (sharing one
    card over gloo, or one card each over NCCL) run the batched step equal
    to one device, and the distributed NTT is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aesfhe_tpu_torch.graft_entry import dryrun_multichip
    out = dryrun_multichip(2)
    assert out["ntt_exact"] is True and out["keyswitches"] > 0


def _residues(p, rows, lead, rng, dev="cuda"):
    qs = np.asarray(p.all_primes, dtype=np.int64)[np.asarray(rows)]
    x = rng.integers(0, 1 << 62, tuple(lead) + (len(rows), p.n))
    return torch.as_tensor(x % qs[:, None], device=dev).int()


@pytest.mark.parametrize("level", [54, 28])
def test_ks_legs_kernels_equal_plain(level):
    """ks_modup (every digit, a mesh rank's range with a padded digit, a
    range of padding only; byte-extreme inputs), ks_moddown (random special
    rows, rows whose float32 v_hat sums sit at half-integers, byte-extreme
    rows) and sub_scale (x a strided view of the mod-down's wider input)
    equal their plain versions at prod_boot's shapes.  Byte-extreme: every
    y = c * inv_w mod q the largest residue with three 0xFF bytes, and a
    per-word mix of that, q - 1 and 0 (`ks_legs.byte_extremes`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = get_params("prod_boot")
    rng = np.random.default_rng(level)
    up = ks_legs.ModupTables(p, level, "cuda")
    c = _residues(p, range(level + 1), (), rng)
    for j0, j1 in ((0, up.J), (up.J - 1, up.J + 1), (up.J + 1, up.J + 3)):
        before = ks_legs.launches_modup
        got = ks_legs.ks_modup(c, up, j0, j1)
        assert ks_legs.launches_modup == before + 1
        assert torch.equal(got, ks_legs.ks_modup_plain(c, up, j0, j1))
    inv = [0] * (level + 1)
    for g in p.ks_tables(level)["groups"]:
        for i, w in zip(g["limbs"], g["inv_w"]):
            inv[i] = w
    picks = (np.full((level + 1, p.n), 2),
             rng.integers(0, 3, (level + 1, p.n)))
    for pick in picks:
        ce = torch.as_tensor(ks_legs.byte_extremes(p.q_primes[:level + 1],
                                                   inv, pick),
                             device="cuda").int()
        assert torch.equal(ks_legs.ks_modup(ce, up, 0, up.J),
                           ks_legs.ks_modup_plain(ce, up, 0, up.J))
    down = ks_legs.ModdownTables(p, level, "cuda")
    K, ps = p.num_special, np.asarray(p.special_primes, dtype=np.int64)
    y = rng.integers(0, 1 << 62, (2, K, p.n)) % ps[:, None]
    rest = (y[:, 1:] / ps[1:, None]).sum(1)
    y0 = np.round((np.ceil(rest - 0.5) + 0.5 - rest) * ps[0]).astype(np.int64)
    y[:, 0] = np.clip(y0 + rng.integers(-40, 41, (2, p.n)), 0, ps[0] - 1)
    w = [pow(int(a), -1, int(q)) for a, q in
         zip(p.md_tables(level)["inv_w"], ps)]
    half = torch.as_tensor((y * np.asarray(w)[:, None]) % ps[:, None],
                           device="cuda").int()
    extreme = torch.as_tensor(np.stack([ks_legs.byte_extremes(
        ps, p.md_tables(level)["inv_w"], pick[:K]) for pick in picks]),
        device="cuda").int()
    for d in (_residues(p, range(p.num_q, p.L_tot), (2,), rng), half,
              extreme):
        assert torch.equal(ks_legs.ks_moddown(d, down),
                           ks_legs.ks_moddown_plain(d, down))
    x = _residues(p, ops_impl._rows(p, level, True), (2,), rng)[:, :level + 1]
    yq = _residues(p, range(level + 1), (2,), rng)
    assert not x.is_contiguous()
    assert torch.equal(ks_legs.sub_scale(x, yq, down.pinv),
                       ks_legs.sub_scale_plain(x, yq, down.pinv))
    torch.cuda.synchronize()


# parameter sets past one k-step of the conversion kernels (digits or
# special sets of more than 8 primes: chunked conversions; k20 three chunks
# each way) and a chain of primes below 2^16 (30, 15, 14, 16, 16 bits), on
# N=2^10 tables
WIDE = {"k9": dict(num_special_primes=9), "k10": dict(num_special_primes=10),
        "k16": dict(num_special_primes=16),
        "alpha9": dict(num_special_primes=10, alpha=9),
        "alpha16": dict(max_level=20, num_special_primes=16, alpha=16),
        "k20": dict(max_level=20, num_special_primes=20)}
WIDE = {k: dict(dict(n=1 << 10, max_level=12, scale_bits=26), **v)
        for k, v in WIDE.items()}
WIDE["scale14"] = dict(n=1 << 10, max_level=4, scale_bits=14)


def _boom(*args, **kwargs):
    raise AssertionError("a plain version ran on the card")


@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_and_small_prime_legs_equal_plain(name, monkeypatch):
    """The chunked conversions (ceil(width / 8) chunks a launch) and the
    conversions over primes below 2^16 equal their plain versions at
    N = 2^12, at the top and a middle level: ks_modup on every digit, a
    mesh range with a padded digit, byte-extreme inputs; ks_moddown on
    random, half-integer and byte-extreme rows.  Each call is one launch,
    and none reaches a plain version or vhat_frac's CPU loop (they raise
    here).  Then a whole key-switch (NTT, ks_modup, ks_inner, ks_moddown,
    sub_scale on the card) equals the CPU's at N = 2^10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aesfhe_tpu_torch.core.engine import Engine
    p = CKKSParams(**WIDE[name])
    n = 1 << 12
    rng = np.random.default_rng(len(name))

    def res(primes, lead):
        q = np.asarray([int(v) for v in primes], dtype=np.int64)[:, None]
        x = rng.integers(0, 1 << 62, tuple(lead) + (len(q), n)) % q
        return torch.as_tensor(x, device="cuda").int()

    calls = []
    for level in (p.top_level, p.top_level // 2):
        up = ks_legs.ModupTables(p, level, "cuda")
        qs = p.q_primes[:level + 1]
        inv = [0] * (level + 1)
        for g in p.ks_tables(level)["groups"]:
            for i, w in zip(g["limbs"], g["inv_w"]):
                inv[i] = w
        cs = [res(qs, ())] + [torch.as_tensor(ks_legs.byte_extremes(
            qs, inv, pick), device="cuda").int() for pick in (
                np.full((level + 1, n), 2), rng.integers(0, 3, (level + 1, n)))]
        for c in cs:
            for j0, j1 in ((0, up.J), (up.J - 1, up.J + 1)):
                calls.append(("up", (c, up, j0, j1),
                              ks_legs.ks_modup_plain(c, up, j0, j1)))
        down = ks_legs.ModdownTables(p, level, "cuda")
        K, ps = p.num_special, np.asarray(p.special_primes, dtype=np.int64)
        y = rng.integers(0, 1 << 62, (2, K, n)) % ps[:, None]
        rest = (y[:, 1:] / ps[1:, None]).sum(1)
        y0 = np.round((np.ceil(rest - 0.5) + 0.5 - rest) * ps[0])
        y[:, 0] = np.clip(y0.astype(np.int64) + rng.integers(-40, 41, (2, n)),
                          0, ps[0] - 1)
        w = [pow(int(a), -1, int(q)) for a, q in
             zip(p.md_tables(level)["inv_w"], ps)]
        half = torch.as_tensor((y * np.asarray(w)[:, None]) % ps[:, None],
                               device="cuda").int()
        extreme = torch.as_tensor(np.stack([ks_legs.byte_extremes(
            ps, p.md_tables(level)["inv_w"], pick) for pick in (
                np.full((K, n), 2), rng.integers(0, 3, (K, n)))]),
            device="cuda").int()
        for d in (res(ps, (2,)), half, extreme):
            calls.append(("down", (d, down),
                          ks_legs.ks_moddown_plain(d, down)))
    level = p.top_level
    kb, ka = (torch.as_tensor(np.asarray(rng.integers(0, 1 << 62, (
        p.dnum, p.L_tot, p.n)) % np.asarray(p.all_primes)[:, None]),
        dtype=torch.int64).int() for _ in range(2))
    c = torch.as_tensor(rng.integers(0, 1 << 62, (level + 1, p.n)) %
                        np.asarray(p.q_primes[:level + 1])[:, None]).int()
    want_ks = ops_impl.keyswitch(p, Engine(p, device="cpu").tabs, c, kb, ka)
    tabs = Engine(p, device="cuda").tabs
    for fn in ("ks_modup_plain", "ks_moddown_plain", "vhat_frac"):
        monkeypatch.setattr(ks_legs, fn, _boom)
    for kind, args, want in calls:
        counter = "launches_modup" if kind == "up" else "launches_moddown"
        before = getattr(ks_legs, counter)
        got = (ks_legs.ks_modup if kind == "up" else ks_legs.ks_moddown)(
            *args)
        assert getattr(ks_legs, counter) == before + 1
        assert torch.equal(got, want)
    before = (ks_legs.launches_modup, ks_legs.launches_moddown)
    got_ks = ops_impl.keyswitch(p, tabs, c.cuda(), kb.cuda(), ka.cuda())
    assert (ks_legs.launches_modup, ks_legs.launches_moddown) == \
        (before[0] + 1, before[1] + 1)
    for g, w_ in zip(got_ks, want_ks):
        assert torch.equal(g.cpu(), w_)


@pytest.mark.parametrize("name,group", [("k20", 1), ("k20", 2),
                                        ("k72", None)])
def test_chunked_fold_groups_equal_plain(name, group):
    """The chunked instance compiled for any chunk count (fragments read
    a tile, a run-time chunk loop): three chunks folded every chunk or
    every two (the tables' fold group overridden: folding more often is
    exact wherever one fold is), and 72 special primes (nine chunks, one
    digit of 5 limbs) at the group its tables give; ks_modup on every
    digit and byte-extreme inputs, ks_moddown on random and byte-extreme
    rows, equal to the plain versions at N = 2^12, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kw = WIDE[name] if name in WIDE else dict(
        n=1 << 10, max_level=4, scale_bits=26, num_special_primes=72)
    p = CKKSParams(**kw)
    n, level = 1 << 12, p.top_level
    rng = np.random.default_rng(3)
    up = ks_legs.ModupTables(p, level, "cuda")
    down = ks_legs.ModdownTables(p, level, "cuda")
    if group is not None:
        up.group = down.group = group
    qs, ps = p.q_primes[:level + 1], p.special_primes
    inv = [0] * (level + 1)
    for g in p.ks_tables(level)["groups"]:
        for i, w in zip(g["limbs"], g["inv_w"]):
            inv[i] = w
    cs = [torch.as_tensor(rng.integers(0, 1 << 62, (level + 1, n)) %
                          np.asarray(qs)[:, None], device="cuda").int(),
          torch.as_tensor(ks_legs.byte_extremes(
              qs, inv, np.full((level + 1, n), 2)), device="cuda").int()]
    ds = [torch.as_tensor(rng.integers(0, 1 << 62, (2, len(ps), n)) %
                          np.asarray(ps)[:, None], device="cuda").int(),
          torch.as_tensor(np.stack([ks_legs.byte_extremes(
              ps, p.md_tables(level)["inv_w"], np.full((len(ps), n), 2))]
              * 2),
              device="cuda").int()]
    if name == "k20":
        assert up.nch == down.nch == 3
    else:
        assert down.nch == 9 and down.group == 9 and up.nch == 1
    for c in cs:
        before = ks_legs.launches_modup_chunks
        assert torch.equal(ks_legs.ks_modup(c, up, 0, up.J),
                           ks_legs.ks_modup_plain(c, up, 0, up.J))
        assert ks_legs.launches_modup_chunks == before + (up.nch > 1)
    for d in ds:
        before = ks_legs.launches_moddown_chunks
        assert torch.equal(ks_legs.ks_moddown(d, down),
                           ks_legs.ks_moddown_plain(d, down))
        assert ks_legs.launches_moddown_chunks == before + 1
    torch.cuda.synchronize()


def test_keyswitch_graph_replay_equals_eager():
    """One key-switch at prod_boot's top level (INTT, ks_modup, NTT,
    ks_inner, INTT, ks_moddown, NTT, sub_scale) captured in a CUDA graph
    after an eager warm-up: a replay on another input equals the eager
    key-switch of that input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aesfhe_tpu_torch.core.engine import Engine
    p = get_params("prod_boot")
    tabs = Engine(p, device="cuda").tabs
    level = p.top_level
    rng = np.random.default_rng(5)
    kb, ka = (_residues(p, range(p.L_tot), (p.dnum,), rng) for _ in range(2))
    c0, c1 = (_residues(p, range(level + 1), (), rng) for _ in range(2))
    ops_impl.keyswitch(p, tabs, c0, kb, ka)             # warm-up
    torch.cuda.synchronize()
    static = c0.clone()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        b, a = ops_impl.keyswitch(p, tabs, static, kb, ka)
    static.copy_(c1)
    g.replay()
    want_b, want_a = ops_impl.keyswitch(p, tabs, c1, kb, ka)
    torch.cuda.synchronize()
    assert torch.equal(b, want_b) and torch.equal(a, want_a)


def _lut_operands(primes, K, D, n, rng, dev="cuda"):
    """(stack [K, D, L, n], consts [K, L, 4], neg [n], pts [K, L, n]) under
    `primes`, a quarter of the residues 0 or q-1, every third term's
    weights q-1 (re and imz) or (0, q-1)."""
    q = np.asarray(primes, dtype=np.int64)
    L = len(q)

    def res(lead):
        x = rng.integers(0, 1 << 62, (*lead, L, n)) % q[:, None]
        pick = rng.integers(0, 8, x.shape)
        return np.where(pick == 0, 0, np.where(pick == 1, q[:, None] - 1, x))

    re, im = (rng.integers(0, 1 << 62, (K, L)) % q for _ in range(2))
    re[1::3], im[1::3] = q - 1, q - 1
    re[2::3], im[2::3] = 0, q - 1
    sh = [[[rns.shoup_precompute(int(w), int(qq)) for w, qq in zip(row, q)]
           for row in a] for a in (re, im)]
    consts = np.stack([re, sh[0], im, sh[1]], axis=-1)
    t = [rns.narrow(torch.as_tensor(np.asarray(a, dtype=np.int64),
                                    device=dev))
         for a in (res((K, D)), consts, res((K,)))]
    neg = torch.as_tensor(rng.integers(0, 2, n).astype(bool), device=dev)
    return t[0], t[1], neg, t[2]


def _lut_plain(stack, consts, neg, pts, tr):
    return (lut_sum.lut_sum_plain(stack, consts, neg, tr.q),
            lut_sum.lut_sum_dense_plain(stack, pts, tr.q, tr.rinv))


@pytest.mark.parametrize("primes,L,n", [
    ("prod_boot", 1, 1 << 16), ("prod_boot", 42, 1 << 16),
    ("prod_boot", 55, 1 << 16), ("scale 2^14", 5, 1 << 16),
    ("scale 2^14", 5, 1 << 9)])
def test_lut_sum_kernels_equal_plain(primes, L, n):
    """Both LUT-sum kernels torch.equal to their plain versions for K in
    {1, 2, 7, 16, 33} and deg+1 in {2, 3}: prod_boot's first L q-primes at
    N = 2^16, the primes below 2^16 of the scale-2^14 chain at 2^16 and on
    a ring of 2^9 (part of one block); one launch a call; then one
    captured graph of both, replayed on other inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = get_params("prod_boot") if primes == "prod_boot" else \
        CKKSParams(n=1 << 10, max_level=4, scale_bits=14)
    tr = ops_impl.DeviceTables(p, "cuda").rows(range(L))
    qs = [int(q) for q in p.all_primes[:L]]
    rng = np.random.default_rng(L + n)
    for K in (1, 2, 7, 16, 33):
        for D in (2, 3):
            stack, consts, neg, pts = _lut_operands(qs, K, D, n, rng)
            s0, d0 = lut_sum.launches_scalar, lut_sum.launches_dense
            got = (lut_sum.lut_sum(stack, consts, neg, tr),
                   lut_sum.lut_sum_dense(stack, pts, tr))
            want = _lut_plain(stack, consts, neg, pts, tr)
            torch.cuda.synchronize()
            assert (lut_sum.launches_scalar, lut_sum.launches_dense) == (
                s0 + 1, d0 + 1)
            assert torch.equal(got[0], want[0]), (K, D)
            assert torch.equal(got[1], want[1]), (K, D)
    # a graph of both sums on static inputs, replayed on the next ones
    ins = _lut_operands(qs, 7, 2, n, rng)
    static = [t.clone() for t in ins]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = (lut_sum.lut_sum(*static[:3], tr),
                lut_sum.lut_sum_dense(static[0], static[3], tr))
    for _ in range(2):
        ins = _lut_operands(qs, 7, 2, n, rng)
        for s, t in zip(static, ins):
            s.copy_(t)
        g.replay()
        want = _lut_plain(*ins, tr)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], want[0]) and torch.equal(outs[1], want[1])


def test_linear_combination_launches_one_lut_sum():
    """On the card an Engine.linear_combination with scalar coefficients
    launches the scalar LUT-sum kernel once and the dense one never; with
    per-slot coefficients each once; fused_pt_sum the dense one once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aesfhe_tpu_torch import kernels
    from aesfhe_tpu_torch.core.engine import Engine
    eng = Engine(get_params("tiny"), device="cuda",
                 rng=np.random.default_rng(4))
    sk = eng.create_secret_key()
    pk = eng.create_public_key(sk)
    rng = np.random.default_rng(6)
    x = [rng.uniform(-1, 1, eng.slot_count) for _ in range(3)]
    cts = [eng.encrypt(v, pk) for v in x]
    dense = rng.uniform(-1, 1, eng.slot_count)

    def launches(run):
        before = kernels.launch_counts()
        out = run()
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        return out, (after["lut_sum"] - before["lut_sum"],
                     after["lut_sum_dense"] - before["lut_sum_dense"])

    out, n = launches(lambda: eng.linear_combination(cts, [0.5, -0.25j, 1]))
    assert n == (1, 0)
    assert np.abs(eng.decrypt(out, sk)
                  - (0.5 * x[0] - 0.25j * x[1] + x[2])).max() < 1e-2
    out, n = launches(lambda: eng.linear_combination(cts, [dense, 0.5, 2]))
    assert n == (1, 1)
    assert np.abs(eng.decrypt(out, sk)
                  - (dense * x[0] + 0.5 * x[1] + 2 * x[2])).max() < 1e-2
    pt = eng.encode(dense, level=cts[0].level)
    out, n = launches(lambda: eng.fused_pt_sum([(cts[0], pt), (cts[1], pt)]))
    assert n == (0, 1)
    assert np.abs(eng.decrypt(out, sk)
                  - dense * (x[0] + x[1])).max() < 1e-2
