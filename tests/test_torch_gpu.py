"""Card-only checks of the port's CUDA kernels against their plain versions,
of the fused bootstrap's CUDA graph against the eager bootstrap, and of a
captured key-switch against the eager one.

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
from aesfhe_tpu_torch.core import ks_inner, ks_legs, ntt, ops_impl, rns
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
                got = ntt.ntt_fwd(xi, rows_obj, mont, outd)
                inv = ntt.ntt_inv(xi, rows_obj, mont, outd)
                torch.cuda.synchronize()
                assert (ntt.launches_fwd, ntt.launches_inv) == (f0 + 1,
                                                                i0 + 1)
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


def test_fused_bootstrap_graph_equals_eager():
    """tests/test_bootstrap.py's boot chain (n=2^9, 34 levels): the captured
    graph's warm-up and two back-to-back replays on other inputs equal the
    eager bootstrap bit for bit, each replay with its own output; every
    replay counts the capture's key-switches and kernel launches (the NTT
    kernels' too)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
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
