"""Card-only checks of the port's CUDA kernels against their plain versions,
and of the fused bootstrap's CUDA graph against the eager bootstrap.

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
from aesfhe_tpu_torch.core import ks_inner, ntt, ops_impl, rns
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


def _ntt_rows_case(rows_obj, shape, q, rng, spread=False):
    """Kernel vs plain version, forward and inverse, on one input; returns
    the forward output."""
    x = rng.integers(0, 1 << 62, shape) % q.reshape(-1, 1)
    if spread:                   # outside [0, q): the kernels reduce on load
        x = rng.integers(-(1 << 31), 1 << 31, shape)
    xd = torch.as_tensor(x, device="cuda")
    f0, i0 = ntt.launches_fwd, ntt.launches_inv
    got = ntt.ntt_fwd(xd, rows_obj)
    inv = ntt.ntt_inv(xd, rows_obj)
    torch.cuda.synchronize()
    assert (ntt.launches_fwd, ntt.launches_inv) == (f0 + 1, i0 + 1)
    xc = torch.as_tensor(x)
    assert torch.equal(got.cpu(), ntt.ntt_fwd_plain(
        xc, rows_obj.w().cpu(), rows_obj.q.cpu()))
    assert torch.equal(inv.cpu(), ntt.ntt_inv_plain(
        xc, rows_obj.wi().cpu(), rows_obj.q.cpu(), rows_obj.ninv.cpu()))
    return xd, got


def test_ntt_kernel_equals_plain():
    """ntt_fwd/ntt_inv kernels torch.equal to their plain versions at
    prod_boot (N=2^16): a key-switch decomposition's J digits over a
    non-contiguous q|specials row set, a rescale's two components over 55
    rows through a strided view, one row, inputs outside [0, q); the
    DistNTT's size-256 transforms over [R, L, 256]; and the round trip
    ntt_inv(ntt_fwd(x)) = x."""
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
    xd, fwd = _ntt_rows_case(tabs.ntt.rows(range(55)), (2, 55, p.n),
                             qa[:55], rng)
    assert torch.equal(ntt.ntt_inv(fwd, tabs.ntt.rows(range(55))), xd)
    _ntt_rows_case(tabs.ntt.rows([54]), (2, 1, p.n), qa[54:55], rng,
                   spread=True)
    # a strided view: limbs 1..54 of a [2, 55, N] tensor
    sub = tabs.ntt.rows(range(1, 55))
    got = ntt.ntt_fwd(xd[:, 1:], sub)
    assert torch.equal(got.cpu(), ntt.ntt_fwd_plain(
        xd[:, 1:].cpu(), sub.w().cpu(), sub.q.cpu()))
    A, L = 256, 55
    w, wi, ninv = local_tables(p, A, L)
    small = ntt.DeviceNTT(w, wi, ninv, p.q_primes[:L], "cuda").rows(range(L))
    xd, fwd = _ntt_rows_case(small, (A // 2, L, A), qa[:L], rng)
    assert torch.equal(ntt.ntt_inv(fwd, small), xd)


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
