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
from aesfhe_tpu_torch.core import ks_inner, rns
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


def test_fused_bootstrap_graph_equals_eager():
    """tests/test_bootstrap.py's boot chain (n=2^9, 34 levels): the captured
    graph's warm-up and two back-to-back replays on other inputs equal the
    eager bootstrap bit for bit, each replay with its own output; every
    replay counts the capture's key-switches and kernel launches."""
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
    assert torch.equal(fb.warm_out.data, eng.bootstrap(ins[0], *keys).data)
    before = ks_inner.launches
    outs = [fb(ins[1]), fb(ins[2])]
    torch.cuda.synchronize()
    assert ks_inner.launches - before == 2 * fb.deltas["ks_inner_launches"]
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
