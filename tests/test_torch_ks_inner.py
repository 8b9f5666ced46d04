"""The key-switch inner product of the port (core/ks_inner.py) against the
reference's TPU kernel (core/pallas_ks.py, run in Pallas interpret mode as
tests/test_native.py does) and its XLA twin, bit for bit.  On the CPU the
wrapper computes the plain version; the kernel itself is compared with the
plain version on the card by tests/test_torch_gpu.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from aesfhe_tpu.core import pallas_ks
from aesfhe_tpu.core import rns as jrns
from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.core import ks_inner
from aesfhe_tpu_torch.core.params import get_params


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Several test workers share the cores, and torch's default pool of one
    thread per core then stalls in its barriers; two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N = 16384                    # the Pallas tiling needs N % (64 * 128) == 0


def _operands(seed, J, dnum, qk, rows):
    """Digits over the active rows, keys over all Mk rows (uint32)."""
    rng = np.random.default_rng(seed)
    qs = qk[rows]
    d = np.stack([np.stack([rng.integers(0, q, N, dtype=np.uint32)
                            for q in qs]) for _ in range(J)])
    kb, ka = (np.stack([np.stack([rng.integers(0, q, N, dtype=np.uint32)
                                  for q in qk]) for _ in range(dnum)])
              for _ in range(2))
    qinv = np.asarray([jrns.montgomery_consts(int(q))[0] for q in qs],
                      dtype=np.uint32)
    return d, kb, ka, qs, qinv


def _interpret(fn, *args):
    """Run a pallas_ks entry point in interpret mode on the CPU."""
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        fn._clear_cache()
        return np.asarray(fn(*args))
    finally:
        pl.pallas_call = orig
        fn._clear_cache()


def _port(d, kb, ka, rows, qs, qinv):
    def t(a):
        return interop.to_tensor(a, device="cpu")

    return interop.to_numpy(ks_inner.ks_inner(
        t(d), t(kb), t(ka), rows, t(qs), t(qinv)))


def test_plain_equals_pallas_full_layout():
    p = get_params("tiny")
    J, M = 3, 6
    qk = np.asarray(p.all_primes[:M], dtype=np.uint32)
    rows = np.arange(M, dtype=np.int32)
    d, kb, ka, qs, qinv = _operands(5, J, J, qk, rows)
    j = [jnp.asarray(a) for a in (d, kb, ka, qs, qinv)]
    want = _interpret(pallas_ks.ks_inner_pallas, *j)
    assert np.array_equal(want, np.asarray(pallas_ks.ks_inner_xla(*j)))
    before = ks_inner.launches
    assert np.array_equal(_port(d, kb, ka, rows, qs, qinv), want)
    assert ks_inner.launches == before      # CPU tensors: no kernel launch


def test_plain_equals_pallas_capped_layout():
    """A level-capped key with more digits than the switch uses: logical
    limb m reads physical row m + shift*(m > lvl), digits j < J of dnum."""
    p = get_params("tiny")
    J, dnum = 2, 3
    lvl, cap, K = 3, 6, 2
    M, Mk = lvl + 1 + K, cap + 1 + K
    qk = np.asarray((p.all_primes * 3)[:Mk], dtype=np.uint32)
    rows = np.concatenate([np.arange(lvl + 1),
                           cap + 1 + np.arange(K)]).astype(np.int32)
    d, kb, ka, qs, qinv = _operands(7, J, dnum, qk, rows)
    shift = int(rows[-1] - (M - 1))
    want = _interpret(pallas_ks.ks_inner_pallas_rows, jnp.asarray(d),
                      jnp.asarray(kb), jnp.asarray(ka), jnp.asarray(qs),
                      jnp.asarray(qinv), lvl, shift)
    xla = pallas_ks.ks_inner_xla(jnp.asarray(d), jnp.asarray(kb[:J, rows]),
                                 jnp.asarray(ka[:J, rows]), jnp.asarray(qs),
                                 jnp.asarray(qinv))
    assert np.array_equal(want, np.asarray(xla))
    assert np.array_equal(_port(d, kb, ka, rows, qs, qinv), want)


def test_wrapper_rejects_bad_operands():
    p = get_params("tiny")
    qk = np.asarray(p.all_primes[:4], dtype=np.uint32)
    rows = np.arange(4, dtype=np.int32)
    d, kb, ka, qs, qinv = (interop.to_tensor(a, device="cpu") for a in
                           _operands(1, 2, 2, qk, rows))
    with pytest.raises(ValueError, match="digits but the key has"):
        ks_inner.ks_inner(torch.cat([d, d]), kb, ka, rows, qs, qinv)
    with pytest.raises(ValueError, match="rows_key"):
        ks_inner.ks_inner(d, kb, ka, rows[:3], qs, qinv)
    with pytest.raises(ValueError, match="outside"):
        ks_inner.ks_inner(d, kb, ka, rows + 1, qs, qinv)
    with pytest.raises(TypeError, match="int32"):
        ks_inner.ks_inner(d.long(), kb, ka, rows, qs, qinv)
    with pytest.raises(ValueError, match="contiguous"):
        ks_inner.ks_inner(d.transpose(0, 1), kb, ka, rows, qs, qinv)

