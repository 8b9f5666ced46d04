"""Card-only checks of the port's CUDA kernels against their plain versions.

Skipped without a CUDA card.  This file imports no JAX, so it also runs on
a machine without the reference package's dependencies:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from aesfhe_tpu_torch import interop
from aesfhe_tpu_torch.core import ks_inner, rns
from aesfhe_tpu_torch.core.params import get_params


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
