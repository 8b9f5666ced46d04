"""The LUT sums (`aesfhe_tpu_torch/core/lut_sum.py`: lut_sum, lut_sum_dense)
on the CPU, where each wrapper runs its plain version: a model of the
kernel's arithmetic (Shoup products on w+- = re +- imz, lazy REDC, the
lazy 32-bit accumulator) against the plain versions at residues 0 and q-1,
primes of 14 to 30 bits and K past the kernel's constant tile; the
wrappers' routing, argument checks and launch counters.  The kernel itself
runs on the card (tests/test_torch_gpu.py, chip_smoke.py); the sums
against the reference's in tests/test_torch_ops.py."""
import numpy as np
import pytest
import torch

from aesfhe_tpu_torch import kernels
from aesfhe_tpu_torch.core import lut_sum, rns
from aesfhe_tpu_torch.core.params import _PROFILES, CKKSParams

M32 = (1 << 32) - 1
KTILE = 64                     # csrc/lut_sum.cu's kTile


def _largest_prime_below(n: int) -> int:
    n -= 1 + n % 2
    while not rns._is_prime(n):
        n -= 2
    return n


# prod_boot-like 30- and 27-bit primes, the primes below 2^16 of the
# scale-2^14 chain, and the largest prime the kernel takes
PRIMES = {"30-27bit": rns.find_ntt_primes(30, 1 << 17, 2)
          + rns.find_ntt_primes(27, 1 << 17, 2),
          "14-16bit": rns.find_ntt_primes(14, 1 << 11, 1)
          + rns.find_ntt_primes(15, 1 << 11, 1)
          + rns.find_ntt_primes(16, 1 << 11, 1),
          "2^30-35": [_largest_prime_below(1 << 30)]}


class _Rows:
    """The row tables the wrappers read (ops_impl._RowTables' fields)."""

    def __init__(self, primes):
        self.q = torch.as_tensor(primes, dtype=torch.int64)
        self.rinv = torch.as_tensor([rns.mont_rinv(q) for q in primes])
        self.q32 = rns.narrow(self.q)
        self.qinv32 = rns.narrow(torch.as_tensor(
            [rns.montgomery_consts(q)[0] for q in primes]))


def _residues(primes, lead, n, rng):
    """uint64 residues [*lead, L, n], a quarter of them 0 or q-1."""
    q = np.asarray(primes, dtype=np.uint64)[:, None]
    x = rng.integers(0, 1 << 62, (*lead, len(primes), n)).astype(np.uint64)
    x %= q
    pick = rng.integers(0, 8, x.shape)
    x = np.where(pick == 0, 0, np.where(pick == 1, q - 1, x))
    return x.astype(np.uint64)


def _consts(primes, K, rng):
    """[K, L, 4] (re, re_shoup, imz, imz_shoup), edge weights included."""
    out = np.zeros((K, len(primes), 4), dtype=np.uint64)
    for k in range(K):
        for i, q in enumerate(primes):
            re, im = (int(v) for v in rng.integers(0, q, 2))
            if k % 3 == 1:
                re, im = q - 1, q - 1
            elif k % 3 == 2:
                re, im = 0, q - 1
            out[k, i] = (re, rns.shoup_precompute(re, q), im,
                         rns.shoup_precompute(im, q))
    return out


def _i32(a):
    return rns.narrow(torch.as_tensor(np.asarray(a, dtype=np.int64)))


def _lazy_add(acc, t, q):
    assert np.all(t < 2 * q) and np.all(acc + t <= M32)
    s = acc + t
    return np.where(s >= 2 * q, s - 2 * q, s)


def _scalar_model(x, consts, neg, primes):
    """csrc/lut_sum.cu's lut_sum_scalar on uint64 arrays: per limb the
    weights w+ = re + imz, w- = re - imz mod q and their Shoup companions,
    one lazy Shoup product a term by the column's sign, the lazy sum."""
    K, D, L, n = x.shape
    q = np.asarray(primes, dtype=np.uint64)[:, None]
    acc = np.zeros((D, L, n), dtype=np.uint64)
    for k in range(K):
        re = consts[k, :, 0:1] % q
        im = consts[k, :, 2:3] % q
        wp = (re + im) % q
        wm = (re + q - im) % q
        w = np.where(neg[None, :], wm, wp)
        sh = (w << np.uint64(32)) // q
        for d in range(D):
            t = (x[k, d] * w - ((x[k, d] * sh) >> np.uint64(32)) * q) & M32
            acc[d] = _lazy_add(acc[d], t, q)
    return np.where(acc >= q, acc - q, acc)


def _dense_model(x, pts, primes):
    """lut_sum_dense on uint64 arrays: a lazy REDC a term, the lazy sum."""
    K, D, L, n = x.shape
    q = np.asarray(primes, dtype=np.uint64)[:, None]
    qinv = np.asarray([rns.montgomery_consts(int(p))[0] for p in primes],
                      dtype=np.uint64)[:, None]
    acc = np.zeros((D, L, n), dtype=np.uint64)
    for k in range(K):
        for d in range(D):
            t = x[k, d] * pts[k]
            m = ((t & M32) * qinv) & M32
            assert np.all(t <= np.uint64((1 << 64) - 1) - m * q)
            acc[d] = _lazy_add(acc[d], (t + m * q) >> np.uint64(32), q)
    return np.where(acc >= q, acc - q, acc)


@pytest.mark.parametrize("primes", sorted(PRIMES))
@pytest.mark.parametrize("K,D", [(1, 2), (2, 3), (7, 2), (33, 3),
                                 (KTILE + 6, 2)])
def test_kernel_model_equals_plain(primes, K, D):
    primes = PRIMES[primes]
    rng = np.random.default_rng(K * 10 + D)
    n = 32
    x = _residues(primes, (K, D), n, rng)
    consts = _consts(primes, K, rng)
    neg = rng.integers(0, 2, n).astype(bool)
    pts = _residues(primes, (K,), n, rng)
    tr = _Rows(primes)
    got = lut_sum.lut_sum_plain(_i32(x), _i32(consts), torch.as_tensor(neg),
                                tr.q)
    assert torch.equal(got, _i32(_scalar_model(x, consts, neg, primes)))
    got = lut_sum.lut_sum_dense_plain(_i32(x), _i32(pts), tr.q, tr.rinv)
    assert torch.equal(got, _i32(_dense_model(x, pts, primes)))


def test_wrappers_run_the_plain_versions_on_the_cpu():
    primes = PRIMES["30-27bit"]
    rng = np.random.default_rng(1)
    K, D, n = 3, 2, 64
    x = _i32(_residues(primes, (K, D), n, rng))
    consts = _i32(_consts(primes, K, rng))
    neg = torch.as_tensor(rng.integers(0, 2, n).astype(bool))
    # a view of the first rows of a taller plaintext stack, read in place
    tall = _i32(_residues(primes + primes, (K,), n, rng))
    pts = tall[:, :len(primes)]
    tr = _Rows(primes)
    before = kernels.launch_counts()
    assert torch.equal(lut_sum.lut_sum(x, consts, neg, tr),
                       lut_sum.lut_sum_plain(x, consts, neg, tr.q))
    assert torch.equal(lut_sum.lut_sum_dense(x, pts, tr),
                       lut_sum.lut_sum_dense_plain(x, pts, tr.q, tr.rinv))
    assert kernels.launch_counts() == before


def _bad_calls():
    primes = PRIMES["14-16bit"]
    rng = np.random.default_rng(2)
    K, D, n = 2, 2, 16
    x = _i32(_residues(primes, (K, D), n, rng))
    consts = _i32(_consts(primes, K, rng))
    neg = torch.zeros(n, dtype=torch.bool)
    pts = _i32(_residues(primes, (K,), n, rng))
    tr = _Rows(primes)
    S, Dn = lut_sum.lut_sum, lut_sum.lut_sum_dense
    return {
        "int64 stack": (TypeError, lambda: S(x.long(), consts, neg, tr)),
        "int64 consts": (TypeError, lambda: S(x, consts.long(), neg, tr)),
        "int64 pts": (TypeError, lambda: Dn(x, pts.long(), tr)),
        "strided stack": (ValueError,
                          lambda: S(x.transpose(0, 1), consts, neg, tr)),
        "strided consts": (ValueError, lambda: S(
            x, consts.transpose(0, 1).contiguous().transpose(0, 1), neg,
            tr)),
        "strided pts rows": (ValueError,
                             lambda: Dn(x, pts.transpose(1, 2)
                                        .contiguous().transpose(1, 2), tr)),
        "3-d stack": (ValueError, lambda: S(x[0], consts, neg, tr)),
        "consts of K-1 terms": (ValueError,
                                lambda: S(x, consts[:1], neg, tr)),
        "consts of 2 columns": (ValueError,
                                lambda: S(x, consts[..., :2].contiguous(),
                                          neg, tr)),
        "pts of l rows": (ValueError, lambda: Dn(x, pts[:, 1:], tr)),
        "no terms": (ValueError, lambda: Dn(x[:0], pts[:0], tr)),
        "int neg": (ValueError, lambda: S(x, consts, neg.int(), tr)),
        "short neg": (ValueError, lambda: S(x, consts, neg[:-4], tr)),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_raise_on_what_the_kernel_does_not_take(case):
    err, call = _bad_calls()[case]
    with pytest.raises(err):
        call()


def test_zero_launches_zeroes_the_lut_sum_counters():
    assert kernels.COUNTERS["lut_sum"] == ("lut_sum", "launches_scalar")
    assert kernels.COUNTERS["lut_sum_dense"] == ("lut_sum", "launches_dense")
    kernels.add_launches({"lut_sum": 3, "lut_sum_dense": 2})
    assert (lut_sum.launches_scalar, lut_sum.launches_dense) >= (3, 2)
    kernels.zero_launches()
    counts = kernels.launch_counts()
    assert counts["lut_sum"] == counts["lut_sum_dense"] == 0


def test_every_profile_has_primes_the_kernel_takes():
    """The kernel's lazy sums (csrc/lut_sum.cu) need every prime below
    2^30; the model above holds them at the largest such prime."""
    for kw in _PROFILES.values():
        assert max(CKKSParams(**kw).all_primes) < 1 << 30
