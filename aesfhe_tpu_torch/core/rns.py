"""RNS modular arithmetic: host tables (numpy / Python ints) and the device
primitives on torch integer tensors.

Counterpart of `aesfhe_tpu/core/rns.py`.  The reference builds every product
from exact uint32 pieces because the TPU has no 64-bit multiply; here the
device functions take int64 tensors that hold uint32 values and form each
product exactly in 64 bits.  Every prime is <= 2^30, so a product of a
residue with any uint32 stays below 2^62.  Each function returns the
canonical residue in [0, q), as the reference does on its stated domain:
`add_mod`/`sub_mod`/`neg_mod` take canonical inputs, `mont_mul` takes
a < q and any uint32 b, the others any uint32.

`rinv` is 2^-32 mod q: the Montgomery product REDC(a*b) = a*b*2^-32 mod q
is computed as ((a*b) mod q) * rinv mod q, which is the same residue.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host-side prime/table generation (numpy / Python ints)
# ---------------------------------------------------------------------------

def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_primes(bits: int, two_n: int, count: int,
                    skip: tuple[int, ...] = ()) -> list[int]:
    """`count` primes q = k*two_n + 1 closest to 2**bits, alternating above
    and below, each <= 2^30."""
    base = 1 << bits
    found: list[int] = []
    k = 0
    while len(found) < count:
        k += 1
        for cand in (base + k * two_n + 1, base - k * two_n + 1):
            if cand > (1 << 30) or cand <= two_n:
                continue
            if cand in skip or cand in found:
                continue
            if _is_prime(cand):
                found.append(cand)
                if len(found) == count:
                    break
    return found


def find_primitive_2n_root(q: int, two_n: int) -> int:
    """psi, a primitive (two_n)-th root of unity mod q."""
    assert (q - 1) % two_n == 0
    cof = (q - 1) // two_n
    g = 2
    while True:
        psi = pow(g, cof, q)
        if pow(psi, two_n // 2, q) == q - 1:
            return psi
        g += 1


def montgomery_consts(q: int) -> tuple[int, int]:
    """(qinv_neg, r2): -q^-1 mod 2^32 and 2^64 mod q."""
    qinv = pow(q, -1, 1 << 32)
    return ((1 << 32) - qinv) % (1 << 32), (1 << 64) % q


def shoup_precompute(w: int, q: int) -> int:
    """floor(w * 2^32 / q), the Shoup companion of a constant w < q."""
    assert 0 <= w < q
    return (w << 32) // q


def barrett_magic(q: int) -> int:
    """floor(2^32 / q)."""
    return (1 << 32) // q


def mont_rinv(q: int) -> int:
    """2^-32 mod q."""
    return pow(1 << 32, -1, q)


# ---------------------------------------------------------------------------
# Device-side arithmetic on int64 tensors holding uint32 values
# ---------------------------------------------------------------------------

def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 storage (uint32 bits) -> int64 holding the unsigned value."""
    return x.to(torch.int64) & MASK32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a value in [0, 2^32) -> int32 with the same bits."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def add_mod(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    return torch.where(a >= b, a - b, a + q - b)


def neg_mod(a, q):
    return torch.where(a == 0, a, q - a)


def mont_mul(a, b, q, rinv):
    """REDC(a*b) = a*b*2^-32 mod q (Montgomery product)."""
    return (a * b) % q * rinv % q


def shoup_mul(x, w, q):
    """x * w mod q for a constant w < q and any uint32 x (the reference
    passes w's Shoup companion too; the 64-bit product does not need it)."""
    return (x * w) % q


def to_mont(a, q, r2, rinv):
    """Plain -> Montgomery: REDC(a * (2^64 mod q))."""
    return mont_mul(a, r2, q, rinv)


def from_mont(a, q, rinv):
    """Montgomery -> plain: REDC(a * 1)."""
    return (a * rinv) % q


def barrett_reduce(x, q):
    """x mod q for any uint32 x."""
    return x % q


# ---------------------------------------------------------------------------
# Host-side exact CRT reconstruction (Garner) for decrypt/decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _garner_tables(primes: tuple[int, ...]):
    """inv(prod_{j<i} q_j) mod q_i for the Garner mixed-radix digits."""
    L = len(primes)
    inv = np.zeros((L,), dtype=np.uint64)
    for i in range(1, L):
        p = 1
        for j in range(i):
            p = (p * primes[j]) % primes[i]
        inv[i] = pow(p, -1, primes[i])
    return inv


def _garner_digits(residues: np.ndarray, primes: tuple[int, ...]) -> np.ndarray:
    """Mixed-radix digits d_i of the CRT value: v = sum_i d_i prod_{j<i} q_j.

    residues: uint64 [L, ...] with residues[i] < q_i; every intermediate
    product fits in uint64 since the primes are < 2^31."""
    primes_np = np.asarray(primes, dtype=np.uint64).reshape(
        (len(primes),) + (1,) * (residues.ndim - 1))
    inv = _garner_tables(primes)
    L = len(primes)
    digits = np.zeros_like(residues)
    digits[0] = residues[0]
    acc = np.broadcast_to(residues[0:1] % primes_np, residues.shape).copy()
    prodm = np.ones((L,), dtype=np.uint64)
    for i in range(1, L):
        qi = np.uint64(primes[i])
        for k in range(L):
            prodm[k] = (prodm[k] * np.uint64(primes[i - 1])) % np.uint64(primes[k])
        diff = (residues[i] + qi - acc[i]) % qi
        digits[i] = (diff * np.uint64(inv[i])) % qi
        if i + 1 < L:
            d_mod = digits[i][None] % primes_np
            pm = prodm.reshape(primes_np.shape)
            acc = (acc + (d_mod * pm) % primes_np) % primes_np
    return digits


def crt_to_centered_float(residues: np.ndarray, primes: tuple[int, ...],
                          max_abs_bits: int = 58) -> np.ndarray:
    """CRT-reconstruct centered values as float64 (|value| < 2^max_abs_bits):
    Garner digits of the residues and of their negation, selected by the
    top digit."""
    primes_np = np.asarray(primes, dtype=np.uint64)
    L = len(primes)
    pos_d = _garner_digits(residues, primes)
    neg_res = (primes_np[:, None] - residues) % primes_np[:, None]
    neg_d = _garner_digits(neg_res, primes)
    negative = pos_d[L - 1] >= (primes_np[L - 1] // np.uint64(2))
    radix = 1.0
    pos_f = np.zeros(residues.shape[1:], dtype=np.float64)
    neg_f = np.zeros(residues.shape[1:], dtype=np.float64)
    for i in range(L):
        if radix > 2.0 ** (max_abs_bits + 10):
            break
        pos_f += pos_d[i].astype(np.float64) * radix
        neg_f += neg_d[i].astype(np.float64) * radix
        radix *= float(primes[i])
    return np.where(negative, -neg_f, pos_f)
