"""CKKS canonical-embedding encode/decode on the host (numpy float64).
Counterpart of `aesfhe_tpu/core/encoding.py`.

Slots z in C^(N/2) <-> integer polynomial coefficients via psi_C =
exp(i*pi/N): slot j is the evaluation at psi_C^(5^j mod 2N), its conjugate
point carries conj(z), so the coefficients are real.
"""
from __future__ import annotations

import numpy as np

from .params import CKKSParams


def slots_to_coeffs(z: np.ndarray, params: CKKSParams, scale: float) -> np.ndarray:
    """Complex slots [<= N/2] -> rounded integer coefficients [N] (float64,
    exact for |coeff| < 2^53)."""
    n = params.n
    sc = params.slot_count
    z = np.asarray(z, dtype=np.complex128)
    if z.size < sc:
        z = np.pad(z, (0, sc - z.size))
    elif z.size > sc:
        raise ValueError(f"too many slots: {z.size} > {sc}")
    val = np.zeros(n, dtype=np.complex128)
    val[params.slot_pos] = z
    val[params.conj_slot_pos] = np.conj(z)
    natural = val[params.pos_of_exp[1::2]]
    p = np.fft.fft(natural) * params.psi_c_pow_inv / n
    return np.round(p.real * scale)


def coeffs_to_slots(coeffs: np.ndarray, params: CKKSParams, scale: float) -> np.ndarray:
    """Float coefficients [N] -> complex slots [N/2]."""
    n = params.n
    p = np.asarray(coeffs, dtype=np.float64) / scale
    natural = np.fft.ifft(p * params.psi_c_pow) * n
    val = np.zeros(n, dtype=np.complex128)
    val[params.pos_of_exp[1::2]] = natural
    return val[params.slot_pos]


def coeffs_to_digits(coeffs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Signed integer coefficients (float64 holding exact integers) ->
    (digits [4, N] uint32 base 2^22, neg [N] bool); exact for |c| < 2^88."""
    c = np.asarray(coeffs, dtype=np.float64)
    assert np.all(np.abs(c) < 2 ** 88), "coefficient overflow"
    neg = c < 0
    a = np.abs(c)
    digits = np.empty((4,) + c.shape[-1:], dtype=np.uint32)
    B = float(1 << 22)
    for k in range(4):
        nxt = np.floor(a / B)
        digits[k] = (a - nxt * B).astype(np.uint32)
        a = nxt
    return digits, neg


def coeffs_to_rns(coeffs: np.ndarray, primes: tuple[int, ...]) -> np.ndarray:
    """Signed integer coefficients (float64 holding exact integers) ->
    uint64 residues [L, N]; above 2^62 the value splits exactly into
    hi*2^32 + lo."""
    c = np.asarray(coeffs, dtype=np.float64)
    if np.all(np.abs(c) < 2 ** 62):
        ci = c.astype(np.int64)[None, :]
        qi = np.asarray(primes, dtype=np.int64).reshape(-1, 1)
        return np.mod(ci, qi).astype(np.uint64)
    assert np.all(np.abs(c) < 2 ** 85), "coefficient overflow"
    neg = (c < 0)[None, :]
    a = np.abs(c)
    hi = np.floor(a / 2 ** 32)
    lo = a - hi * 2 ** 32
    hi_u = hi.astype(np.uint64)[None, :]
    lo_u = lo.astype(np.uint64)[None, :]
    qq = np.asarray(primes, dtype=np.uint64).reshape(-1, 1)
    base = np.asarray([(1 << 32) % int(q) for q in primes],
                      dtype=np.uint64).reshape(-1, 1)
    r = (hi_u % qq) * base % qq
    r = (r + lo_u % qq) % qq
    return np.where(neg, (qq - r) % qq, r)
