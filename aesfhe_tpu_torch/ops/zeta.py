"""Zeta-domain codec: integers <-> complex roots of unity, numpy only.
Counterpart of `aesfhe_tpu/ops/zeta.py`: integer k maps to
exp(-2j*pi*(k mod m)/m); decoding measures the phase and rounds.
"""
from __future__ import annotations

import numpy as np


class ZetaEncoder:
    @staticmethod
    def to_zeta(arr: np.ndarray, modulus: int = 16) -> np.ndarray:
        arr = np.asarray(arr).astype(np.int64, copy=False)
        return np.exp(-2j * np.pi * (arr % modulus) / modulus)

    @staticmethod
    def from_zeta(z_arr: np.ndarray, modulus: int = 16) -> np.ndarray:
        angles = np.angle(np.asarray(z_arr))
        k = (-angles * modulus) / (2 * np.pi)
        return np.mod(np.rint(k), modulus).astype(np.uint8)


def zeta_encode(arr, modulus: int = 16) -> np.ndarray:
    return ZetaEncoder.to_zeta(np.asarray(arr, dtype=np.int64), modulus)


def zeta_decode(z_arr: np.ndarray, modulus: int = 16) -> np.ndarray:
    return ZetaEncoder.from_zeta(z_arr, modulus)


def split_nibbles(flat: np.ndarray):
    """Byte array -> (hi, lo) nibbles."""
    flat = np.asarray(flat)
    if flat.dtype != np.uint8:
        flat = flat.astype(np.uint8, copy=False)
    return np.right_shift(flat, 4), np.bitwise_and(flat, 0x0F)


def phase_error(z_arr: np.ndarray, expected: np.ndarray,
                modulus: int = 16) -> float:
    """Largest phase distance, in units of one zeta_m step, between each
    slot and zeta_m^expected; a slot decodes right while it is below 0.5."""
    k = -np.angle(np.asarray(z_arr)) * modulus / (2 * np.pi)
    d = np.mod(k - np.asarray(expected, dtype=np.float64) + modulus / 2,
               modulus) - modulus / 2
    return float(np.max(np.abs(d)))
