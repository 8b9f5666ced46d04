"""GF(2^8) constant multipliers (x2, x3 for MixColumns; x9, x11, x13, x14
for the inverse) as zeta256-domain LUT polynomials.  Counterpart of
`aesfhe_tpu/ops/gf_service.py`.

Each mulN(ct) evaluates the hi/lo 8->4 LUT pair over ONE shared 255-power
basis, each LUT one fused linear combination.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..coeffs import generate as coeffgen
from ..core.ciphertext import Ciphertext
from .xor_service import (EngineWrapper, XORService, build_power_basis_256,
                          eval_lut_1d)

COEFF_DIR = coeffgen.COEFF_DIR


def _load_coeffs(path: Path) -> np.ndarray:
    return coeffgen.load_1d_coeffs(path, mirror_half=False)


class GFService:
    MULTIPLIERS = (2, 3, 9, 11, 13, 14)

    def __init__(self, eng_wrap: EngineWrapper,
                 xor_svc: XORService | None = None,
                 base: Path = COEFF_DIR):
        self.eng = eng_wrap
        self.xor_svc = xor_svc
        self.coeffs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for m in self.MULTIPLIERS:
            hi = _load_coeffs(base / f"gf{m}_hi_coeffs.json")
            lo = _load_coeffs(base / f"gf{m}_lo_coeffs.json")
            self.coeffs[m] = (hi, lo)

    def _basis(self, ct: Ciphertext) -> Dict[int, Ciphertext]:
        return build_power_basis_256(self.eng, ct)

    def _eval_lut(self, basis, coeffs: np.ndarray) -> Ciphertext:
        return eval_lut_1d(self.eng, basis, coeffs)

    def _mul(self, ct: Ciphertext, m: int,
             _shared_basis=None) -> Tuple[Ciphertext, Ciphertext]:
        basis = _shared_basis or self._basis(ct)
        hi, lo = self.coeffs[m]
        return self._eval_lut(basis, hi), self._eval_lut(basis, lo)

    # -- (hi, lo) pairs --------------------------------------------------
    def mul1(self, ct: Ciphertext) -> Ciphertext:
        return ct

    def mul2(self, ct, _shared_basis=None):
        return self._mul(ct, 2, _shared_basis)

    def mul3(self, ct, _shared_basis=None):
        return self._mul(ct, 3, _shared_basis)

    def mul9(self, ct, _shared_basis=None):
        return self._mul(ct, 9, _shared_basis)

    def mul11(self, ct, _shared_basis=None):
        return self._mul(ct, 11, _shared_basis)

    def mul13(self, ct, _shared_basis=None):
        return self._mul(ct, 13, _shared_basis)

    def mul14(self, ct, _shared_basis=None):
        return self._mul(ct, 14, _shared_basis)

    # -- whole bytes -------------------------------------------------------
    def mul_byte(self, ct: Ciphertext, m: int,
                 _shared_basis=None) -> Ciphertext:
        """zeta256^x -> zeta256^(m (x) x): the hi/lo LUT pair and one ct*ct
        recombine."""
        hi, lo = self._mul(ct, m, _shared_basis)
        return self.eng.multiply(hi, lo)

    def mul_bytes_multi(self, ct: Ciphertext,
                        ms: Tuple[int, ...]) -> Dict[int, Ciphertext]:
        """Several multipliers over ONE shared power basis."""
        basis = self._basis(ct)
        return {m: self.mul_byte(ct, m, _shared_basis=basis) for m in ms}
