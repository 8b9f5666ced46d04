"""SubBytes in the byte (zeta256) domain: the AES S-box as two 8->4 LUTs
over a shared power basis.  Counterpart of `aesfhe_tpu/ops/sbox_service.py`.

The basis is a binary-depth ladder plus conjugations (build_power_basis_256)
and each LUT one fused linear combination; the BSGS variant cuts the
key-switches from ~130 to ~34.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from ..coeffs import generate as coeffgen
from ..context import EngineContext
from ..core.ciphertext import Ciphertext
from .xor_service import EngineWrapper, build_power_basis_256, eval_lut_1d

COEFF_DIR = coeffgen.COEFF_DIR


def load_json_coeffs(path: Path) -> np.ndarray:
    """Dense complex coefficient vector from the 1D JSON schema."""
    return coeffgen.load_1d_coeffs(path, mirror_half=False)


class SBoxService:
    def __init__(self, ctx: EngineContext | EngineWrapper,
                 hi_path: Path = COEFF_DIR / "sbox_hi_coeffs.json",
                 lo_path: Path = COEFF_DIR / "sbox_lo_coeffs.json"):
        self.wrap = ctx if isinstance(ctx, EngineWrapper) else \
            EngineWrapper(ctx=ctx)
        self.ctx = self.wrap.ctx
        self.engine = self.wrap.engine
        self.rlk = self.wrap.relin_key
        self.coeffs_hi = load_json_coeffs(hi_path)
        self.coeffs_lo = load_json_coeffs(lo_path)

    def _build_power_basis(self, ct: Ciphertext) -> Dict[int, Ciphertext]:
        return build_power_basis_256(self.wrap, ct)

    def _eval_lut(self, basis: Dict[int, Ciphertext],
                  coeffs: np.ndarray) -> Ciphertext:
        return eval_lut_1d(self.wrap, basis, coeffs)

    def sub_bytes_array(self, enc_arr: Ciphertext) -> Ciphertext:
        """SIMD SubBytes on every slot: zeta256^x -> zeta256^SBOX[x]."""
        basis = self._build_power_basis(enc_arr)
        out_hi = self._eval_lut(basis, self.coeffs_hi)
        out_lo = self._eval_lut(basis, self.coeffs_lo)
        # zeta256^(16*hi) * zeta256^lo = zeta256^SBOX[x]
        return self.engine.multiply(out_hi, out_lo, self.rlk)

    def sub_bytes(self, enc_byte: Ciphertext) -> Ciphertext:
        return self.sub_bytes_array(enc_byte)

    def sub_bytes_array_bsgs(self, enc_arr: Ciphertext) -> Ciphertext:
        """BSGS SubBytes: f(t) = sum_g t^(16g) * (sum_b c[16g+b] t^b).

        Baby powers t^1..t^15 and giant powers (t^16)^1..15 come from two
        ladders; the double sum becomes 16 fused linear combinations and one
        inner product."""
        eng = self.wrap
        baby_pos = eng.make_power_basis(enc_arr, 15)
        baby = {k: baby_pos[k - 1] for k in range(1, 16)}
        t16 = eng.multiply(baby[8], baby[8], self.rlk)       # t^16
        giant_pos = eng.make_power_basis(t16, 15)
        giant = {g: giant_pos[g - 1] for g in range(1, 16)}
        out = None
        for coeffs in (self.coeffs_hi, self.coeffs_lo):
            lhs, rhs = [], []
            lin = None
            # g = 0 block: a plain linear combination of baby powers
            ks = [b for b in range(1, 16) if abs(coeffs[b]) > 1e-12]
            if ks:
                lin = eng.linear_combination([baby[b] for b in ks],
                                             [coeffs[b] for b in ks],
                                             constant=coeffs[0])
            for g in range(1, 16):
                block = coeffs[16 * g:16 * g + 16]
                bs = [b for b in range(16) if abs(block[b]) > 1e-12]
                if not bs:
                    continue
                if bs == [0]:
                    # pure-constant block: fold giant^g * c into the linear part
                    lin2 = eng.multiply(giant[g], complex(block[0]))
                    lin = lin2 if lin is None else eng.add(lin, lin2)
                    continue
                inner = eng.linear_combination(
                    [baby[b] for b in bs if b > 0],
                    [block[b] for b in bs if b > 0],
                    constant=block[0])
                lhs.append(giant[g])
                rhs.append(inner)
            res = eng.inner_product(lhs, rhs) if lhs else None
            if res is None:
                res = lin
            elif lin is not None:
                res = eng.add(res, lin)
            out = res if out is None else self.engine.multiply(out, res,
                                                               self.rlk)
        return out
