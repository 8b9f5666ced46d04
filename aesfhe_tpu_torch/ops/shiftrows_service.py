"""ShiftRows as masked slot rotations on SIMD-packed AES states.
Counterpart of `aesfhe_tpu/ops/shiftrows_service.py`.

Layout: row r of a block occupies slots r, r+4, r+8, r+12 of its 16-slot
block.  Row r moves left by r columns cyclically within its own block: the
columns that stay in the block and those that wrap take two masked
rotations.  The masks are dense plaintexts, encoded once on the host
through the exact f64 path.
"""
from __future__ import annotations

import numpy as np

from ..core.ciphertext import Ciphertext
from .xor_service import EngineWrapper, XORService


class AESFHEShiftRows:
    def __init__(self, engine_wrapper: EngineWrapper,
                 xor_svc: XORService | None = None):
        self.eng = engine_wrapper
        self.xor_svc = xor_svc
        sc = self.eng.engine.slot_count
        self.sc = sc
        # SIMD masks, tiled over every 16-slot block and split into the
        # part that stays in-block under a left rotation and the part that
        # wraps
        self._simd_masks = {}
        idx = np.arange(sc)
        pos = idx % 16
        row = pos % 4
        col = pos // 4
        for r in range(1, 4):
            # forward (left shift by r): col >= r stays in block (rot -4r),
            # col < r wraps (rot +16-4r)
            keep_f = ((row == r) & (col >= r)).astype(float)
            wrap_f = ((row == r) & (col < r)).astype(float)
            # inverse (right shift by r): col < 4-r stays (rot +4r),
            # col >= 4-r wraps (rot -(16-4r))
            keep_i = ((row == r) & (col < 4 - r)).astype(float)
            wrap_i = ((row == r) & (col >= 4 - r)).astype(float)
            self._simd_masks[r] = dict(
                fwd=(self.eng.encode(keep_f), self.eng.encode(wrap_f)),
                inv=(self.eng.encode(keep_i), self.eng.encode(wrap_i)))
        self._row_mask_simd = [
            self.eng.encode((row == r).astype(float)) for r in range(4)]

    def shift_rows(self, ct: Ciphertext) -> Ciphertext:
        return self.shift_rows_simd(ct)

    def inverse_shift_rows(self, ct: Ciphertext) -> Ciphertext:
        return self.shift_rows_simd(ct, inverse=True)

    def shift_rows_simd(self, ct: Ciphertext, inverse: bool = False
                        ) -> Ciphertext:
        """In-block ShiftRows (or its inverse) for every packed block: two
        masked rotations per row."""
        eng = self.eng
        out = eng.multiply_plain(ct, self._row_mask_simd[0])
        for r in range(1, 4):
            if not inverse:
                keep, wrap = self._simd_masks[r]["fwd"]
                rot_keep, rot_wrap = -4 * r, 16 - 4 * r
            else:
                keep, wrap = self._simd_masks[r]["inv"]
                rot_keep, rot_wrap = 4 * r, -(16 - 4 * r)
            m_keep = eng.rotate(eng.multiply_plain(ct, keep), rot_keep)
            m_wrap = eng.rotate(eng.multiply_plain(ct, wrap), rot_wrap)
            out = eng.add(out, eng.add(m_keep, m_wrap))
        return out
