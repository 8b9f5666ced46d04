"""AESFHERound: the nibble-pipeline round driver over plain inputs.
Counterpart of `aesfhe_tpu/ops/round_service.py` (AddRoundKey on nibble
pairs, ShiftRows in the row-blocked layout, decrypt-and-recombine, and
MixColumns through the merged transformer).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..context import EngineContext
from ..core.ciphertext import Ciphertext
from .xor_service import EngineWrapper, XORService
from .zeta import ZetaEncoder, split_nibbles


def decrypt_and_recombine(ct_hi, ct_lo, eng: EngineWrapper,
                          length: int | None = None) -> np.ndarray:
    """(zeta16^hi ct, zeta16^lo ct) -> plaintext bytes."""
    hi_vals = ZetaEncoder.from_zeta(eng.decrypt(ct_hi), 16)
    lo_vals = ZetaEncoder.from_zeta(eng.decrypt(ct_lo), 16)
    if length is not None:
        hi_vals = hi_vals[:length]
        lo_vals = lo_vals[:length]
    return (hi_vals.astype(np.uint8) << 4) | lo_vals.astype(np.uint8)


def get_shift_rows_masks(ctx: EngineContext) -> dict:
    """Row-blocked-layout masks, encoded once per context: the state is
    stored as [row0 of all blocks | row1 of all blocks | ...], each row
    segment ordered column-major (col*max_blocks + block).  Besides the
    whole-segment masks, the keep/wrap split of each row, so the rotation
    wraps within its segment."""
    masks = getattr(ctx, "_shift_rows_masks", None)
    if masks is not None:
        return masks
    engine = ctx.engine
    sc = engine.slot_count
    mb = sc // 16
    idx = np.arange(sc)
    seg_row = idx // (4 * mb)                  # which row segment
    col = (idx % (4 * mb)) // mb               # column within the segment
    masks = {}
    for r in range(4):
        masks[r] = engine.encode((seg_row == r).astype(float))
        masks[(r, "keep")] = engine.encode(
            ((seg_row == r) & (col >= r)).astype(float))
        masks[(r, "wrap")] = engine.encode(
            ((seg_row == r) & (col < r)).astype(float))
    ctx._shift_rows_masks = masks
    return masks


class AESFHERound:
    """Plain state and key -> homomorphic AddRoundKey -> plain result."""

    def __init__(self, eng_wrap: EngineWrapper, xor_svc: XORService):
        self.eng = eng_wrap
        self.xor = xor_svc

    def encrypt_nibbles(self, hi: np.ndarray,
                        lo: np.ndarray) -> Tuple[Ciphertext, Ciphertext]:
        return (self.eng.encrypt(ZetaEncoder.to_zeta(hi, 16)),
                self.eng.encrypt(ZetaEncoder.to_zeta(lo, 16)))

    def add_round_key(self, s_hi, s_lo, k_hi, k_lo):
        """Homomorphic XOR of encrypted state and key nibble pairs."""
        return (self.xor.xor_cipher(s_hi, k_hi),
                self.xor.xor_cipher(s_lo, k_lo))

    def add_round_key_plain(self, s_hi, s_lo, k_hi: np.ndarray,
                            k_lo: np.ndarray):
        """The round key in the clear: each XOR is 8 plaintext multiplies."""
        return (self.xor._xor_with_plain_nibbles(s_hi, k_hi),
                self.xor._xor_with_plain_nibbles(s_lo, k_lo))

    @staticmethod
    def shift_rows(ctx: EngineContext, ct_hi, ct_lo):
        """Row-blocked-layout ShiftRows with in-segment wraparound."""
        engine = ctx.engine
        mb = engine.slot_count // 16
        masks = get_shift_rows_masks(ctx)
        out_hi = out_lo = None
        for r in range(4):
            parts = [(masks[r], 0)] if r == 0 else [
                (masks[(r, "keep")], -r * mb),
                (masks[(r, "wrap")], (4 - r) * mb),
            ]
            for mask, steps in parts:
                m_hi = engine.multiply(ct_hi, mask)
                m_lo = engine.multiply(ct_lo, mask)
                if steps:
                    m_hi = engine.rotate(m_hi, ctx.rotation_key, steps)
                    m_lo = engine.rotate(m_lo, ctx.rotation_key, steps)
                out_hi = m_hi if out_hi is None else engine.add(out_hi, m_hi)
                out_lo = m_lo if out_lo is None else engine.add(out_lo, m_lo)
        return out_hi, out_lo

    def mix_columns(self, ct_hi, ct_lo):
        """Nibble-pair ShiftRows+MixColumns through the merged transformer."""
        from .mixcolumns_service import AESFHETransformer, NibblePair
        tf = AESFHETransformer(self.eng, self.xor)
        out = tf.merged_shift_mix_pairs(NibblePair(ct_hi, ct_lo))
        return out.hi, out.lo

    def full_round(self, state: np.ndarray, key: np.ndarray,
                   recombine: bool = True):
        """AddRoundKey end to end: encrypt state and key nibbles, XOR,
        decrypt and recombine (or return the two ciphertexts)."""
        s_hi, s_lo = split_nibbles(np.asarray(state, dtype=np.uint8))
        k_hi, k_lo = split_nibbles(np.asarray(key, dtype=np.uint8))
        ct_s_hi, ct_s_lo = self.encrypt_nibbles(s_hi, s_lo)
        ct_k_hi, ct_k_lo = self.encrypt_nibbles(k_hi, k_lo)
        ct_out_hi, ct_out_lo = self.add_round_key(ct_s_hi, ct_s_lo,
                                                  ct_k_hi, ct_k_lo)
        if not recombine:
            return ct_out_hi, ct_out_lo
        return decrypt_and_recombine(ct_out_hi, ct_out_lo, self.eng,
                                     length=np.asarray(state).shape[0])
