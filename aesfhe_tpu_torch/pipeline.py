"""Homomorphic AES-128 on the bit-sliced pipeline.  Counterpart of
`aesfhe_tpu/pipeline.py`'s AESFHE128Bitsliced (the zeta pipeline and
per-round checkpointing are not ported yet).

One middle round = AddRoundKey (1 level) + SubBytes (4) + ShiftRows (1) +
MixColumns (4-5) + sign-cleanse (3) ~= 14 levels, so three rounds fit a
fresh prod_boot ciphertext (54 levels) without a bootstrap.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .core.ciphertext import Ciphertext
from .keyexp import expand_key_128
from .ops.bitplane import BitSliceService, BitState
from .ops.xor_service import EngineWrapper


class AESFHE128Bitsliced:
    ROUND_DEPTH = 14          # rescale units consumed by one middle round

    def __init__(self, eng_wrap: EngineWrapper, key: bytes | np.ndarray,
                 refresh: Optional[Callable[[Ciphertext], Ciphertext]] = None):
        self.eng = eng_wrap
        self.svc = BitSliceService(eng_wrap)
        self.round_keys = expand_key_128(key)
        self.refresh = refresh

    def encrypt_state(self, state_bytes: np.ndarray) -> BitState:
        return self.svc.encrypt_state(state_bytes)

    def decrypt_state(self, st: BitState) -> np.ndarray:
        return self.svc.decrypt_state(st)

    def _refresh(self, st: BitState, need_levels: int) -> BitState:
        """Pair-packed refresh: two real planes ride one complex refresh as
        p0 + i*p1 (exact i-multiply), unpacked by one conjugation and two
        2-term combines, then sign-cleansed.  A no-op without `refresh` or
        while the state still has `need_levels` levels."""
        if self.refresh is None:
            return st
        eng = self.eng.engine
        need = need_levels * eng.params.rescale_primes + 2
        if min(b.level for b in st.bits) >= need:
            return st
        out = [None] * len(st.bits)
        for p in range(0, len(st.bits), 2):
            packed = eng.add(st.bits[p], eng.multiply_i(st.bits[p + 1]))
            z = self.refresh(packed)
            zc = eng.conjugate(z, self.eng.conj_key)
            out[p] = eng.linear_combination([z, zc], [0.5, 0.5])
            out[p + 1] = eng.linear_combination([z, zc], [-0.5j, 0.5j])
        return self.svc.cleanse(BitState(out))

    def encrypt_rounds(self, st: BitState, rounds: int = 10) -> BitState:
        """FIPS-197 order: ARK(rk_{r-1}) + SubBytes + ShiftRows (+MixColumns
        and cleanse) per round; round 10 folds ARK(rk10) into the ShiftRows
        masks.  A partial run (rounds < 10) closes with ARK(rk_rounds), so
        it matches aes_tables.aes128_partial."""
        svc = self.svc
        for r in range(1, rounds + 1):
            st = self._refresh(st, self.ROUND_DEPTH)
            st = svc.xor_plain(st, self.round_keys[r - 1])
            st = svc.sub_bytes(st)
            if r == 10:
                st = svc.shift_rows(st, fold_key=self.round_keys[10])
            else:
                st = svc.shift_rows(st)
                st = svc.mix_columns(st)
                st = svc.cleanse(st)
        if rounds < 10:
            st = svc.xor_plain(st, self.round_keys[rounds])
        return st

    def decrypt_rounds(self, st: BitState, rounds: int = 10) -> BitState:
        """Inverse cipher: undo rounds `rounds`..1, then ARK(rk0)."""
        svc = self.svc
        for r in range(rounds, 0, -1):
            st = self._refresh(st, self.ROUND_DEPTH + 4)
            st = svc.xor_plain(st, self.round_keys[r])
            if r != 10:
                st = svc.mix_columns(st, inverse=True)
                st = svc.cleanse(st)
            st = svc.shift_rows(st, inverse=True)
            st = svc.sub_bytes(st, inverse=True)
            st = svc.cleanse(st)
        return svc.xor_plain(st, self.round_keys[0])
