"""Names of the reference's merged shift+mix variants, each delegating to
the one implementation (ops/mixcolumns_service.AESFHETransformer).
Counterpart of `aesfhe_tpu/ops/shift_mix_variants.py`."""
from __future__ import annotations

import numpy as np

from .mixcolumns_service import AESFHETransformer
from .xor_service import EngineWrapper, XORService


class MixRow:
    def __init__(self, xor_svc: XORService, eng_wrap: EngineWrapper):
        self.xor = xor_svc
        self.eng = eng_wrap
        self._tf = AESFHETransformer(eng_wrap, xor_svc)

    def shift_mix(self, state_bytes: np.ndarray):
        return self._tf.merged_shift_mix(state_bytes)

    def inv_shift_mix_from_ct(self, ct):
        """The inverse from a byte-domain ciphertext, encrypted end to end."""
        return self._tf.merged_inv_mixshift(ct)


class ShiftRowMixColTransformer:
    def __init__(self, xor_svc: XORService, eng_wrap: EngineWrapper):
        self.xor = xor_svc
        self.eng = eng_wrap
        self._tf = AESFHETransformer(eng_wrap, xor_svc)

    def merged_shift_mix(self, state_bytes: np.ndarray):
        return self._tf.merged_shift_mix(state_bytes)

    def merged_inv_mixshift(self, ct):
        return self._tf.merged_inv_mixshift(ct)
