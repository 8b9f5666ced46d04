"""Ciphertext / Plaintext containers over torch tensors.  Counterpart of
`aesfhe_tpu/core/ciphertext.py`.

Layout: int32 tensors holding uint32 Montgomery residues in the NTT
evaluation domain (bit-reversed order), shaped [degree+1, level+1, N] for
ciphertexts and [level+1, N] for dense plaintexts.  ScalarPlaintext is a
slot-constant complex value kept symbolically on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Ciphertext:
    data: torch.Tensor   # int32 [degree+1, level+1, N]
    scale: float

    @property
    def level(self) -> int:
        return self.data.shape[1] - 1

    @property
    def degree(self) -> int:
        return self.data.shape[0] - 1

    @property
    def n(self) -> int:
        return self.data.shape[2]


@dataclass
class Plaintext:
    """Dense plaintext: int32 [level+1, N] Montgomery eval domain."""
    data: torch.Tensor
    scale: float

    @property
    def level(self) -> int:
        return self.data.shape[0] - 1


@dataclass(frozen=True)
class ScalarPlaintext:
    """Slot-constant complex plaintext, stored symbolically (host side)."""
    value: complex
    scale: float
