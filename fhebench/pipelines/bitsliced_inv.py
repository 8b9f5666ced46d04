"""The bit-sliced inverse cipher, `aesfhe_tpu_torch.pipeline.
AESFHE128Bitsliced.decrypt_round`, as the system under test: the forward
adapter (`bitsliced.py`: the program's own set-up, encryption at the work
level, decryption, counters) with a request that decrypts a whole batch of
AES ciphertexts through the program's own inverse round entry,
`run_full_aes.run_inverse_round` (the equivalent inverse cipher, one
cleanse a round, a pair-packed refresh before every round after the
first).  `refresh.bootstrap` as in `bitsliced.py`.
"""
from __future__ import annotations

import numpy as np

from aesfhe_tpu_torch.ops.bitplane import BitState
from aesfhe_tpu_torch.run_full_aes import run_inverse_round
from fhebench.pipelines import bitsliced

GRAPH_OWNER = bitsliced.GRAPH_OWNER


class System(bitsliced.System):
    def __init__(self, config: dict, mix: dict, rng: np.random.Generator,
                 device: str):
        if mix["direction"] != "decrypt":
            raise ValueError("the bit-sliced inverse cells run the inverse "
                             "cipher")
        if not mix["refresh"] and mix["rounds_per_cipher"] != 1:
            raise ValueError("without a bootstrap a cipher has one round")
        super().__init__(config, {**mix, "direction": "encrypt"}, rng,
                         device)

    def run(self, st: BitState) -> BitState:
        for i in range(1, self.rounds + 1):
            st = run_inverse_round(self.aes, st, i, self.rounds)
        return st
