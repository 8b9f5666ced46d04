"""The bit-sliced flagship, `aesfhe_tpu_torch.pipeline.AESFHE128Bitsliced`,
as the system under test: a request runs a whole cipher through the
program's own round entry, `run_full_aes.run_round`, from the uniform work
level.  Set-up is the program's own, `run_full_aes.setup`.

    refresh.bootstrap   "fused": the pair-packed refresh replays the fused
                        bootstrap's CUDA graph; "none": no bootstrap key
                        (a cipher of one round)
"""
from __future__ import annotations

import numpy as np
import torch

from aesfhe_tpu_torch import run_full_aes
from aesfhe_tpu_torch.ops.bitplane import BitState
from aesfhe_tpu_torch.ops.xor_service import EngineWrapper, XORConfig
from aesfhe_tpu_torch.pipeline import AESFHE128Bitsliced
from aesfhe_tpu_torch.run_full_aes import run_round

# the class whose instances capture and replay CUDA graphs
GRAPH_OWNER = ("aesfhe_tpu_torch.bootstrap", "FusedBootstrap")


class System:
    def __init__(self, config: dict, mix: dict, rng: np.random.Generator,
                 device: str):
        if mix["direction"] != "encrypt":
            raise ValueError("the bit-sliced cells run the forward cipher")
        boot = config["refresh"]["bootstrap"]
        if boot not in ("fused", "none") or mix["refresh"] != (boot ==
                                                               "fused"):
            raise ValueError(f"the bit-sliced cells refresh with the fused "
                             f"bootstrap or run without one; configured "
                             f"{boot!r}, the mix's refresh {mix['refresh']}")
        key = bytes.fromhex(config["aes_key"])
        if boot == "fused":
            if key != run_full_aes.FIPS_KEY:
                raise ValueError("run_full_aes.setup takes the FIPS-197 key")
            # np.random.default_rng hands the generator back unchanged
            self.aes, _ = run_full_aes.setup(config["profile"], rng, device)
        else:
            wrap = EngineWrapper(
                XORConfig(profile=config["profile"], rotation_steps=(),
                          device=device, use_bootstrap=False), rng=rng)
            self.aes = AESFHE128Bitsliced(wrap, key, refresh=None)
        self.wrap = self.aes.eng
        self.rounds = mix["rounds_per_cipher"]
        self.params = self.wrap.engine.params

    def encrypt(self, data: np.ndarray) -> BitState:
        """Eight plane ciphertexts at the work level, as run_full_aes."""
        eng = self.wrap.engine
        st = self.aes.encrypt_state(data)
        return BitState([eng._drop(b, self.aes.ROUND_DEPTH + 1)
                         for b in st.bits])

    def run(self, st: BitState) -> BitState:
        for r in range(1, self.rounds + 1):
            st = run_round(self.aes, st, r, self.rounds)
        return st

    def decrypt(self, st: BitState) -> np.ndarray:
        return self.aes.decrypt_state(st)

    def counters(self) -> dict:
        return dict(self.wrap.engine.counters)

    def time_refresh(self, timed):
        """Put `timed(fn)` around the refresh callable, the wrapper's
        bootstrap, which the pair-packed refresh calls four times."""
        self.wrap.bootstrap = timed(self.wrap.bootstrap)
        if self.aes.refresh is not None:
            self.aes.refresh = self.wrap.bootstrap

    def sync(self):
        if self.wrap.engine.device.type == "cuda":
            torch.cuda.synchronize(self.wrap.engine.device)
