"""The zeta nibble-pair pipeline, `aesfhe_tpu_torch.pipeline.AESFHE128`,
as the system under test: a request is one call of its own entry,
`encrypt_rounds(pair, rounds)` or `decrypt_rounds(pair, rounds)`, on a
fresh pair.  Set-up is the program's own, `zeta_trace.setup`: the keys
hold the direct Galois keys of the merged ShiftRows+MixColumns, both ways,
beside the bootstrap's.

    refresh.bootstrap           "eager" (the only one the zeta schedule runs)
    refresh.segment             refreshes between the LUT stages
    refresh.post_boot_cleanses  cleanses after each bootstrap
"""
from __future__ import annotations

import numpy as np
import torch

from aesfhe_tpu_torch import zeta_trace
from aesfhe_tpu_torch.ops.mixcolumns_service import NibblePair
from aesfhe_tpu_torch.pipeline import AESFHE128


class System:
    def __init__(self, config: dict, mix: dict, rng: np.random.Generator,
                 device: str):
        refresh = config["refresh"]
        if refresh["bootstrap"] != "eager":
            raise ValueError("the zeta schedule runs the eager bootstrap")
        # np.random.default_rng hands the generator back unchanged
        wrap, (xs, tf, sr), _ = zeta_trace.setup(config["profile"], rng,
                                                 device, bootstrap=True)
        self.wrap = wrap
        self.aes = AESFHE128(wrap, xs, tf, sr,
                             bytes.fromhex(config["aes_key"]),
                             refresh=wrap.bootstrap if mix["refresh"]
                             else None)
        if mix["refresh"]:
            self.aes.segment_refresh = refresh["segment"]
            self.aes.post_boot_cleanses = refresh["post_boot_cleanses"]
        self.direction = mix["direction"]
        self.rounds = mix["rounds_per_cipher"]
        self.params = wrap.engine.params

    def encrypt(self, data: np.ndarray) -> NibblePair:
        return self.aes.encrypt_state(data)

    def run(self, pair: NibblePair) -> NibblePair:
        if self.direction == "encrypt":
            return self.aes.encrypt_rounds(pair, rounds=self.rounds)
        return self.aes.decrypt_rounds(pair, rounds=self.rounds)

    def decrypt(self, pair: NibblePair) -> np.ndarray:
        return self.aes.decrypt_state(pair)

    def counters(self) -> dict:
        return dict(self.wrap.engine.counters)

    def time_refresh(self, timed):
        """Put `timed(fn)` around the refresh callable: the pipeline's and
        the XOR service's own (below its bootstrap level) are one, the
        wrapper's bootstrap."""
        self.wrap.bootstrap = timed(self.wrap.bootstrap)
        if self.aes.refresh is not None:
            self.aes.refresh = self.wrap.bootstrap

    def sync(self):
        if self.wrap.engine.device.type == "cuda":
            torch.cuda.synchronize(self.wrap.engine.device)
