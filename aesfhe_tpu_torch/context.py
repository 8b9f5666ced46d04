"""EngineContext: key ownership + ergonomic encrypt/decrypt.  Counterpart
of `aesfhe_tpu/context.py` without the device mesh.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .core.engine import Engine
from .core.keys import GaloisKeySet
from .core.params import CKKSParams


class EngineContext:
    """Builds an Engine on `device` and generates the key family from `rng`.

    `rotation_steps=None` generates the power-of-two rotation ladder; a
    sequence (possibly empty) generates only those steps, and services add
    the steps they need through EngineWrapper.ensure_rotation_steps.
    `use_bootstrap` also generates the bootstrap key (its Galois keys
    last, as the reference draws them) and the small flavor's key, which
    shares its Galois key set."""

    def __init__(self, *, params: CKKSParams | None = None,
                 profile: str | None = None, device="cuda",
                 rng: np.random.Generator | None = None,
                 rotation_steps: Sequence[int] | None = None,
                 use_bootstrap: bool = False):
        self.engine = Engine(params, profile=profile, device=device, rng=rng)
        eng = self.engine
        self.secret_key = eng.create_secret_key()
        self.public_key = eng.create_public_key(self.secret_key)
        self.relinearization_key = eng.create_relinearization_key(
            self.secret_key)
        self.conjugation_key = eng.create_conjugation_key(self.secret_key)
        if rotation_steps is None:
            self.rotation_key = eng.create_rotation_key(self.secret_key)
        elif rotation_steps:
            self.rotation_key = eng.create_fixed_rotation_key(
                self.secret_key, list(rotation_steps))
        else:
            self.rotation_key = GaloisKeySet(keys={})
        self.bootstrap_key = self.small_bootstrap_key = None
        if use_bootstrap:
            self.bootstrap_key = eng.create_bootstrap_key(self.secret_key)
            self.small_bootstrap_key = eng.create_small_bootstrap_key(
                self.secret_key, rot=self.bootstrap_key.rot)

    @classmethod
    def from_keys(cls, engine: Engine, *, secret, public, relin, conj,
                  rotation) -> "EngineContext":
        """A context over keys made elsewhere (e.g. carried across from the
        reference by interop.py)."""
        ctx = cls.__new__(cls)
        ctx.engine = engine
        ctx.secret_key = secret
        ctx.public_key = public
        ctx.relinearization_key = relin
        ctx.conjugation_key = conj
        ctx.rotation_key = rotation
        ctx.bootstrap_key = ctx.small_bootstrap_key = None
        return ctx

    def encrypt(self, data):
        return self.engine.encrypt(data, self.public_key)

    def decrypt(self, ct) -> np.ndarray:
        return self.engine.decrypt(ct, self.secret_key)
