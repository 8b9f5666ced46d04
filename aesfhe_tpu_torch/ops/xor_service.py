"""XORConfig + EngineWrapper: the engine facade the services call.
Counterpart of the first half of `aesfhe_tpu/ops/xor_service.py`
(the zeta XOR service and its coefficient caches are not ported yet).
"""
from __future__ import annotations

import numpy as np

from ..context import EngineContext
from ..core import keys as keys_mod
from ..core.ciphertext import Ciphertext
from ..core.engine import Engine


class XORConfig:
    """Engine configuration: ring profile (or explicit params), device, the
    rotation keys generated up front (None -> power-of-two ladder; a
    sequence, possibly empty -> only those steps), and whether to generate
    the bootstrap key."""

    def __init__(self, profile: str | None = None, params=None,
                 rotation_steps=None, device="cuda",
                 use_bootstrap: bool = False):
        self.profile = profile
        self.params = params
        self.rotation_steps = rotation_steps
        self.device = device
        self.use_bootstrap = use_bootstrap


class EngineWrapper:
    """Ergonomic op facade over an EngineContext's engine and keys."""

    def __init__(self, config: XORConfig | None = None, *,
                 ctx: EngineContext | None = None,
                 rng: np.random.Generator | None = None):
        config = config or XORConfig()
        if ctx is None:
            ctx = EngineContext(params=config.params, profile=config.profile,
                                device=config.device, rng=rng,
                                rotation_steps=config.rotation_steps,
                                use_bootstrap=config.use_bootstrap)
        self.ctx = ctx
        self.engine: Engine = ctx.engine
        self.public_key = ctx.public_key
        self.secret_key = ctx.secret_key
        self.relin_key = ctx.relinearization_key
        self.conj_key = ctx.conjugation_key
        self.rot_key = ctx.rotation_key
        self.boot_key = ctx.bootstrap_key

    def encrypt(self, data, device: bool = False):
        return self.engine.encrypt(np.asarray(data), self.public_key,
                                   device=device)

    def decrypt(self, ct, device: bool = False) -> np.ndarray:
        return self.engine.decrypt(ct, self.secret_key, device=device)

    def encode(self, vec):
        return self.engine.encode(np.asarray(vec))

    def multiply(self, a, b, relin_key=None):
        if isinstance(a, Ciphertext) and isinstance(b, Ciphertext):
            return self.engine.multiply(a, b, relin_key or self.relin_key)
        return self.engine.multiply(a, b)

    def add(self, a, b):
        return self.engine.add(a, b)

    def add_plain(self, ct, val):
        return self.engine.add_plain(ct, val)

    def conjugate(self, ct):
        return self.engine.conjugate(ct, self.conj_key)

    def multiply_plain(self, ct, val):
        return self.engine.multiply_plain(ct, val)

    def rotate(self, ct, steps: int):
        return self.engine.rotate(ct, self.rot_key, steps)

    def bootstrap(self, ct, phases: list | None = None):
        """Refresh `ct` with the context's bootstrap key (eager path)."""
        return self.engine.bootstrap(ct, self.relin_key, self.conj_key,
                                     self.boot_key, phases=phases)

    def relinearize(self, ct, relin_key=None):
        # degree-2 only; a degree-1 input comes back unchanged
        try:
            return self.engine.relinearize(ct, relin_key or self.relin_key)
        except RuntimeError as e:
            if "should have 3 polynomials" in str(e):
                return ct
            raise

    def ensure_rotation_steps(self, steps):
        """Generate direct full-level Galois keys for any `steps` missing
        from the rotation key set (hoisted rotations need direct keys).  A
        present level-capped key is regenerated."""
        params = self.engine.params
        sc = params.slot_count

        def _insufficient(g: int) -> bool:
            k = self.rot_key.keys.get(g)
            return k is None or k.cap is not None

        missing = [s % sc for s in steps
                   if s % sc and _insufficient(params.rot_galois_elt(s % sc))]
        if missing:
            fixed = keys_mod.gen_rotation_keys(params, self.engine.tabs,
                                               self.secret_key,
                                               self.engine.rng,
                                               sorted(set(missing)))
            self.rot_key.keys.update(fixed.keys)

    def linear_combination(self, cts, coeffs, constant=0.0,
                           target_scale=None):
        return self.engine.linear_combination(cts, coeffs, constant,
                                              target_scale=target_scale)

    def inner_product(self, lhs, rhs):
        return self.engine.inner_product(lhs, rhs, self.relin_key)
