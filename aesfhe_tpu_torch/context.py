"""EngineContext: key ownership + ergonomic encrypt/decrypt.  Counterpart
of `aesfhe_tpu/context.py`, the device mesh and the on-disk key cache
included.
"""
from __future__ import annotations

import dataclasses
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
    shares its Galois key set.

    `mesh` (a `torch.distributed` DeviceMesh, `parallel.mesh.make_mesh`)
    makes the engine a `parallel.mesh_engine.MeshEngine`: every key-switch
    runs digit-sharded over the `mesh_axis` ranks, and each rank keeps only
    its digit shard of every switch key.  Every rank must build the context
    from the same seed.

    `key_cache` (a directory) loads the key family and the bootstrap's
    Galois keys from disk, generating and saving them on first use
    (`utils.serialization.cached_key_family`/`cached_bootstrap_key`; the
    secret key touches the disk, so it is the caller's explicit choice, as
    the reference's AESFHE_KEY_CACHE is)."""

    def __init__(self, *, params: CKKSParams | None = None,
                 profile: str | None = None, device="cuda",
                 rng: np.random.Generator | None = None,
                 rotation_steps: Sequence[int] | None = None,
                 use_bootstrap: bool = False, mesh=None,
                 mesh_axis: str = "limb", key_cache=None):
        if mesh is None:
            self.engine = Engine(params, profile=profile, device=device,
                                 rng=rng)
        else:
            from .parallel.mesh_engine import MeshEngine
            self.engine = MeshEngine(params, mesh=mesh, axis=mesh_axis,
                                     profile=profile, device=device, rng=rng)
        eng = self.engine
        if key_cache:
            from .utils.serialization import cached_key_family
            fam = cached_key_family(eng, key_cache,
                                    rotation_steps=rotation_steps)
            self.secret_key = fam["secret"]
            self.public_key = fam["public"]
            self.relinearization_key = fam["relin"]
            self.conjugation_key = fam["conj"]
            self.rotation_key = fam["rotation"]
        else:
            self.secret_key = eng.create_secret_key()
            self.public_key = eng.create_public_key(self.secret_key)
            self.relinearization_key = eng.create_relinearization_key(
                self.secret_key)
            self.conjugation_key = eng.create_conjugation_key(
                self.secret_key)
            if rotation_steps is None:
                self.rotation_key = eng.create_rotation_key(self.secret_key)
            elif rotation_steps:
                self.rotation_key = eng.create_fixed_rotation_key(
                    self.secret_key, list(rotation_steps))
            else:
                self.rotation_key = GaloisKeySet(keys={})
        self.bootstrap_key = self.small_bootstrap_key = None
        if use_bootstrap:
            if key_cache:
                from .utils.serialization import cached_bootstrap_key
                self.bootstrap_key = cached_bootstrap_key(
                    eng, self.secret_key, key_cache)
            else:
                self.bootstrap_key = eng.create_bootstrap_key(
                    self.secret_key)
            self.small_bootstrap_key = eng.create_small_bootstrap_key(
                self.secret_key, rot=self.bootstrap_key.rot)
        if mesh is not None:
            self._adopt_keys()

    @classmethod
    def from_keys(cls, engine: Engine, *, secret, public, relin, conj,
                  rotation, bootstrap=None,
                  small_bootstrap=None) -> "EngineContext":
        """A context over keys made elsewhere (e.g. carried across from the
        reference by interop.py); a mesh engine keeps its digit shards."""
        ctx = cls.__new__(cls)
        ctx.engine = engine
        ctx.secret_key = secret
        ctx.public_key = public
        ctx.relinearization_key = relin
        ctx.conjugation_key = conj
        ctx.rotation_key = rotation
        ctx.bootstrap_key = bootstrap
        ctx.small_bootstrap_key = small_bootstrap
        if getattr(engine, "mesh", None) is not None:
            ctx._adopt_keys()
        return ctx

    def on_mesh(self, mesh, mesh_axis: str = "limb") -> "EngineContext":
        """The same keys on a MeshEngine over `mesh` (same params, device
        and generator); this context keeps its full keys.  Every rank of
        the mesh must call it with the same keys."""
        from .parallel.mesh_engine import MeshEngine
        e = self.engine
        meng = MeshEngine(e.params, mesh=mesh, axis=mesh_axis,
                          device=e.device, rng=e.rng)
        return EngineContext.from_keys(
            meng, secret=self.secret_key, public=self.public_key,
            relin=self.relinearization_key, conj=self.conjugation_key,
            rotation=self.rotation_key, bootstrap=self.bootstrap_key,
            small_bootstrap=self.small_bootstrap_key)

    def _adopt_keys(self):
        """Hold every switch key as the engine keeps it (a mesh rank: its
        digit shard), each key object once; key sets and bootstrap keys
        are new objects, so a context this one was made from keeps its
        own."""
        seen: dict[int, object] = {}

        def own(k):
            if id(k) not in seen:
                seen[id(k)] = self.engine.adopt_key(k)
            return seen[id(k)]

        def own_set(s):
            return GaloisKeySet(keys={g: own(k) for g, k in s.keys.items()})

        self.relinearization_key = own(self.relinearization_key)
        self.conjugation_key = own(self.conjugation_key)
        self.rotation_key = own_set(self.rotation_key)
        rots: dict[int, GaloisKeySet] = {}
        for name in ("bootstrap_key", "small_bootstrap_key"):
            bk = getattr(self, name)
            if bk is not None and bk.rot is not None:
                rot = rots.setdefault(id(bk.rot), own_set(bk.rot))
                setattr(self, name, dataclasses.replace(bk, rot=rot))

    def encrypt(self, data):
        return self.engine.encrypt(data, self.public_key)

    def decrypt(self, ct) -> np.ndarray:
        return self.engine.decrypt(ct, self.secret_key)
