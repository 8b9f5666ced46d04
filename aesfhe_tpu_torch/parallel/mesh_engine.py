"""MeshEngine: the whole Engine API with every key-switch digit-sharded
over the "limb" axis of a mesh.  Counterpart of
`aesfhe_tpu/parallel/mesh_engine.py`.

It overrides the engine's four key-switch routing hooks (`_relin_data`,
`_galois_data`, `_hoist_decompose`, `_hoist_apply`) with
`DistKeySwitch`'s, so multiply, relinearize, rotate, conjugate, the hoisted
rotations, the power basis, inner products and the bootstrap all run
distributed with no change to a circuit, bit-identical to the
single-device Engine.  Everything else (elementwise ops, rescales,
encoding) runs replicated on every rank.  Each rank holds 1/D of every
switch key: `adopt_key` turns a full key into this rank's digit shard.

    mesh = parallel.mesh.make_mesh(data=1, limb=D, device_type="cuda")
    eng = MeshEngine(params, mesh=mesh, device="cuda", rng=rng)
    ctx = EngineContext(params=params, mesh=mesh, rng=rng)   # or this
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from ..core.engine import Engine
from ..core.params import CKKSParams
from .dist_keyswitch import DistKeySwitch


class MeshEngine(Engine):
    def __init__(self, params: CKKSParams | None = None, *, mesh: DeviceMesh,
                 axis: str = "limb", **kw):
        super().__init__(params, **kw)
        self.mesh = mesh
        self.axis = axis
        self.dks = DistKeySwitch(self.params, self.tabs, mesh, axis=axis)

    def adopt_key(self, key):
        return self.dks.shard(key)

    # -- key-switch routing hooks (collective overrides) -----------------
    def _relin_data(self, data, key):
        return self.dks.relin(data, key)

    def _galois_data(self, data, g: int, key):
        return self.dks.galois(data, self._perm_dev(g), key)

    def _hoist_decompose(self, c1):
        return self.dks.decompose(c1)

    def _hoist_apply(self, data, d_eval, g: int, key):
        return self.dks.hoisted_apply(data, d_eval, self._perm_dev(g), key)
