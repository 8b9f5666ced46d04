"""Slot-batch data parallelism: a stack of independent ciphertexts split
over the "data" axis of a mesh.  Counterpart of
`aesfhe_tpu/parallel/batch.py`.

The reference vmaps a circuit over a [B, k, L, N] stack and lets the
compiler partition the batch axis.  A circuit here tracks scales on the
host, so there is no vmap: each rank loops over its own block of the stack
(`mesh.ct_shard`) and the blocks are all-gathered back in batch order.
With a MeshEngine the circuit's key-switches shard over "limb" inside each
"data" group at the same time.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.ciphertext import Ciphertext
from .comm import Comm
from .mesh import ct_shard, mesh_device


def map_circuit(circuit: Callable, scale: float):
    """Lift a Ciphertext -> Ciphertext circuit to a [b, k, L, N] stack:
    returns fn(stack) -> (out stack [b, k', L', N], out scale)."""
    def run(stack: torch.Tensor, *consts):
        outs = [circuit(Ciphertext(stack[i], scale), *consts)
                for i in range(stack.shape[0])]
        if len({o.scale for o in outs}) != 1:
            raise ValueError("the circuit's output scale depends on its input")
        return torch.stack([o.data for o in outs]), outs[0].scale

    return run


def sharded_circuit(circuit: Callable, scale: float, mesh: DeviceMesh):
    """map_circuit over this rank's batch block of a [B, k, L, N] stack held
    on every rank; returns fn(stack) -> (the whole [B, k', L', N] output,
    gathered over "data", and its scale)."""
    local = map_circuit(circuit, scale)
    comm = Comm(mesh.get_group("data"), mesh_device(mesh))

    def run(stack: torch.Tensor, *consts):
        out, out_scale = local(ct_shard(mesh, stack), *consts)
        every = comm.all_gather(out)                    # [D, b, k', L', N]
        return every.reshape((-1,) + tuple(out.shape[1:])), out_scale

    return run
