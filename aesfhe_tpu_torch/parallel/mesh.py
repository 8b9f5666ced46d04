"""The device mesh and what each rank holds of it.  Counterpart of
`aesfhe_tpu/parallel/mesh.py`.

The reference names two axes on a `jax.sharding.Mesh`: "data" (independent
ciphertexts, slot-batch parallelism) and "limb" (the key-switch's digits).
Here a mesh is a `torch.distributed` DeviceMesh with the same axis names,
one process per rank, and a rank holds its own block of a sharded tensor:

  ct_shard    a [B, k, L, N] stack's batch block over "data" (the
              reference's P("data", None, "limb", None)); the port keeps
              limbs whole on every rank and shards the key-switch's digits
  key_shard   a switch key's digit block over "limb", zero-padded to a
              digit count the axis divides (what DistKeySwitch keeps)
  replicated  the same tensor on every rank, broadcast from the axis's
              first rank

The process group must exist first: `launch.spawn` (ranks on one host),
`multihost.init_multihost` (torchrun) or the caller's own
`init_process_group`.  A rank that drives a card sets its device first
(one rank per card over NCCL, or several ranks sharing one card over gloo).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .comm import Comm

AXES = ("data", "limb")


def make_mesh(data: int = 1, limb: int = 1,
              device_type: str = "cpu") -> DeviceMesh:
    """A (data, limb) mesh over every rank of the default process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(parallel.launch.spawn, multihost.init_multihost)")
    world = dist.get_world_size()
    if world != data * limb:
        raise ValueError(f"make_mesh: data={data} x limb={limb} needs "
                         f"{data * limb} ranks, the group has {world}")
    if device_type == "cuda":
        # the launcher's LOCAL_RANK, else one card per rank round robin
        # (ranks beyond the card count share cards, over gloo)
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(device_type, (data, limb), mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def block(x: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    """Block `index` of `parts` equal blocks of x along dim (a view)."""
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"{n} along dim {dim} does not split into {parts}")
    return x.narrow(dim, index * (n // parts), n // parts)


def ct_shard(mesh: DeviceMesh, stack: torch.Tensor) -> torch.Tensor:
    """This rank's batch block of a [B, k, L, N] ciphertext stack."""
    return block(stack, 0, axis_rank(mesh, "data"), axis_size(mesh, "data"))


def digit_pad(dnum: int, d: int) -> int:
    """The digit count a key is padded to: the least multiple of d."""
    return -(-dnum // d) * d


def key_shard(mesh: DeviceMesh, key: torch.Tensor, axis: str = "limb",
              pad: int | None = None) -> torch.Tensor:
    """This rank's digit block [pad/D, rows, N] of a [dnum, rows, N] key,
    a copy (so the full key can be freed); digits past dnum are zero.
    `pad` defaults to dnum rounded up to a multiple of D."""
    d = axis_size(mesh, axis)
    pad = digit_pad(key.shape[0], d) if pad is None else pad
    if pad % d or pad < key.shape[0]:
        raise ValueError(f"cannot pad {key.shape[0]} digits to {pad} over "
                         f"{d} ranks")
    per = pad // d
    j0 = axis_rank(mesh, axis) * per
    out = torch.zeros((per,) + tuple(key.shape[1:]), dtype=key.dtype,
                      device=key.device)
    live = max(0, min(key.shape[0] - j0, per))
    if live:
        out[:live] = key[j0:j0 + live]
    return out


def replicated(mesh: DeviceMesh, x: torch.Tensor,
               axis: str = "limb") -> torch.Tensor:
    """x as the axis's first rank holds it, on every rank of the axis."""
    return Comm(mesh.get_group(axis), x.device).broadcast(x.contiguous())
