"""Multi-process, multi-host execution on torch.distributed.  Counterpart
of `aesfhe_tpu/parallel/multihost.py`.

Each process calls `init_multihost`, which joins one process group over
every process of every host; `global_mesh` is a one-axis mesh over all of
them.  The launcher is `torchrun` (its MASTER_ADDR / MASTER_PORT / RANK /
WORLD_SIZE / LOCAL_RANK), or explicit arguments.  A rank drives card
LOCAL_RANK over NCCL when every rank of its host has a card of its own,
else gloo; `--device cpu` runs the same path on host tensors over gloo.

The reference lifts host arrays to global jax.Arrays; here every process
holds the full host value and keeps its own block:

  sharded_global    this rank's block of a host array along a dim
  replicated_global the whole host array on this rank's device
  fetch_global      the blocks of every rank gathered back, as numpy

`multihost_ntt_check` runs the distributed 4-step NTT (dist_ntt) across
the process boundary and holds it to the single-process transform, bit
for bit (`python -m aesfhe_tpu_torch.run_multihost`).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .comm import Comm
from .mesh import axis_rank, axis_size, block, mesh_device


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device: str = "cuda",
                   backend: str | None = None) -> torch.device:
    """Join (or create) the process group; returns this rank's device.

    Arguments default to torchrun's MASTER_ADDR:MASTER_PORT, WORLD_SIZE and
    RANK; LOCAL_RANK (default: the rank modulo the host's cards) picks the
    card.  Backend: NCCL when every local rank has a card of its own, else
    gloo (several ranks sharing a card, or device="cpu")."""
    env = os.environ
    if coordinator is None:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu'")
        cards = torch.cuda.device_count()
        local = int(env.get("LOCAL_RANK", rank % cards))
        torch.cuda.set_device(local % cards)
        dev = torch.device("cuda", local % cards)
        local_world = int(env.get("LOCAL_WORLD_SIZE", min(world, cards)))
        if backend is None:
            backend = "nccl" if local_world <= cards else "gloo"
    backend = backend or "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return dev


def global_mesh(axis: str = "limb",
                device_type: str | None = None) -> DeviceMesh:
    """One-axis mesh over every rank of every process."""
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def replicated_global(mesh: DeviceMesh, host_value: np.ndarray,
                      device=None) -> torch.Tensor:
    """The host array (the same on every process) on this rank's device."""
    return torch.as_tensor(host_value, device=device or mesh_device(mesh))


def sharded_global(mesh: DeviceMesh, host_value: np.ndarray, dim: int,
                   axis: str = "limb", device=None) -> torch.Tensor:
    """This rank's block along `dim` of a host array every process holds in
    full; only that block is copied to the device."""
    part = block(torch.as_tensor(host_value), dim, axis_rank(mesh, axis),
                 axis_size(mesh, axis))
    return part.contiguous().to(device or mesh_device(mesh))


def fetch_global(local: torch.Tensor, mesh: DeviceMesh, dim: int,
                 axis: str = "limb") -> np.ndarray:
    """Every rank's block along `dim`, gathered onto every process."""
    every = Comm(mesh.get_group(axis), local.device).all_gather(local)
    return torch.cat(list(every.cpu()), dim=dim).numpy()


def multihost_ntt_check(profile: str = "tiny", axis: str = "limb",
                        seed: int = 3, device=None) -> dict:
    """Run the sharded 4-step NTT over the current global mesh (every
    process) and hold fwd to the single-process transform and inv(fwd(x))
    to x, bit for bit.  Returns a summary; raises on a mismatch.  Callable
    after init_multihost on every process."""
    from ..core import ops_impl
    from ..core.params import get_params
    from .dist_ntt import DistNTT

    params = get_params(profile)
    mesh = global_mesh(axis, None if device is None
                       else torch.device(device).type)
    dev = mesh_device(mesh)
    d = DistNTT(params, mesh, axis=axis)
    nrows = params.num_q
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, int(q), params.n, dtype=np.int64)
                  for q in params.q_primes[:nrows]]).astype(np.int32)
    tabs = ops_impl.DeviceTables(params, dev)
    tr = tabs.rows(np.arange(nrows))
    want = ops_impl.ntt_rows(torch.as_tensor(x, device=dev).long(),
                             tr).int().cpu().numpy()
    xs = sharded_global(mesh, d.pack(x), 2, axis, dev)
    y = d.fwd(xs)
    got = d.unpack_eval(fetch_global(y, mesh, 1, axis))
    if not np.array_equal(got, want):
        raise AssertionError("multihost sharded NTT fwd mismatch")
    back = fetch_global(d.inv(y), mesh, 2, axis).reshape(x.shape)
    if not np.array_equal(back, x):
        raise AssertionError("multihost sharded NTT roundtrip mismatch")
    return {"processes": dist.get_world_size(),
            "backend": str(dist.get_backend()),
            "collectives": d.comm.mode,
            "n": params.n, "limbs": int(nrows),
            "fwd_exact": True, "roundtrip_exact": True}
