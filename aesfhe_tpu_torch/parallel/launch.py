"""Start D ranks on this host: one fresh process each (`spawn`, so a rank
may touch CUDA), in one process group over a fresh file rendezvous (no
port to collide with other runs).

    results = spawn(fn, world, *args, backend="gloo")

runs fn(rank, world, *args) in every rank and returns their return values
in rank order.  `fn` must be importable (a module-level function).  A rank
that raises fails the call with its traceback; a run past `timeout_s` is
killed and raises TimeoutError.  Every process it starts has ended when it
returns.
"""
from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, backend, tmp):
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        if backend == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str = "gloo",
          timeout_s: float = 600.0) -> list:
    with tempfile.TemporaryDirectory(prefix="aesfhe_ranks_") as tmp:
        # the arguments go through a file: a start payload larger than a
        # pipe's buffer would hold each start until the child has imported
        # its modules, so the ranks would start one after another
        torch.save(args, os.path.join(tmp, "args.pt"))
        ctx = mp.start_processes(_entry, args=(fn, world, backend, tmp),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                       f"past {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
