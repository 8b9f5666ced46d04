"""The one wrapper every collective of the port goes through.

`Comm` issues collectives on one process group (a mesh axis) and records
each in the ledger (`comm_ledger.record`) with its operand bytes.  NCCL
takes CUDA tensors; gloo takes CPU tensors, and CUDA tensors only where the
installed gloo was built for them.  On a card over gloo (several ranks
sharing one card, where NCCL refuses) a probe at construction decides: if
gloo reduces, gathers and exchanges CUDA tensors, they go to it directly;
otherwise every collective copies through pinned host buffers, explicitly
(`mode` says which).  The probe's own collectives are not recorded.

The ledger also gets each collective's time.  Where it blocks the host
(gloo, or host tensors) that is the host wall around it, after waiting for
the device's queue (gloo would wait for it anyway before copying), so the
time is the collective's alone.  NCCL queues its collectives on the
stream: there a pair of CUDA events around it measures how long the stream
waited for it, peers included.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch
import torch.distributed as dist

from . import comm_ledger


class Comm:
    def __init__(self, group, device):
        self.group = group
        self.device = torch.device(device)
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.staged = (self.device.type == "cuda" and self.backend == "gloo"
                       and not self._gloo_takes_cuda())
        self._pinned: dict = {}

    @property
    def mode(self) -> str:
        if self.device.type != "cuda":
            return f"{self.backend}, host tensors"
        if self.staged:
            return f"{self.backend}, staged through pinned host buffers"
        return f"{self.backend}, CUDA tensors"

    def _gloo_takes_cuda(self) -> bool:
        """Whether this gloo runs all_reduce, all_gather and all_to_all on
        CUDA tensors; every rank must agree, so the verdict is reduced."""
        ok = True
        try:
            t = torch.ones(self.size, dtype=torch.int64, device=self.device)
            dist.all_reduce(t, group=self.group)
            o = torch.empty_like(t)
            dist.all_to_all_single(o, t, group=self.group)
            g = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(g, t, group=self.group)
            ok = bool((t == self.size).all()) and bool((o == self.size).all())
        except (RuntimeError, ValueError):
            ok = False
        flag = torch.tensor([int(ok)])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag.item())

    @contextmanager
    def _record(self, prim: str, t: torch.Tensor):
        if self.backend == "nccl":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            yield
            ev[1].record()
            comm_ledger.record(prim, t.numel() * t.element_size(), ev)
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        comm_ledger.record(prim, t.numel() * t.element_size(),
                           time.perf_counter() - t0)

    def _host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """A pinned host buffer of t's shape and dtype, reused per slot."""
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """In-place SUM over the group; returns t."""
        with self._record("psum", t):
            if not self.staged:
                dist.all_reduce(t, group=self.group)
                return t
            h = self._host(t, "reduce")
            h.copy_(t)
            dist.all_reduce(h, group=self.group)
            return t.copy_(h)

    def all_to_all(self, inp: torch.Tensor) -> torch.Tensor:
        """inp [size, ...]: block i goes to rank i; returns [size, ...] with
        block i from rank i."""
        inp = inp.contiguous()
        out = torch.empty_like(inp)
        with self._record("all_to_all", inp):
            if not self.staged:
                dist.all_to_all_single(out, inp, group=self.group)
                return out
            hi, ho = self._host(inp, "a2a_in"), self._host(out, "a2a_out")
            hi.copy_(inp)
            dist.all_to_all_single(ho, hi, group=self.group)
            return out.copy_(ho)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's t, in group rank order."""
        t = t.contiguous()
        with self._record("all_gather", t):
            src = self._host(t, "gather_in").copy_(t) if self.staged else t
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            return torch.stack(parts).to(self.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """In place: every rank gets group rank `src`'s t; returns t."""
        gsrc = dist.get_global_rank(self.group, src)
        with self._record("broadcast", t):
            if not self.staged:
                dist.broadcast(t, gsrc, group=self.group)
                return t
            h = self._host(t, "bcast").copy_(t)
            dist.broadcast(h, gsrc, group=self.group)
            return t.copy_(h)
