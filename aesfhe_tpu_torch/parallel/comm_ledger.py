"""Collective-communication ledger: counts and operand bytes per primitive.
Counterpart of `aesfhe_tpu/parallel/comm_ledger.py`.

The reference walks a traced jaxpr.  There is no program to walk here, so
the ledger reads what the collectives really issued: every collective of
the port goes through `parallel.comm.Comm`, which calls `record` with the
primitive's name and its operand bytes, and every ledger open at that
moment adds it.  `collective_stats(fn, *args)` runs `fn` and returns what
it issued, as the reference's function of that name returns what its
program would issue per execution.

Primitive names follow the reference's: "psum" (an all-reduce),
"all_to_all", "all_gather", "broadcast".  Bytes are the operand's, per
rank: an int64 all-reduce of a [2, M, N] partial product records
2*M*N*8 bytes, the same as the reference's psum of two uint32 halves.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

_open: list["CollectiveStats"] = []


@dataclass
class CollectiveStats:
    """counts[prim] = invocations; bytes_in[prim] = summed operand bytes;
    seconds[prim] = summed time of the collectives (see comm.Comm): a float,
    or a pair of CUDA events for a collective queued on the stream, which
    `seconds_of` reads once the device has passed them."""
    counts: dict = field(default_factory=dict)
    bytes_in: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)

    def add(self, prim: str, nbytes: int, seconds=None):
        self.counts[prim] = self.counts.get(prim, 0) + 1
        self.bytes_in[prim] = self.bytes_in.get(prim, 0) + nbytes
        if seconds is not None:
            self.seconds.setdefault(prim, []).append(seconds)

    def seconds_of(self, prim: str) -> float | None:
        """Summed seconds of `prim` (None if none was timed); waits for the
        device when events are pending."""
        got = self.seconds.get(prim)
        if got is None:
            return None
        total = 0.0
        for t in got:
            if isinstance(t, tuple):
                t[1].synchronize()
                t = t[0].elapsed_time(t[1]) / 1e3
            total += t
        return total

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_in.values())

    def as_dict(self) -> dict:
        return {"counts": dict(self.counts),
                "bytes": dict(self.bytes_in),
                "seconds": {k: self.seconds_of(k) for k in self.seconds},
                "total_bytes": self.total_bytes}


def record(prim: str, nbytes: int, seconds=None):
    """Called by the collective wrapper once per collective it issues."""
    for st in _open:
        st.add(prim, nbytes, seconds)


@contextlib.contextmanager
def recording():
    """Ledger of every collective issued inside the block."""
    st = CollectiveStats()
    _open.append(st)
    try:
        yield st
    finally:
        _open.remove(st)


def collective_stats(fn, *args, **kwargs) -> CollectiveStats:
    """Run fn(*args, **kwargs) and return the collectives it issued."""
    with recording() as st:
        fn(*args, **kwargs)
    return st


# -- wire-level conversions (per rank, standard ring algorithms) -----------

def allreduce_wire_bytes(operand_bytes: int, d: int) -> float:
    """Ring all-reduce: each rank sends 2*(D-1)/D of the operand."""
    return operand_bytes * 2 * (d - 1) / d


def alltoall_wire_bytes(global_bytes: int, d: int) -> float:
    """All-to-all over a D-sharded global array: each rank sends (D-1)/D of
    its 1/D shard; `global_bytes` is the unsharded logical array."""
    return global_bytes / d * (d - 1) / d
