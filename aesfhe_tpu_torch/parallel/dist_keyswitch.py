"""Digit-sharded hybrid key-switch over the "limb" axis of a mesh, with one
all-reduce.  Counterpart of `aesfhe_tpu/parallel/dist_keyswitch.py`.

The hybrid key-switch is a sum over digits of independent per-digit work:
basis-extend the digit, NTT it over the extended basis, multiply it with
that digit's key column.  Rank r of D keeps only digits [r*pad/D,
(r+1)*pad/D) of every switch key (pad = dnum rounded up to a multiple of
D, the padded digits zero), decomposes only its own digits
(`ops_impl.ks_decompose(j0, j1)`), runs the `ks_inner` CUDA kernel on them
(J = pad/D) and adds its partial product [2, M, N] into the others' with
one all-reduce.  The partials are canonical residues < 2^31, so the sum is
exact in int64 for any D < 2^32 (an int32 sum would overflow); it is
reduced mod q and only then mod-downed (`_mod_down_specials`, replicated on
every rank: its float32 v-hat estimate is not linear, so it must not run on
the partials).  Modular addition is exact in any order, so every result is
bit-identical to the single-device key-switch.

The surface is the engine's four routing hooks:

  relin(data, key)                 degree-2 relinearization
  galois(data, perm, key)          automorphism + switch back
  decompose(c1)                    this rank's digits of the shared
                                   decomposition of a hoisted batch
  hoisted_apply(data, d, perm, k)  one rotation from that decomposition

Keys are sharded once (`shard`, or on first use, cached per key object);
before a key's first use the ranks all-gather a fingerprint of it and raise
if they hold different keys.  `levels` counts the switches per level.
"""
from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core import ops_impl, rns
from ..core.keys import SwitchKey
from .comm import Comm
from .mesh import axis_rank, axis_size, digit_pad, key_shard


@dataclass
class KeyShard:
    """One rank's digits [pad/D, rows, N] of a switch key.  Deliberately
    without `b`/`a`: a single-device engine cannot take it by mistake."""
    kb: torch.Tensor
    ka: torch.Tensor
    cap: int | None
    digits: tuple[int, int]


def key_fingerprint(key: SwitchKey) -> bytes:
    """16 bytes that differ between different keys: a hash of each digit
    row's coefficient sum (computed on the key's device)."""
    h = hashlib.sha256()
    for t in (key.b, key.a):
        h.update(t.long().sum(dim=-1).cpu().numpy().tobytes())
    return h.digest()[:16]


class DistKeySwitch:
    def __init__(self, params, tabs, mesh: DeviceMesh, axis: str = "limb"):
        self.params = params
        self.tabs = tabs
        self.mesh = mesh
        self.axis = axis
        self.D = axis_size(mesh, axis)
        self.rank = axis_rank(mesh, axis)
        self.comm = Comm(mesh.get_group(axis), tabs.device)
        # one global digit pad for every level, so a key is sharded once
        self.pad = digit_pad(params.dnum, self.D)
        per = self.pad // self.D
        self.digits = (self.rank * per, (self.rank + 1) * per)
        self._key_cache: dict[int, tuple] = {}
        self.levels: Counter = Counter()

    # -- digit-sharded key residency ----------------------------------------
    def shard(self, key) -> KeyShard:
        """This rank's digits of `key` (a copy), after checking that every
        rank of the axis holds the same key."""
        if isinstance(key, KeyShard):
            if key.digits != self.digits:
                raise ValueError(f"key shard of digits {key.digits}, this "
                                 f"rank owns {self.digits}")
            return key
        if key.b.shape[0] > self.pad:
            raise ValueError(f"key has {key.b.shape[0]} digits, the mesh "
                             f"pads to {self.pad}")
        fp = torch.frombuffer(bytearray(key_fingerprint(key)),
                              dtype=torch.uint8).to(torch.int64)
        every = self.comm.all_gather(fp.to(self.tabs.device)).cpu()
        if not bool((every == fp).all()):
            raise RuntimeError("ranks of the mesh hold different switch keys "
                               "(keys must come from the same seed)")
        return KeyShard(key_shard(self.mesh, key.b, self.axis, self.pad),
                        key_shard(self.mesh, key.a, self.axis, self.pad),
                        key.cap, self.digits)

    def key_shards(self, key):
        """(kb, ka) of this rank's digits: a KeyShard's own, or a full key's,
        sharded on first use and cached (with a strong reference, so the
        key's id cannot be reused)."""
        if isinstance(key, KeyShard):
            return key.kb, key.ka
        ent = self._key_cache.get(id(key))
        if ent is None:
            ent = (key, self.shard(key))
            self._key_cache[id(key)] = ent
        return ent[1].kb, ent[1].ka

    # -- the collective pieces ----------------------------------------------
    def _reduce(self, d_local, key, level: int):
        """Partial inner product of this rank's digits, one int64
        all-reduce, mod q (canonical, so narrowed to int32), then the
        mod-down: int32 [2, l+1, N]."""
        kb, ka = self.key_shards(key)
        tr_b = self.tabs.rows(ops_impl._rows(self.params, level, True))
        part = ops_impl._ks_inner(
            d_local, kb, ka, ops_impl._key_rows(self.params, level, key.cap),
            tr_b)
        acc = self.comm.all_reduce(part.long())
        acc %= tr_b.q.reshape(1, -1, 1)
        self.levels[level] += 1
        return ops_impl._mod_down_specials(self.params, self.tabs,
                                           acc.to(torch.int32), level)

    def decompose(self, c_eval):
        """This rank's digits [pad/D, M, N] of c's decomposition."""
        return ops_impl.ks_decompose(self.params, self.tabs, c_eval,
                                     *self.digits)

    def keyswitch(self, c_eval, key):
        """(b, a) int32 [l+1, N] each, as ops_impl.keyswitch."""
        level = c_eval.shape[0] - 1
        ba = self._reduce(self.decompose(c_eval), key, level)
        return ba[0], ba[1]

    def _q(self, data):
        return ops_impl._q_tr(self.params, self.tabs,
                              data.shape[1] - 1).q.reshape(-1, 1)

    def relin(self, data, key):
        """Degree-2 data [3, l+1, N] -> [2, l+1, N]."""
        b, a = self.keyswitch(data[2], key)
        q = self._q(data)
        return torch.stack([rns.add_mod(data[0].long(), b.long(), q),
                            rns.add_mod(data[1].long(), a.long(), q)]).int()

    def galois(self, data, perm, key):
        """Automorphism `perm` of degree-1 data, switched back under s."""
        p0 = data[0][..., perm]
        b, a = self.keyswitch(data[1][..., perm], key)
        return torch.stack([rns.add_mod(p0.long(), b.long(),
                                        self._q(data)).int(), a])

    def hoisted_apply(self, data, d_local, perm, key):
        """One rotation of a hoisted batch from this rank's digits."""
        p0 = data[0][..., perm]
        level = data.shape[1] - 1
        ba = self._reduce(d_local[..., perm].contiguous(), key, level)
        return torch.stack([rns.add_mod(p0.long(), ba[0].long(),
                                        self._q(data)).int(), ba[1]])

