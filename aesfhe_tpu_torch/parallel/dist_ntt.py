"""Distributed 4-step negacyclic NTT: one transform with N split over the
"limb" axis of a mesh.  Counterpart of `aesfhe_tpu/parallel/dist_ntt.py`.

With A = sqrt(N) (log2 N even), n = n1 + A*n2 and output slot
i = A*i_a + i_b, the port's NTT (`core/ntt.py`: psi-twisted, bit-reversed
evaluation order, slot i = a(psi^(2*bitrev(i)+1))) factors as

  X[i_a, i_b] = sum_n1 psiA^(n1*(2*br(i_b)+1))
                * psi^(n1*(2*br(i_a)+1-A))
                * sum_n2 psiA^(n2*(2*br(i_a)+1)) Z[n2, n1]

where psiA = psi^A is a primitive 2A-th root and br reverses log2 A bits:
both inner transforms are the port's own size-A negacyclic NTT, bit-reversed
out, with root psiA, and a twiddle sits between them.  So:

  forward:  Z[n2, n1] column-sharded (rank r holds n1 in block r)
            stage 1  size-A NTT down each local column    (local)
            twiddle  * T[i_a, n1]                         (local)
            ALL-TO-ALL   [A, A/D] -> [A/D, A]  (rows i_a local)
            stage 2  size-A NTT along each local row      (local)
            result row-sharded: Out[i_a, i_b]

  inverse runs the same shape backwards (size-A inverse NTTs, the inverse
  twiddle, one all-to-all), so inv(fwd(x)) round-trips the sharding with
  two all-to-alls.  Every step is exact modular arithmetic, so the output
  is residue for residue the port's `ntt.ntt_fwd`/`ntt_inv` output.

The reference's int8 MXU digit products are a TPU matmul technique and are
not ported: the local stages are the port's NTT arithmetic.  Data are int32
Montgomery residues as everywhere in the port; twiddles are plain
constants, so products keep the Montgomery form.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core import ntt
from .comm import Comm
from .mesh import axis_rank, axis_size, mesh_device


def _pow_table(base: int, q: int, n: int) -> np.ndarray:
    """[1, base, ..., base^(n-1)] mod q (uint64, exact: q < 2^31)."""
    out = np.ones(1, dtype=np.uint64)
    qq = np.uint64(q)
    while out.size < n:
        step = np.uint64(pow(base, int(out.size), q))
        out = np.concatenate([out, (out * step) % qq])
    return out[:n]


class DistNTT:
    """Sharded negacyclic NTT of the first `level + 1` q-primes (all of
    them by default) over `mesh` axis `axis`.

    fwd(x): x int32 [L, A, A/D], this rank's column block of Z
            (`pack`, then `mesh.block(.., 2, rank, D)`) -> int32
            [L, A/D, A], this rank's row block of Out (bit-reversed eval
            order; `unpack_eval` of the gathered rows is the port's NTT).
    inv(y): the exact inverse, row block in, column block out."""

    def __init__(self, params, mesh: DeviceMesh, axis: str = "limb",
                 level: int | None = None):
        n = params.n
        logn = n.bit_length() - 1
        if logn % 2:
            raise ValueError("the 4-step NTT needs an even log2(N)")
        A = 1 << (logn // 2)
        self.D = axis_size(mesh, axis)
        if A % self.D:
            raise ValueError(f"axis size {self.D} must divide sqrt(N)={A}")
        self.A = A
        self.rank = axis_rank(mesh, axis)
        self.device = mesh_device(mesh)
        self.comm = Comm(mesh.get_group(axis), self.device)
        nrows = params.num_q if level is None else level + 1
        C = A // self.D
        rev = ntt.bit_reverse_perm(A)
        cols = np.arange(self.rank * C, (self.rank + 1) * C)
        rows = cols                          # the row block has the same span
        w = np.zeros((nrows, A), dtype=np.int64)
        wi = np.zeros((nrows, A), dtype=np.int64)
        ninv = np.zeros(nrows, dtype=np.int64)
        tw = np.zeros((nrows, A, C), dtype=np.int64)
        twi = np.zeros((nrows, C, A), dtype=np.int64)
        for li in range(nrows):
            q = int(params.q_primes[li])
            psi = int(params.tables.psi[li])
            ppow = _pow_table(psi, q, 2 * n).astype(np.int64)
            psi_a = pow(psi, A, q)
            w[li, rev] = _pow_table(psi_a, q, A).astype(np.int64)
            wi[li, rev] = _pow_table(pow(psi_a, -1, q), q, A).astype(np.int64)
            ninv[li] = pow(A, -1, q)
            # T[i_a, n1] = psi^(n1 * (2*br(i_a) + 1 - A)), exponents mod 2N
            odd = 2 * rev.astype(np.int64) + 1 - A                   # [A]
            e = (odd[:, None] * cols[None, :]) % (2 * n)             # [A, C]
            tw[li] = ppow[e]
            e_inv = (-(odd[rows][:, None] * np.arange(A)[None, :])) % (2 * n)
            twi[li] = ppow[e_inv]
        dev = self.device
        self.q = torch.as_tensor(np.asarray(params.q_primes[:nrows],
                                            dtype=np.int64), device=dev)
        self.w = torch.as_tensor(w, device=dev)
        self.wi = torch.as_tensor(wi, device=dev)
        self.ninv = torch.as_tensor(ninv, device=dev)
        self.tw = torch.as_tensor(tw, device=dev)
        self.twi = torch.as_tensor(twi, device=dev)

    def _ntt_last(self, x, inverse: bool):
        """Size-A (inverse) NTT along the last axis of [L, R, A]."""
        y = x.permute(1, 0, 2).contiguous()                # [R, L, A]
        y = (ntt.ntt_inv(y, self.wi, self.q, self.ninv) if inverse
             else ntt.ntt_fwd(y, self.w, self.q))
        return y.permute(1, 0, 2)

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        L, A, C = x.shape
        qc = self.q.reshape(-1, 1, 1)
        s = self._ntt_last(x.long().transpose(1, 2), False)   # [L, C, A(i_a)]
        b = s.transpose(1, 2) * self.tw % qc                  # [L, A, C]
        R = A // self.D
        parts = b.reshape(L, self.D, R, C).transpose(0, 1)    # [D, L, R, C]
        # residues < 2^31 cross the wire as int32, as the reference's uint32
        got = self.comm.all_to_all(parts.int()).long()        # from each n1 block
        b = got.permute(1, 2, 0, 3).reshape(L, R, A)          # [L, R(i_a), n1]
        return self._ntt_last(b, False).int()

    def inv(self, y: torch.Tensor) -> torch.Tensor:
        L, R, A = y.shape
        qc = self.q.reshape(-1, 1, 1)
        b = self._ntt_last(y.long(), True) * self.twi % qc     # [L, R, n1]
        C = A // self.D
        parts = b.reshape(L, R, self.D, C).permute(2, 0, 1, 3)  # [D, L, R, C]
        got = self.comm.all_to_all(parts.int()).long()        # from each i_a block
        s = got.permute(1, 0, 2, 3).reshape(L, A, C)          # [L, i_a, C]
        z = self._ntt_last(s.transpose(1, 2), True)           # [L, C, n2]
        return z.transpose(1, 2).contiguous().int()

    # flat <-> blocked views -------------------------------------------------
    def pack(self, flat):
        """[L, N] natural order -> [L, A, A] Z[n2, n1] (n = n1 + A*n2)."""
        return flat.reshape(flat.shape[0], self.A, self.A)

    def unpack_eval(self, blocked):
        """[L, A, A] Out[i_a, i_b] -> [L, N] with i = A*i_a + i_b."""
        return blocked.reshape(blocked.shape[0], self.A * self.A)
