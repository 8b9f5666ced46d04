"""Negacyclic NTT over RNS limbs in torch.

Counterpart of `aesfhe_tpu/core/ntt.py` (and of the `ops_impl.ntt_rows` /
`intt_rows` contract, which the reference also meets with its MXU 4-step
NTT): Cooley-Tukey with the psi-twist merged into the twiddles, natural
coefficient order in, bit-reversed evaluation order out; the inverse uses
Gentleman-Sande butterflies on bit-reversed input.  Output slot i holds the
evaluation at psi^(2*bitrev(i)+1), the order `params.galois_perm` indexes.

Data are int64 tensors holding Montgomery residues; twiddles are plain
constants, so a twiddle product (x*w mod q) keeps the Montgomery form.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rns


def bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


class NTTTables:
    """Per-prime twiddle tables (host numpy), indexed [L, N]: w[l, rev(j)] =
    psi_l^j (the Harvey/SEAL layout), wi likewise for psi_l^-1, ninv = N^-1.
    The Shoup companions are kept for parity with the reference's tables."""

    def __init__(self, n: int, primes: tuple[int, ...]):
        self.n = n
        self.primes = primes
        self.logn = n.bit_length() - 1
        L = len(primes)
        self.psi = []
        w = np.zeros((L, n), dtype=np.uint32)
        w_sh = np.zeros((L, n), dtype=np.uint32)
        wi = np.zeros((L, n), dtype=np.uint32)
        wi_sh = np.zeros((L, n), dtype=np.uint32)
        ninv = np.zeros((L,), dtype=np.uint32)
        ninv_sh = np.zeros((L,), dtype=np.uint32)
        rev = bit_reverse_perm(n)

        def pow_table(base: int, q: int) -> np.ndarray:
            """[1, base, ..., base^(n-1)] mod q by uint64 doubling."""
            out = np.ones(1, dtype=np.uint64)
            qq = np.uint64(q)
            while out.size < n:
                step = np.uint64(pow(base, out.size, q))
                out = np.concatenate([out, (out * step) % qq])
            return out[:n]

        for li, q in enumerate(primes):
            psi = rns.find_primitive_2n_root(q, 2 * n)
            self.psi.append(psi)
            w[li, rev] = pow_table(psi, q).astype(np.uint32)
            wi[li, rev] = pow_table(pow(psi, -1, q), q).astype(np.uint32)
            qq = np.uint64(q)
            w_sh[li] = ((w[li].astype(np.uint64) << np.uint64(32)) // qq
                        ).astype(np.uint32)
            wi_sh[li] = ((wi[li].astype(np.uint64) << np.uint64(32)) // qq
                         ).astype(np.uint32)
            ni = pow(n, -1, q)
            ninv[li] = ni
            ninv_sh[li] = rns.shoup_precompute(ni, q)
        self.w = w
        self.w_sh = w_sh
        self.wi = wi
        self.wi_sh = wi_sh
        self.ninv = ninv
        self.ninv_sh = ninv_sh
        self.q = np.asarray(primes, dtype=np.uint32)


def ntt_fwd(x: torch.Tensor, w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT.

    x: int64 [..., L, N] (natural coefficient order); w: int64 [L, N];
    q: int64 [L].  Returns int64 [..., L, N] in bit-reversed eval order.
    Each stage writes u + w*v and u - w*v + q into one buffer and reduces
    it with a single remainder (every value stays below 3q)."""
    shape = x.shape
    n, L = shape[-1], shape[-2]
    qc = q.reshape(L, 1, 1)
    m = 1
    while m < n:
        t = n // (2 * m)
        xr = x.reshape(shape[:-1] + (m, 2, t))
        u, v = xr[..., 0, :], xr[..., 1, :]
        wv = v * w[:, m:2 * m].reshape(L, m, 1)
        wv.remainder_(qc)
        out = torch.empty_like(xr)
        torch.add(u, wv, out=out[..., 0, :])
        torch.sub(u, wv, out=out[..., 1, :])
        out[..., 1, :].add_(qc)
        out.remainder_(qc.unsqueeze(-1))
        x = out.reshape(shape)
        m *= 2
    return x


def ntt_inv(x: torch.Tensor, wi: torch.Tensor, q: torch.Tensor,
            ninv: torch.Tensor) -> torch.Tensor:
    """Inverse negacyclic NTT: bit-reversed eval order -> natural order.
    Each stage writes u + v and (u - v + q) * w, then one remainder."""
    shape = x.shape
    n, L = shape[-1], shape[-2]
    qc = q.reshape(L, 1, 1)
    t = 1
    m = n // 2
    while m >= 1:
        xr = x.reshape(shape[:-1] + (m, 2, t))
        u, v = xr[..., 0, :], xr[..., 1, :]
        out = torch.empty_like(xr)
        torch.add(u, v, out=out[..., 0, :])
        hi = out[..., 1, :]
        torch.sub(u, v, out=hi)
        hi.add_(qc)
        hi.mul_(wi[:, m:2 * m].reshape(L, m, 1))
        out.remainder_(qc.unsqueeze(-1))
        x = out.reshape(shape)
        t *= 2
        m //= 2
    return rns.shoup_mul(x, ninv.reshape(L, 1), q.reshape(L, 1))
