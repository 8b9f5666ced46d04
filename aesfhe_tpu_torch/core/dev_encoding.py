"""Device-side CKKS encode/decode: the canonical embedding in torch.
Counterpart of `aesfhe_tpu/core/dev_encoding.py`.

  encode:  slots --(gather)--> natural eval order --c64 FFT--> psi^-k twist
           --round to int32--> per-prime residues --Montgomery+NTT--> eval
  decode:  limb residues --exact 2-limb Garner--> centered f32 coefficients
           --c64 IFFT + psi^k twist--> (gather) slots

The FFT runs in complex64 (relative error ~1e-6 of the scale), so results
match the reference's by value, not bit for bit: torch's FFT rounds
differently from XLA's.  The Garner step is exact integer arithmetic.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import ops_impl, rns
from .params import CKKSParams


@functools.lru_cache(maxsize=None)
def _embed_maps(params: CKKSParams):
    """Gather maps between slot order and the natural (exponent 2j+1)
    evaluation order used by the FFT."""
    n = params.n
    pos = params.pos_of_exp[1::2]
    src = np.zeros(n, dtype=np.int64)
    conj = np.zeros(n, dtype=bool)
    inv_slot = {int(p): k for k, p in enumerate(params.slot_pos)}
    inv_conj = {int(p): k for k, p in enumerate(params.conj_slot_pos)}
    for j in range(n):
        p = int(pos[j])
        if p in inv_slot:
            src[j] = inv_slot[p]
        else:
            src[j] = inv_conj[p]
            conj[j] = True
    j_of_pos = {int(p): j for j, p in enumerate(pos)}
    slot_from_nat = np.asarray([j_of_pos[int(p)] for p in params.slot_pos],
                               dtype=np.int64)
    tw_inv = (params.psi_c_pow_inv / n).astype(np.complex64)
    tw_fwd = params.psi_c_pow.astype(np.complex64)
    return src, conj, slot_from_nat, tw_inv, tw_fwd


@functools.lru_cache(maxsize=None)
def _embed_maps_dev(params: CKKSParams, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _embed_maps(params))


def _encode_eval_dev(params, tabs, z: torch.Tensor, level: int, scale: float):
    """complex64 slots [slot_count] -> eval-domain Montgomery int32 [L, N]."""
    src, conjf, _, tw_inv, _ = _embed_maps_dev(params, tabs.device)
    natural = z[src]
    natural = torch.where(conjf, natural.conj().resolve_conj(), natural)
    p = torch.fft.fft(natural) * tw_inv
    c = torch.round(p.real * scale).to(torch.int32).to(torch.int64)
    tr = ops_impl._q_tr(params, tabs, level)
    q = tr.q.reshape(-1, 1)
    res = torch.remainder(c[None, :], q)
    return ops_impl.ntt_rows(res, tr, to_mont=True, out_dtype=torch.int32)


def encode_eval_dev(params, tabs, vec, level: int, scale: float):
    """Host-facing wrapper: pad and validate, upload once, encode."""
    sc = params.slot_count
    z = np.asarray(vec)
    if z.size < sc:
        z = np.pad(z, (0, sc - z.size))
    elif z.size > sc:
        raise ValueError(f"too many slots: {z.size} > {sc}")
    z = np.asarray(z, dtype=np.complex128)
    # beyond int32 the rounded f32 coefficients would wrap into wrong residues
    peak = float(np.max(np.abs(z))) * scale if z.size else 0.0
    if peak >= 2 ** 31:
        raise ValueError(
            f"encode overflow: max|slot| * scale = {peak:.3g} >= 2^31; "
            "reduce the input magnitude or the scale, or use the host "
            "encode path")
    zt = torch.as_tensor(z.astype(np.complex64), device=tabs.device)
    return _encode_eval_dev(params, tabs, zt, level, float(scale))


def _decode_slots_dev(params, residues: torch.Tensor, scale: float):
    """Coefficient residues int32 [L, N] (standard domain) -> float32 [2,
    slot_count] (real, imaginary).  L >= 2: exact two-limb Garner lift,
    centered before any float touches the value; L == 1: single-limb
    centering (needs |coeff| < q0/2)."""
    dev = residues.device
    _, _, slot_from_nat, _, tw_fwd = _embed_maps_dev(params, dev)
    q0 = int(params.q_primes[0])
    r0 = residues[0].long()
    if residues.shape[0] >= 2:
        q1 = int(params.q_primes[1])
        # q1 (a scale prime) can be far below q0: reduce r0 fully first
        d = rns.sub_mod(residues[1].long(), rns.barrett_reduce(r0, q1), q1)
        t = rns.shoup_mul(d, pow(q0, -1, q1), q1)
        t_c = torch.where(t > q1 // 2, t - q1, t).to(torch.float32)
        v = r0.to(torch.float32) + t_c * float(np.float32(q0))
    else:
        v = torch.where(r0 > q0 // 2, r0 - q0, r0).to(torch.float32)
    p = (v / scale).to(torch.complex64) * tw_fwd
    natural = torch.fft.ifft(p) * params.n
    z = natural[slot_from_nat]
    return torch.stack([z.real, z.imag])
