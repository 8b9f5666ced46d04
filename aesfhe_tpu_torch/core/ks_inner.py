"""Key-switch digit inner product: the CUDA kernel's wrapper and its plain
torch version.  Counterpart of `aesfhe_tpu/core/pallas_ks.py` (the one TPU
kernel of the reference; kernel source and design note in
`aesfhe_tpu_torch/csrc/ks_inner.cu`).

    out[0, m] = sum_{j<J} mont_mul(d[j, m], key_b[j, rows_key[m]]) mod q_m
    out[1, m] = the same with key_a

d: int32 [J, M, N]; key_b/key_a: int32 [dnum, Mk, N] in their stored layout
(J <= dnum); rows_key: the physical key row of each logical limb
(`ops_impl._key_rows`), host ints; q/qinv: int32 [M] (qinv = -q^-1 mod 2^32
as uint32 bits).  Returns int32 [2, M, N].

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.  `launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from .rns import MASK32, add_mod

launches = 0

_rows_dev: dict = {}


def _redc(a, b, q, qinv):
    """The kernel's REDC on the 64-bit product, in int64 without overflow
    (canonical a, b < q <= 2^30): m = (t mod 2^32) * qinv mod 2^32 is
    assembled from 16-bit halves of qinv."""
    t = a * b
    tl = t & MASK32
    m = (tl * (qinv & 0xFFFF) + (((tl * (qinv >> 16)) & 0xFFFF) << 16)) & MASK32
    u = (t + m * q) >> 32
    return torch.where(u >= q, u - q, u)


def ks_inner_plain(d_eval, key_b, key_a, rows_key, q, qinv):
    """The kernel's arithmetic in plain torch (int64), any device."""
    J, M, _ = d_eval.shape
    rk = torch.as_tensor(np.asarray(rows_key, dtype=np.int64),
                         device=d_eval.device)
    qc = (q.to(torch.int64) & MASK32).reshape(M, 1)
    qi = (qinv.to(torch.int64) & MASK32).reshape(M, 1)
    out = []
    for key in (key_b, key_a):
        acc = None
        for j in range(J):
            t = _redc(d_eval[j].to(torch.int64),
                      key[j].index_select(0, rk).to(torch.int64), qc, qi)
            acc = t if acc is None else add_mod(acc, t, qc)
        out.append(acc)
    return torch.stack(out).to(torch.int32)


def _check(d_eval, key_b, key_a, rows_key, q, qinv):
    for name, t in (("d_eval", d_eval), ("key_b", key_b), ("key_a", key_a),
                    ("q", q), ("qinv", qinv)):
        if t.dtype != torch.int32:
            raise TypeError(f"ks_inner: {name} must be int32, got {t.dtype}")
        if t.device != d_eval.device:
            raise ValueError(f"ks_inner: {name} on {t.device}, "
                             f"d_eval on {d_eval.device}")
        if not t.is_contiguous():
            raise ValueError(f"ks_inner: {name} must be contiguous")
    if d_eval.dim() != 3 or key_b.dim() != 3:
        raise ValueError("ks_inner: d_eval and keys must be [J|dnum, rows, N]")
    J, M, N = d_eval.shape
    if key_b.shape != key_a.shape:
        raise ValueError(f"ks_inner: key_b {tuple(key_b.shape)} != "
                         f"key_a {tuple(key_a.shape)}")
    dnum, Mk, Nk = key_b.shape
    if Nk != N:
        raise ValueError(f"ks_inner: key ring {Nk} != digit ring {N}")
    if J > dnum:
        raise ValueError(f"ks_inner: {J} digits but the key has {dnum}")
    rk = np.asarray(rows_key)
    if rk.shape != (M,):
        raise ValueError(f"ks_inner: rows_key has {rk.shape}, need ({M},)")
    if rk.min() < 0 or rk.max() >= Mk:
        raise ValueError(f"ks_inner: rows_key outside the key's {Mk} rows")
    if q.shape != (M,) or qinv.shape != (M,):
        raise ValueError("ks_inner: q and qinv must be [M]")


def ks_inner(d_eval, key_b, key_a, rows_key, q, qinv):
    _check(d_eval, key_b, key_a, rows_key, q, qinv)
    dev = d_eval.device
    if dev.type == "cpu":
        return ks_inner_plain(d_eval, key_b, key_a, rows_key, q, qinv)
    if dev.type != "cuda":
        raise ValueError(f"ks_inner: unsupported device {dev}")
    J, M, N = d_eval.shape
    if N % 4:
        raise ValueError(f"ks_inner: N={N} must be a multiple of 4")
    for t in (d_eval, key_b, key_a):
        if t.data_ptr() % 16:
            raise ValueError("ks_inner: operands must be 16-byte aligned")
    rk = np.ascontiguousarray(rows_key, dtype=np.int32)
    ck = (str(dev), rk.tobytes())
    rk_dev = _rows_dev.get(ck)
    if rk_dev is None:
        rk_dev = torch.from_numpy(rk).to(dev)
        _rows_dev[ck] = rk_dev
    out = torch.empty((2, M, N), dtype=torch.int32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ks_inner_launch(d_eval.data_ptr(), key_b.data_ptr(),
                              key_a.data_ptr(), rk_dev.data_ptr(),
                              q.data_ptr(), qinv.data_ptr(), out.data_ptr(),
                              J, M, N, key_b.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"ks_inner kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def _library():
    lib = kernels.load("ks_inner")
    fn = lib.ks_inner_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + \
            [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def bytes_moved(J: int, M: int, N: int) -> int:
    """Least bytes the inner product must move: each input word read once,
    each output word written once."""
    return (3 * J * M + 2 * M) * N * 4
