"""The LUT sums, sum_k ct_k * c_k mod q over a stack of ciphertexts: the
CUDA kernel's wrapper (`aesfhe_tpu_torch/csrc/lut_sum.cu`, design note
there) and its plain torch versions.  Counterpart of the reference's
XLA-fused `ops_impl.ct_linear_combo` and `ct_linear_combo_dense`.

    lut_sum(stack, consts, neg, tr)   out = sum_k stack[k] * (re_k + s imz_k)
                                      mod q, s = -1 on the columns where
                                      neg holds, else +1
    lut_sum_dense(stack, pts, tr)     out = sum_k stack[k] * pts[k] * 2^-32
                                      mod q (Montgomery plaintexts)

stack: int32 [K, deg+1, l+1, N] canonical residues; consts: int32
[K, l+1, 4] (re_w, re_shoup, imz_w, imz_shoup; the weights below 2^31);
neg: bool [N] (`DeviceTables.xhalf_sign_neg`); pts: int32 [K, l+1, N]
canonical, its rows contiguous (a view of the first l+1 rows of a taller
stack is read in place); tr: the limbs' row tables (`ops_impl._RowTables`:
q, rinv int64; q32, qinv32 int32; every prime below 2^30, as params.py
asserts, so the kernel's lazy 32-bit sums stay below 4q < 2^32).  Returns
int32 [deg+1, l+1, N].

On a CPU tensor each wrapper computes the plain version; on a CUDA tensor
it launches the kernel (deg+1 of 2 or 3) or raises.  `launches_scalar`
and `launches_dense` count the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .rns import add_mod, shoup_mul, sub_mod

launches_scalar = 0
launches_dense = 0
COMPONENTS = (2, 3)          # the deg+1 the kernel is compiled for


def scalar_terms(x, consts, q, neg):
    """x * (re + s_i * imz) with s_i = -1 on xhalf_sign_neg slots; consts
    columns (re_w, re_shoup, imz_w, imz_shoup), shaped to broadcast."""
    t_re = shoup_mul(x, consts[..., 0:1].long(), q)
    t_im = shoup_mul(x, consts[..., 2:3].long(), q)
    return torch.where(neg, sub_mod(t_re, t_im, q), add_mod(t_re, t_im, q))


def lut_sum_plain(stack, consts, neg, q):
    """The scalar sum in int64 torch ops, any device; q int64 [l+1]."""
    q = q.reshape(1, -1, 1)
    acc = None
    for k in range(stack.shape[0]):
        t = scalar_terms(stack[k].long(), consts[k][None], q, neg)
        acc = t if acc is None else add_mod(acc, t, q)
    return acc.int()


def lut_sum_dense_plain(stack, pts, q, rinv):
    """The dense sum in int64 torch ops, any device; q, rinv int64 [l+1]."""
    q = q.reshape(1, -1, 1)
    acc = None
    for k in range(stack.shape[0]):
        t = (stack[k].long() * pts[k].long()[None]) % q
        acc = t if acc is None else acc + t
    # sum_k mont_mul(x_k, p_k) = (sum_k x_k p_k mod q) * 2^-32 mod q
    return ((acc % q) * rinv.reshape(1, -1, 1) % q).int()


def _check(what, stack, coeffs, width=None):
    """stack int32 [K, deg+1, l+1, N] contiguous; coeffs (consts or pts)
    int32 [K, l+1, width] (default N) on stack's device.  Returns the
    stack's shape."""
    if stack.dim() != 4:
        raise ValueError(f"{what}: stack must be [K, deg+1, l+1, N], got "
                         f"{tuple(stack.shape)}")
    K, D, L, N = stack.shape
    for name, t in (("stack", stack), ("coefficients", coeffs)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
        if t.device != stack.device:
            raise ValueError(f"{what}: {name} on {t.device}, stack on "
                             f"{stack.device}")
    if not stack.is_contiguous():
        raise ValueError(f"{what}: stack must be contiguous")
    if K < 1:
        raise ValueError(f"{what}: no terms")
    if tuple(coeffs.shape) != (K, L, width or N):
        raise ValueError(f"{what}: coefficients {tuple(coeffs.shape)}, need "
                         f"{(K, L, width or N)}")
    return K, D, L, N


def _launchable(what, D, N, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if D not in COMPONENTS:
        raise ValueError(f"{what}: the kernel takes deg+1 in {COMPONENTS}, "
                         f"got {D}")
    if N % 4:
        raise ValueError(f"{what}: N={N} must be a multiple of 4")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    return torch.cuda.current_stream(dev).cuda_stream


def lut_sum(stack, consts, neg, tr):
    K, D, L, N = _check("lut_sum", stack, consts, 4)
    if not consts.is_contiguous():
        raise ValueError("lut_sum: consts must be contiguous")
    if neg.dtype != torch.bool or tuple(neg.shape) != (N,) or \
            neg.device != stack.device or not neg.is_contiguous():
        raise ValueError(f"lut_sum: neg must be a contiguous bool [{N}] on "
                         f"{stack.device}")
    if stack.device.type == "cpu":
        return lut_sum_plain(stack, consts, neg, tr.q)
    stream = _launchable("lut_sum", D, N, stack, neg)
    out = torch.empty((D, L, N), dtype=torch.int32, device=stack.device)
    err = _library().lut_sum_scalar_launch(
        stack.data_ptr(), consts.data_ptr(), neg.data_ptr(),
        tr.q32.data_ptr(), out.data_ptr(), K, D, L, N, stream)
    if err != 0:
        raise RuntimeError(f"lut_sum kernel launch failed: CUDA error {err}")
    global launches_scalar
    launches_scalar += 1
    return out


def lut_sum_dense(stack, pts, tr):
    K, D, L, N = _check("lut_sum_dense", stack, pts)
    if pts.stride(2) != 1 or pts.stride(1) != N:
        raise ValueError("lut_sum_dense: each plaintext's rows must be "
                         "contiguous")
    if stack.device.type == "cpu":
        return lut_sum_dense_plain(stack, pts, tr.q, tr.rinv)
    stream = _launchable("lut_sum_dense", D, N, stack, pts)
    if pts.stride(0) % 4:
        raise ValueError("lut_sum_dense: plaintext stride must be a "
                         "multiple of 4 words")
    out = torch.empty((D, L, N), dtype=torch.int32, device=stack.device)
    err = _library().lut_sum_dense_launch(
        stack.data_ptr(), pts.data_ptr(), pts.stride(0), tr.q32.data_ptr(),
        tr.qinv32.data_ptr(), out.data_ptr(), K, D, L, N, stream)
    if err != 0:
        raise RuntimeError(f"lut_sum_dense kernel launch failed: CUDA error "
                           f"{err}")
    global launches_dense
    launches_dense += 1
    return out


def _library():
    lib = kernels.load("lut_sum")
    if lib.lut_sum_scalar_launch.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.lut_sum_scalar_launch.argtypes = [ptr] * 5 + [i] * 4 + [ptr]
        lib.lut_sum_dense_launch.argtypes = [ptr, ptr, ctypes.c_longlong,
                                             ptr, ptr, ptr] + [i] * 4 + [ptr]
        lib.lut_sum_scalar_launch.restype = i
        lib.lut_sum_dense_launch.restype = i
    return lib


def bytes_moved(K: int, D: int, L: int, N: int, dense: bool) -> int:
    """Least bytes a sum must move: each input word read once (the dense
    plaintexts too), each output word written once."""
    return ((K * D + D + (K if dense else 0)) * L * N) * 4
