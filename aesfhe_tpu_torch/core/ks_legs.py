"""The hybrid key-switch's basis conversions and their epilogue: the CUDA
kernels' wrappers (`aesfhe_tpu_torch/csrc/ks_legs.cu`, design note there)
and their plain torch versions.

    ks_modup(c, tab, j0, j1)   out[j, m] = sum_{a in digit j0+j}
                               (c_a * inv_w_a mod q_a) * conv_w[a, m]
                               mod basis_m; digits past the level's active
                               ones are padding and come out zero
    ks_moddown(d, tab)         out[m] = sum_i y_i * conv_w[i, m]
                               - v_hat * (P mod q_m) mod q_m, with
                               y_i = d_i * inv_w_i mod p_i and
                               v_hat = round(sum_i y_i / p_i) in float32
    sub_scale(x, y, tab)       out[m] = (x[m] - y[m]) * w_m mod q_m

The counterparts of the reference's `ops_impl.ks_decompose` digit loop, of
steps 2-2b of its `_mod_down_specials`, and of the step that ends that
mod-down and every rescale.  Every input and output is int32 holding
canonical residues; the tables are built once per level (`ModupTables`,
`ModdownTables`, `scale_table`) and uploaded with the caller's
DeviceTables.  The plain versions compute the kernels' arithmetic in int64
on any device: the conversions sum their products lazily and reduce once,
which is exact because a digit (or the special set) has at most
`MAX_DIGIT` primes of at most 30 bits, so every sum stays below 2^63 (the
tables raise otherwise).

On a CPU tensor each wrapper computes the plain version; on a CUDA tensor
it launches its kernel or raises.  `launches_modup`, `launches_moddown`
and `launches_sub_scale` count the launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from .rns import MASK32

launches_modup = 0
launches_moddown = 0
launches_sub_scale = 0
MAX_DIGIT = 8            # the kernels' largest digit / special set (kMaxDigit)


def _bits32(a) -> np.ndarray:
    """uint32 values -> int32 array with the same bits."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint64)
                                .astype(np.uint32)).view(np.int32)


def _mu(qs) -> np.ndarray:
    """floor(2^64 / q) of each prime, the kernels' Barrett constant."""
    return np.asarray([(1 << 64) // int(q) for q in qs], dtype=np.int64)


def _shoup(ws, qs) -> np.ndarray:
    return np.asarray([(int(w) << 32) // int(q) for w, q in zip(ws, qs)],
                      dtype=np.uint64)


def _check_sum(what: str, terms) -> None:
    """Raise unless a lazy sum of the products (q_a - 1) * (q_m - 1) stays
    below 2^63."""
    if len(terms) > MAX_DIGIT:
        raise ValueError(f"{what}: {len(terms)} primes, the kernels take at "
                         f"most {MAX_DIGIT}")
    if sum(terms) >= 1 << 63:
        raise ValueError(f"{what}: the 64-bit accumulator could overflow")


def _widen(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & MASK32


class ModupTables:
    """ks_modup's constants of one level on one device (int32 tensors of
    uint32 bits): per active digit its first limb and limb count `dig`
    [J, 2], its limbs' primes `dq`, inv_w `dinv` and their Shoup companions
    `dinvsh` [J, MAX_DIGIT], conv_w `conv` [J, MAX_DIGIT, M]; the basis
    primes `bq` [M] and their floor(2^64 / q) `bmu` (int64) [M]."""

    def __init__(self, params, level: int, device):
        kst = params.ks_tables(level)
        groups = kst["groups"]
        basis = [int(q) for q in kst["basis"]]
        J, M = len(groups), len(basis)
        dig = np.zeros((J, 2), dtype=np.int32)
        dq = np.zeros((J, MAX_DIGIT), dtype=np.uint64)
        dinv = np.zeros((J, MAX_DIGIT), dtype=np.uint64)
        dinvsh = np.zeros((J, MAX_DIGIT), dtype=np.uint64)
        conv = np.zeros((J, MAX_DIGIT, M), dtype=np.uint64)
        for j, g in enumerate(groups):
            limbs = list(g["limbs"])
            a = len(limbs)
            if limbs != list(range(limbs[0], limbs[0] + a)):
                raise ValueError(f"ks_modup: digit {j} at level {level} is "
                                 f"not a contiguous limb range")
            qa = [int(params.q_primes[i]) for i in limbs]
            _check_sum(f"ks_modup digit {j} at level {level}",
                       [(q - 1) * (max(basis) - 1) for q in qa])
            dig[j] = (limbs[0], a)
            dq[j, :a] = qa
            dinv[j, :a] = g["inv_w"]
            dinvsh[j, :a] = g["inv_sh"]
            conv[j, :a] = g["conv_w"]
        self.level, self.J, self.M = level, J, M

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.dig = up(dig)
        self.dq, self.dinv, self.dinvsh, self.conv, self.bq = (
            up(_bits32(a)) for a in (dq, dinv, dinvsh, conv, basis))
        self.bmu = up(_mu(basis))


class ModdownTables:
    """ks_moddown's constants of one level on one device: the special
    primes `sp`, inv_w `sinv` and Shoup companions `sinvsh` [K], 1/p_i
    `inv_p` (float32) [K], conv_w `conv` [K, R], the q primes `q`, their
    floor(2^64 / q) `mu` (int64), P mod q `pmod` and its companions
    `pmodsh` [R]; and `pinv`, sub_scale's table of P^-1 mod q (R = l+1)."""

    def __init__(self, params, level: int, device):
        mdt = params.md_tables(level)
        sp = [int(p) for p in params.special_primes]
        qs = [int(q) for q in params.q_primes[:level + 1]]
        K, R = len(sp), len(qs)
        _check_sum(f"ks_moddown at level {level}",
                   [(p - 1) * (max(qs) - 1) for p in sp])
        self.level, self.K, self.R = level, K, R

        def up(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        self.sp, self.sinv, self.sinvsh, self.conv, self.q, self.pmod, \
            self.pmodsh = (up(_bits32(a)) for a in (
                sp, mdt["inv_w"], mdt["inv_sh"], mdt["conv_w"], qs,
                mdt["pmod_w"], mdt["pmod_sh"]))
        self.inv_p = up((1.0 / np.asarray(sp, dtype=np.float64))
                        .astype(np.float32))
        self.mu = up(_mu(qs))
        self.pinv = up(scale_table(qs, mdt["pinv_w"]))


def scale_table(qs, ws) -> np.ndarray:
    """sub_scale's table int32 [3, R] (uint32 bits): the primes q, the
    factors w < q and their Shoup companions floor(w * 2^32 / q)."""
    qs = [int(q) for q in qs]
    ws = [int(w) for w in ws]
    if len(ws) != len(qs) or any(not 0 <= w < q for w, q in zip(ws, qs)):
        raise ValueError("scale_table: need one factor 0 <= w < q a prime")
    return _bits32(np.stack([np.asarray(qs, dtype=np.uint64),
                             np.asarray(ws, dtype=np.uint64),
                             _shoup(ws, qs)]))


# ---------------------------------------------------------------------------
# Plain versions (int64, any device)
# ---------------------------------------------------------------------------

def ks_modup_plain(c, tab: ModupTables, j0: int, j1: int) -> torch.Tensor:
    N = c.shape[-1]
    out = torch.zeros((j1 - j0, tab.M, N), dtype=torch.int64,
                      device=c.device)
    bq = _widen(tab.bq).reshape(-1, 1)
    dig = tab.dig.tolist()
    for j in range(j0, min(j1, tab.J)):
        first, cnt = dig[j]
        acc = out[j - j0]
        for a in range(cnt):
            y = c[first + a].long() * _widen(tab.dinv[j, a]) \
                % _widen(tab.dq[j, a])
            acc += y[None, :] * _widen(tab.conv[j, a]).reshape(-1, 1)
        acc.remainder_(bq)
    return out.to(torch.int32)


def vhat_frac(yf, inv_p, K: int):
    """sum_i yf_i * inv_p_i in float32 over the K special rows of yf
    [..., K, N], in XLA:CPU's order for the reference's jnp.sum: K = 8 as
    one 8-lane vector, each product rounded, then halves added
    (t_i + t_{i+4}, then + t_{i+2}, then + t_{i+1}); any other K as a
    fused multiply-add chain acc = fma(yf_i, inv_p_i, acc) from 0, each
    step rounded once (the float64 product of two float32 values is exact;
    the float64 sum rounds only for a product far below the sum, where a
    double rounding needs ~29 particular bits).  Orders differ only where
    the sum falls within a float32 ulp of a half-integer: v_hat then
    differs by one, and the result by one unit in that coefficient
    (ROADMAP queue 3)."""
    if K == 8:
        t = [yf[..., i:i + 1, :] * inv_p[i] for i in range(K)]
        while len(t) > 1:
            h = len(t) // 2
            t = [t[i] + t[i + h] for i in range(h)]
        return t[0]
    inv = inv_p.double()
    acc = torch.zeros_like(yf[..., 0:1, :], dtype=torch.float64)
    for i in range(K):
        acc = (yf[..., i:i + 1, :].double() * inv[i] + acc).float().double()
    return acc.float()


def ks_moddown_plain(d, tab: ModdownTables) -> torch.Tensor:
    K = tab.K
    ps = _widen(tab.sp).reshape(-1, 1)
    y = d.long() * _widen(tab.sinv).reshape(-1, 1) % ps           # [..., K, N]
    qv = _widen(tab.q).reshape(-1, 1)
    conv = _widen(tab.conv)
    acc = None
    for i in range(K):
        t = y[..., i:i + 1, :] * conv[i].reshape(-1, 1)
        acc = t if acc is None else acc.add_(t)
    acc.remainder_(qv)
    vhat = torch.round(vhat_frac(y.to(torch.float32), tab.inv_p, K)
                       ).to(torch.int64)
    corr = vhat * _widen(tab.pmod).reshape(-1, 1) % qv
    return torch.where(acc >= corr, acc - corr, acc + qv - corr
                       ).to(torch.int32)


def sub_scale_plain(x, y, tab) -> torch.Tensor:
    q = _widen(tab[0]).reshape(-1, 1)
    a, b = x.long(), y.long()
    diff = torch.where(a >= b, a - b, a + q - b)
    return (diff * _widen(tab[1]).reshape(-1, 1) % q).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _same_device(name: str, t: torch.Tensor, dev: torch.device):
    if t.device != dev:
        raise ValueError(f"{name}: a table on {t.device}, the data on {dev}")


def _int32(name: str, **ts):
    for what, t in ts.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")


def _cuda_ok(name: str, *ts):
    """The kernels' layout: CUDA tensors, N a multiple of 4, 16-byte
    aligned rows (checked on the card only; the plain version takes any)."""
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.shape[-1] % 4 or t.data_ptr() % 16 or \
                any(s % 4 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: N must be a multiple of 4 and rows "
                             f"16-byte aligned")


def ks_modup(c, tab: ModupTables, j0: int, j1: int):
    """c int32 [l+1, N] canonical residues (natural order, plain form) ->
    int32 [j1 - j0, M, N]: the basis extension of digits j0 <= j < j1."""
    _int32("ks_modup", c=c)
    if c.dim() != 2 or c.shape[0] != tab.level + 1:
        raise ValueError(f"ks_modup: c must be [{tab.level + 1}, N], got "
                         f"{tuple(c.shape)}")
    if not c.is_contiguous():
        raise ValueError("ks_modup: c must be contiguous")
    if not 0 <= j0 <= j1:
        raise ValueError(f"ks_modup: digit range [{j0}, {j1})")
    _same_device("ks_modup", tab.conv, c.device)
    if c.device.type == "cpu":
        return ks_modup_plain(c, tab, j0, j1)
    _cuda_ok("ks_modup", c)
    N = c.shape[1]
    out = torch.empty((j1 - j0, tab.M, N), dtype=torch.int32, device=c.device)
    if out.numel() == 0:
        return out
    err = _library().ks_modup_launch(
        c.data_ptr(), tab.dig.data_ptr(), tab.dq.data_ptr(),
        tab.dinv.data_ptr(), tab.dinvsh.data_ptr(), tab.conv.data_ptr(),
        tab.bq.data_ptr(), tab.bmu.data_ptr(), out.data_ptr(), j0, j1 - j0,
        tab.J, tab.M, N, _stream(c))
    if err != 0:
        raise RuntimeError(f"ks_modup kernel launch failed: CUDA error {err}")
    global launches_modup
    launches_modup += 1
    return out


def ks_moddown(d, tab: ModdownTables):
    """d int32 [K, N] or [B, K, N] canonical residues of the special rows
    (natural order, plain form) -> int32 [..., l+1, N]."""
    _int32("ks_moddown", d=d)
    if d.dim() not in (2, 3) or d.shape[-2] != tab.K:
        raise ValueError(f"ks_moddown: d must be [..., {tab.K}, N], got "
                         f"{tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError("ks_moddown: d must be contiguous")
    _same_device("ks_moddown", tab.conv, d.device)
    if d.device.type == "cpu":
        return ks_moddown_plain(d, tab)
    _cuda_ok("ks_moddown", d)
    N = d.shape[-1]
    B = d.shape[0] if d.dim() == 3 else 1
    out = torch.empty(d.shape[:-2] + (tab.R, N), dtype=torch.int32,
                      device=d.device)
    if out.numel() == 0:
        return out
    err = _library().ks_moddown_launch(
        d.data_ptr(), tab.sp.data_ptr(), tab.sinv.data_ptr(),
        tab.sinvsh.data_ptr(), tab.inv_p.data_ptr(), tab.conv.data_ptr(),
        tab.q.data_ptr(), tab.mu.data_ptr(), tab.pmod.data_ptr(),
        tab.pmodsh.data_ptr(), out.data_ptr(), B, tab.K, tab.R, N,
        _stream(d))
    if err != 0:
        raise RuntimeError(f"ks_moddown kernel launch failed: CUDA error "
                           f"{err}")
    global launches_moddown
    launches_moddown += 1
    return out


def sub_scale(x, y, tab):
    """x, y int32 [R, N] or [B, R, N] canonical residues (any batch and row
    strides, the last axis contiguous), tab int32 [3, R] (`scale_table`) ->
    int32 (x - y) * w mod q, contiguous."""
    _int32("sub_scale", x=x, y=y, tab=tab)
    if x.shape != y.shape or x.dim() not in (2, 3):
        raise ValueError(f"sub_scale: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be one [R, N] or [B, R, N]")
    R, N = x.shape[-2], x.shape[-1]
    if tab.shape != (3, R):
        raise ValueError(f"sub_scale: table {tuple(tab.shape)}, need "
                         f"(3, {R})")
    if x.stride(-1) != 1 or y.stride(-1) != 1:
        raise ValueError("sub_scale: the last axis must be contiguous")
    if y.device != x.device:
        raise ValueError(f"sub_scale: y on {y.device}, x on {x.device}")
    _same_device("sub_scale", tab, x.device)
    if x.device.type == "cpu":
        return sub_scale_plain(x, y, tab)
    _cuda_ok("sub_scale", x, y)
    if not tab.is_contiguous():
        raise ValueError("sub_scale: the table must be contiguous")
    x3 = x if x.dim() == 3 else x[None]
    y3 = y if y.dim() == 3 else y[None]
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    err = _library().sub_scale_launch(
        x3.data_ptr(), x3.stride(0), x3.stride(1), y3.data_ptr(),
        y3.stride(0), y3.stride(1), tab.data_ptr(), out.data_ptr(),
        x3.shape[0], R, N, _stream(x))
    if err != 0:
        raise RuntimeError(f"sub_scale kernel launch failed: CUDA error "
                           f"{err}")
    global launches_sub_scale
    launches_sub_scale += 1
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _library():
    lib = kernels.load("ks_legs")
    if lib.ks_modup_launch.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ks_modup_launch.argtypes = [P] * 9 + [I] * 5 + [P]
        lib.ks_moddown_launch.argtypes = [P] * 11 + [I] * 4 + [P]
        lib.sub_scale_launch.argtypes = [P, L, L, P, L, L, P, P] + \
            [I] * 3 + [P]
        for fn in (lib.ks_modup_launch, lib.ks_moddown_launch,
                   lib.sub_scale_launch):
            fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# The work each function must do: the bytes (each input word read once, each
# output word written once; 4 bytes a word) and the 32-bit multiplies (two
# for a 32x32->64 product of the conversions, three for a Shoup product)
# ---------------------------------------------------------------------------

def modup_work(rows_in: int, J: int, M: int, N: int) -> tuple[int, int]:
    """(bytes, multiplies) of ks_modup: rows_in rows in, J digits of M rows
    out; each input limb enters M products of its digit."""
    return (rows_in + J * M) * N * 4, 2 * rows_in * M * N + 3 * rows_in * N


def moddown_work(B: int, K: int, R: int, N: int) -> tuple[int, int]:
    return B * (K + R) * N * 4, B * (2 * K * R + 3 * K + 3 * R) * N


def sub_scale_work(B: int, R: int, N: int) -> tuple[int, int]:
    return 3 * B * R * N * 4, 3 * B * R * N
