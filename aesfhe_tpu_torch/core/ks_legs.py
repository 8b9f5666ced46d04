"""The hybrid key-switch's basis conversions and their epilogue: the CUDA
kernels' wrappers (`aesfhe_tpu_torch/csrc/ks_legs.cu`, design note there),
their plain torch versions, and a CPU model of the kernels' digit
arithmetic.

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

The kernels compute the conversions as exact u8 x u8 -> s32 tensor-core
products instead (the byte scheme of the reference's `core/mxu_ntt.py`):
with k = 4a + s over limb a and byte s of y_a, the digit matrices
A_e[m, k] = byte_e(conv_w[a, m] 256^s 2^32 mod q_m) give
S_e = sum_k A_e[m, k] byte_s(y_a) < 2^21, and
sum_a y_a conv_w[a, m] = (L + 2^16 H) 2^-32 mod q_m with L = S_0 + 2^8 S_1
and H = S_2 + 2^8 S_3 both below 2^30: one Montgomery step
(`digit_tables` builds A_e in the mma's fragment order, `fold_table` the
fold's constants).  `convert_digits_model` computes that arithmetic on the
CPU, step by step, and `ks_modup_model`/`ks_moddown_model` wrap it as the
kernels do.

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
# mma.sync.m16n8k32's A fragment: lane l's register r holds the 4 bytes
# k = 4c .. 4c+3 of row FRAG_ROW[l, r] of a 16-row tile, c = FRAG_WORD[l, r]
# (the PTX ISA's layout for .u8: row = l/4 (+8 for r odd), c = l%4 (+4 for
# r >= 2)); with k = 4a + s, word c is limb a's 4 bytes.
_LANE = np.arange(32)[:, None]
_REG = np.arange(4)[None, :]
FRAG_ROW = (_LANE >> 2) + 8 * (_REG & 1)
FRAG_WORD = (_LANE & 3) + 4 * (_REG >> 1)


def _bits32(a) -> np.ndarray:
    """uint32 values -> int32 array with the same bits."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint64)
                                .astype(np.uint32)).view(np.int32)


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


def digit_tables(conv, qs, in_primes) -> np.ndarray:
    """The u8 digit matrices of a conversion out[m] = sum_a y_a conv[a, m]
    mod qs[m], y_a < in_primes[a], in mma.sync m16n8k32's A-fragment order:
    conv [..., A, M] (A <= MAX_DIGIT) -> int32 [..., MT, 4, 32, 4]
    (MT = ceil(M / 16) row tiles, digit e, lane, register; uint32 bits),
    A_e[m, 4a + s] = byte_e(conv[a, m] 256^s 2^32 mod q_m), zero past A
    limbs and M rows (the factor 2^32 cancels the fold's Montgomery step).
    Raises unless the kernels' fold is exact: odd primes between 2^15 and
    2^31 and, for the largest bytes the inputs can have, S_e < 2^21 and
    L = S_0 + 2^8 S_1, H = S_2 + 2^8 S_3 below 2^30."""
    conv = np.asarray(conv, dtype=np.int64)
    *lead, A, M = conv.shape
    q = np.asarray(qs, dtype=np.int64)
    pin = np.asarray(in_primes, dtype=np.int64)
    if A > MAX_DIGIT or len(pin) != A:
        raise ValueError(f"digit_tables: {A} limbs for {len(pin)} primes, "
                         f"at most {MAX_DIGIT}")
    if np.any(q % 2 == 0) or q.min() <= 1 << 15 or q.max() >= 1 << 31 or \
            pin.max() >= 1 << 31:
        raise ValueError("digit_tables: the fold needs odd primes between "
                         "2^15 and 2^31")
    MT = -(-M // 16)
    pw = np.asarray([[pow(256, s, int(qm)) * (1 << 32) % int(qm)
                      for qm in q] for s in range(4)])
    val = conv[..., :, None, :] % q * pw % q              # [..., A, s, M]
    e8 = 8 * np.arange(4)
    byte = (val[..., None] >> e8) & 255                   # [..., A, s, M, e]
    ae = np.zeros(tuple(lead) + (4, 16 * MT, MAX_DIGIT, 4), dtype=np.uint8)
    ae[..., :M, :A, :] = np.moveaxis(byte, (-1, -2), (-4, -3))
    # the largest byte s of a residue below each input prime
    top = np.zeros((MAX_DIGIT, 4), dtype=np.int64)
    top[:A] = np.minimum((pin[:, None] - 1) >> e8, 255)
    peak = (ae.astype(np.int64) * top).sum((-2, -1))      # [..., e, row]
    low = peak[..., 0, :] + (peak[..., 1, :] << 8)
    high = peak[..., 2, :] + (peak[..., 3, :] << 8)
    if peak.max() >= 1 << 21 or max(low.max(), high.max()) >= 1 << 30:
        raise ValueError("digit_tables: a digit product could overflow the "
                         "32-bit fold")
    words = np.ascontiguousarray(ae).view("<u4")[..., 0]   # [..., e, row, a]
    words = words.reshape(tuple(lead) + (4, MT, 16, MAX_DIGIT))
    frag = words[..., FRAG_ROW, FRAG_WORD]                # [..., e, MT, l, r]
    return _bits32(np.moveaxis(frag, -4, -3))


def fold_table(qs, corr=None) -> np.ndarray:
    """The fold's constants of each output prime, int32 [3, M] (uint32
    bits): q, q^-1 mod 2^32 and the correction factor corr (ks_moddown's
    -P 2^32 mod q; zero by default)."""
    q = [int(x) for x in qs]
    corr = [0] * len(q) if corr is None else [int(c) for c in corr]
    return _bits32(np.asarray([q, [pow(x, -1, 1 << 32) for x in q], corr],
                              dtype=np.uint64))


def _widen(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & MASK32


class ModupTables:
    """ks_modup's constants of one level on one device (int32 tensors of
    uint32 bits): per active digit its first limb and limb count `dig`
    [J, 2], its limbs' primes `dq`, inv_w `dinv` and their Shoup companions
    `dinvsh` [J, MAX_DIGIT], conv_w `conv` [J, MAX_DIGIT, M] (the plain
    version's) and its digit matrices `afrag` [J, MT, 4, 32, 4]
    (`digit_tables`, the kernel's); the basis primes `bq` [M] and the
    fold's constants `bfold` [3, M] (`fold_table`)."""

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
        # a digit's unused limbs have prime 0 here: no input, zero bytes
        afrag = np.stack([digit_tables(conv[j], basis, np.maximum(dq[j], 1))
                          for j in range(J)])
        self.level, self.J, self.M = level, J, M

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.dig = up(dig)
        self.dq, self.dinv, self.dinvsh, self.conv, self.bq = (
            up(_bits32(a)) for a in (dq, dinv, dinvsh, conv, basis))
        self.afrag = up(afrag)
        self.bfold = up(fold_table(basis))


class ModdownTables:
    """ks_moddown's constants of one level on one device: the special
    primes `sp`, inv_w `sinv` and Shoup companions `sinvsh` [K], 1/p_i
    `inv_p` (float32) [K], conv_w `conv` [K, R] (the plain version's) and
    its digit matrices `afrag` [MT, 4, 32, 4] (the kernel's), the q primes
    `q` and P mod q `pmod` [R] (the plain version's), the fold's constants
    `fold` [3, R] with the correction factor -P 2^32 mod q (the kernel's);
    and `pinv`, sub_scale's table of P^-1 mod q (R = l+1)."""

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

        self.sp, self.sinv, self.sinvsh, self.conv, self.q, self.pmod = (
            up(_bits32(a)) for a in (sp, mdt["inv_w"], mdt["inv_sh"],
                                     mdt["conv_w"], qs, mdt["pmod_w"]))
        self.inv_p = up((1.0 / np.asarray(sp, dtype=np.float64))
                        .astype(np.float32))
        self.afrag = up(digit_tables(mdt["conv_w"], qs, sp))
        self.fold = up(fold_table(qs, [(-int(pm) << 32) % q for pm, q in
                                       zip(mdt["pmod_w"], qs)]))
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
# CPU model of the kernels' digit arithmetic (int64 emulating the kernels'
# u8 products and 32-bit fold; tests hold it equal to the plain versions)
# ---------------------------------------------------------------------------

def _digit_matrices(afrag: torch.Tensor) -> torch.Tensor:
    """afrag int32 [..., MT, 4, 32, 4] (`digit_tables`) -> the u8 matrices
    A_e as int32 [..., 4, 16 MT, 4 MAX_DIGIT] (e, row, k = 4a + s)."""
    f = _widen(afrag).movedim(-3, -4)                     # [..., e, MT, l, r]
    *lead, MT = f.shape[:-2]
    words = torch.empty(tuple(lead) + (MT, 16, MAX_DIGIT), dtype=torch.int64,
                        device=f.device)
    words[..., torch.as_tensor(FRAG_ROW), torch.as_tensor(FRAG_WORD)] = f
    shifts = 8 * torch.arange(4, device=f.device)
    byte = (words[..., None] >> shifts) & 255             # [..., MT, 16, a, s]
    return byte.reshape(tuple(lead) + (16 * MT, 4 * MAX_DIGIT)).to(
        torch.int32)


def convert_digits_model(y, afrag, fold, vhat=None,
                         peaks: dict | None = None):
    """The kernels' conversion: y int64 [B, MAX_DIGIT, N] (values below
    2^32; zero past the digit's limbs), afrag [MT, 4, 32, 4], fold [3, M],
    vhat (ks_moddown's v_hat, int64 [B, 1, N]) -> int64 [B, M, N]
    canonical, computed as the kernels do: the bytes B[4a + s] =
    byte_s(y_a), S_e = A_e @ B as int32 products, L = S_0 + (S_1 << 8),
    H = S_2 + (S_3 << 8), x = L + 2^16 H (+ vhat corr), then the Montgomery
    step m = x_lo q^-1 mod 2^32, r = x_hi - hi(m q), plus q if negative.
    `peaks` (if given) gets the largest S_e, L and H."""
    A = _digit_matrices(afrag)                            # [4, Mp, 32]
    Bn, _, N = y.shape
    shifts = (8 * torch.arange(4, device=y.device)).reshape(1, 1, 4, 1)
    b = ((y[:, :, None, :] >> shifts) & 255).reshape(Bn, 4 * MAX_DIGIT, N)
    M = fold.shape[1]
    S = (A[:, None] @ b.to(torch.int32)[None])[:, :, :M].long()
    L = S[0] + (S[1] << 8)
    H = S[2] + (S[3] << 8)
    q, qinv, corr = (_widen(fold[i]).reshape(-1, 1) for i in range(3))
    x = L + (H << 16)
    if vhat is not None:
        x = x + vhat * corr
    m = (x & MASK32) * qinv & MASK32
    r = (x >> 32) - ((m * q) >> 32)
    r = torch.where(r < 0, r + q, r)
    if peaks is not None:
        for k, v in (("S", S), ("L", L), ("H", H)):
            peaks[k] = max(peaks.get(k, 0), int(v.max()) if v.numel() else 0)
    return r


def ks_modup_model(c, tab: ModupTables, j0: int, j1: int,
                   peaks: dict | None = None) -> torch.Tensor:
    """ks_modup as the kernel computes it (`convert_digits_model` per
    digit; a padded digit zero)."""
    N = c.shape[-1]
    out = torch.zeros((j1 - j0, tab.M, N), dtype=torch.int64,
                      device=c.device)
    dig = tab.dig.tolist()
    for j in range(j0, min(j1, tab.J)):
        first, cnt = dig[j]
        y = torch.zeros((1, MAX_DIGIT, N), dtype=torch.int64, device=c.device)
        y[0, :cnt] = c[first:first + cnt].long() * \
            _widen(tab.dinv[j, :cnt]).reshape(-1, 1) % \
            _widen(tab.dq[j, :cnt]).reshape(-1, 1)
        out[j - j0] = convert_digits_model(y, tab.afrag[j], tab.bfold,
                                           peaks=peaks)[0]
    return out.to(torch.int32)


def ks_moddown_model(d, tab: ModdownTables,
                     peaks: dict | None = None) -> torch.Tensor:
    """ks_moddown as the kernel computes it: the float32 v_hat of
    `vhat_frac`, then `convert_digits_model` with the correction folded
    in."""
    K = tab.K
    d3 = d if d.dim() == 3 else d[None]
    y = d3.long() * _widen(tab.sinv).reshape(-1, 1) % \
        _widen(tab.sp).reshape(-1, 1)                     # [B, K, N]
    vhat = torch.round(vhat_frac(y.to(torch.float32), tab.inv_p, K)
                       ).to(torch.int64)
    pad = torch.zeros((y.shape[0], MAX_DIGIT - K, y.shape[-1]),
                      dtype=torch.int64, device=y.device)
    out = convert_digits_model(torch.cat([y, pad], 1), tab.afrag, tab.fold,
                               vhat, peaks)
    return out.reshape(d.shape[:-2] + out.shape[-2:]).to(torch.int32)


def byte_extremes(primes, inv_w, pick) -> np.ndarray:
    """Residues c int64 [rows, N] whose Shoup products y = c * inv_w mod q
    have extreme bytes, the conversions' widest digit sums: pick [rows, N]
    in {0, 1, 2} gives y = 0, y = q - 1 or the largest y < q whose three
    low bytes are 0xFF; primes, inv_w [rows] (inv_w invertible mod q)."""
    q = np.asarray([int(v) for v in primes], dtype=np.int64)[:, None]
    w = np.asarray([pow(int(a), -1, int(b)) for a, b in zip(inv_w, primes)],
                   dtype=np.int64)[:, None]
    ff = ((q - 1) >> 24 << 24) | 0xFFFFFF
    ff = np.where(ff < q, ff, ff - (1 << 24))
    y = np.choose(np.asarray(pick), [np.zeros_like(q), q - 1, ff])
    return y * w % q


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
        tab.dinv.data_ptr(), tab.dinvsh.data_ptr(), tab.afrag.data_ptr(),
        tab.bfold.data_ptr(), out.data_ptr(), j0, j1 - j0,
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
        tab.sinvsh.data_ptr(), tab.inv_p.data_ptr(), tab.afrag.data_ptr(),
        tab.fold.data_ptr(), out.data_ptr(), B, tab.K, tab.R, N, _stream(d))
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
        lib.ks_modup_launch.argtypes = [P] * 8 + [I] * 5 + [P]
        lib.ks_moddown_launch.argtypes = [P] * 8 + [I] * 4 + [P]
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
