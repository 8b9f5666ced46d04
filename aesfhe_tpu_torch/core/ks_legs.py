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
on any device: the conversions sum their products lazily and reduce
whenever the sum's bound, taken from the actual primes, would pass
2^63 - 1 (8 terms of 30-bit primes, fewer of 31-bit ones), so a digit or
a special set of any size and any prime below 2^31 is exact.

The kernels compute the conversions as exact u8 x u8 -> s32 tensor-core
products instead (the byte scheme of the reference's `core/mxu_ntt.py`),
in chunks of `CHUNK` = 8 primes, one mma k-step each: with k = 4a + s
over limb a of the chunk and byte s of y_a, the digit matrices
A_e[m, k] = byte_e(conv_w[a, m] 256^s 2^32 mod q_m) give
S_e = sum_k A_e[m, k] byte_s(y_a) < 2^21, and
sum_a y_a conv_w[a, m] = (L + 2^16 H) 2^-32 mod q_m with L = S_0 + 2^8 S_1
and H = S_2 + 2^8 S_3: one Montgomery step (`digit_tables` builds A_e in
the mma's fragment order, `fold_table` the fold's constants).  A wider
digit or special set is ceil(width / 8) chunks whose products the mma
sums into S_e, folded once a word while the sums keep the fold exact
(`fold_group`: up to ~7 chunks of 30-bit primes), else every `group`
chunks with the canonical partials added mod q_m; a digit takes its own
chunks, not the widest digit's.  The mod-down's v_hat is computed once
over all K special primes and enters the first fold only.
`convert_digits_model` computes that arithmetic on the CPU, step by step,
and `ks_modup_model`/`ks_moddown_model` wrap it as the kernels do.

The kernel-only tables (the digit matrices and the fold's constants) are
built, and their limits checked, only for tables on a CUDA device
(`kernel_tables`, which the CPU model calls itself).  On a CPU tensor
each wrapper computes the plain version; on a CUDA tensor it launches its
kernel or raises.  `launches_modup`, `launches_moddown` and
`launches_sub_scale` count the launches, `launches_modup_chunks` and
`launches_moddown_chunks` those of the chunked instances among them.
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
# of those, the launches of the chunked instances (more than CHUNK primes)
launches_modup_chunks = 0
launches_moddown_chunks = 0
CHUNK = 8                # primes a conversion kernel takes in one k-step
# chunk counts whose chunked instance holds its A fragments in registers
# and folds once; another count, or a fold group below the count, takes the
# instance compiled for any count (0)
HELD_CHUNKS = (2, 3)
# float32 lanes of the vector loop in which XLA:CPU sums the reference's
# v_hat over K = 8 and K >= 16 (256-bit vectors; `vhat_frac`)
XLA_LANES = 8
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
    """Raise unless a lazy int64 sum of terms (the largest values of its
    products and of the residue it starts from) stays below 2^63."""
    if sum(terms) >= 1 << 63:
        raise ValueError(f"{what}: the 64-bit accumulator could overflow")


def lazy_reductions(what: str, terms, rest: int) -> list[int]:
    """Where a lazy int64 sum of products must be reduced: terms[a] is the
    largest value of product a, rest the largest residue a reduction leaves.
    Returns the indices a before which the sum is reduced, so that every
    run of the sum stays below 2^63 (`_check_sum`)."""
    cuts, run = [], []
    for a, t in enumerate(terms):
        if run and sum(run) + t >= 1 << 63:
            cuts.append(a)
            run = [rest]
        run.append(t)
        _check_sum(what, run)
    return cuts


def _digit_bytes(conv, qs, in_primes):
    """The u8 digit matrices of one chunk, conv [..., A, M] (A <= CHUNK) ->
    (bytes uint8 [..., e, 16 MT, CHUNK, s] of A_e[m, 4a + s] =
    byte_e(conv[a, m] 256^s 2^32 mod q_m), zero past A limbs and M rows;
    peaks int64 [..., e, 16 MT], the largest S_e = sum_k A_e[m, k]
    byte_s(y_a) of each row over inputs y_a < in_primes[a])."""
    conv = np.asarray(conv, dtype=np.int64)
    *lead, A, M = conv.shape
    q = np.asarray(qs, dtype=np.int64)
    pin = np.asarray(in_primes, dtype=np.int64)
    if A > CHUNK or len(pin) != A:
        raise ValueError(f"digit_tables: {A} limbs for {len(pin)} primes, "
                         f"at most {CHUNK}")
    if np.any(q % 2 == 0) or q.min() < 3 or q.max() >= 1 << 31 or \
            pin.max() >= 1 << 31:
        raise ValueError("digit_tables: the fold needs odd primes below "
                         "2^31")
    MT = -(-M // 16)
    pw = np.asarray([[pow(256, s, int(qm)) * (1 << 32) % int(qm)
                      for qm in q] for s in range(4)])
    val = conv[..., :, None, :] % q * pw % q              # [..., A, s, M]
    e8 = 8 * np.arange(4)
    byte = (val[..., None] >> e8) & 255                   # [..., A, s, M, e]
    ae = np.zeros(tuple(lead) + (4, 16 * MT, CHUNK, 4), dtype=np.uint8)
    ae[..., :M, :A, :] = np.moveaxis(byte, (-1, -2), (-4, -3))
    # the largest byte s of a residue below each input prime
    top = np.zeros((CHUNK, 4), dtype=np.int64)
    top[:A] = np.minimum((pin[:, None] - 1) >> e8, 255)
    return ae, (ae.astype(np.int64) * top).sum((-2, -1))


def _fragments(ae) -> np.ndarray:
    """Digit matrix bytes [..., e, 16 MT, CHUNK, s] -> int32 [..., MT, 4,
    32, 4] in mma.sync m16n8k32's A-fragment order (uint32 bits)."""
    *lead, _, rows, _, _ = ae.shape
    words = np.ascontiguousarray(ae).view("<u4")[..., 0]   # [..., e, row, a]
    words = words.reshape(tuple(lead) + (4, rows // 16, 16, CHUNK))
    frag = words[..., FRAG_ROW, FRAG_WORD]                # [..., e, MT, l, r]
    return _bits32(np.moveaxis(frag, -4, -3))


def fold_group(peaks, qs, vmax: int = 0) -> int:
    """The chunks one fold of the kernels may take: the largest g such that
    summing the products of every g consecutive chunks (the last run
    shorter) keeps the fold exact for every output row.  peaks int64
    [nch, 4, rows] (each chunk's largest S_e, `_digit_bytes`), qs [M] the
    output primes (rows past M repeat the last), vmax the largest v_hat
    (ks_moddown's; it enters the first fold only).  Exact means: every sum
    S_e < 2^31 (the mma's s32 accumulator), L = S_0 + 2^8 S_1 and
    H = S_2 + 2^8 S_3 below 2^32 (the fold's 32-bit halves), and
    x = L + 2^16 H + v corr (corr < q) with floor(x / 2^32) < q, so that
    the Montgomery step leaves r in (-q, q): canonical after one
    conditional addition.  Raises if one chunk alone breaks it."""
    peaks = np.asarray(peaks, dtype=np.int64)
    nch, _, rows = peaks.shape
    q = np.asarray([int(v) for v in qs], dtype=np.int64)
    qrow = np.concatenate([q, np.full(rows - len(q), q[-1])])
    for g in range(nch, 0, -1):
        ok = True
        for c0 in range(0, nch, g):
            S = peaks[c0:c0 + g].sum(0)                   # [e, rows]
            low = S[0] + (S[1] << 8)
            high = S[2] + (S[3] << 8)
            x = low + (high << 16) + (vmax * (qrow - 1) if c0 == 0 else 0)
            if S.max() >= 1 << 31 or max(low.max(), high.max()) >= 1 << 32 \
                    or np.any((x >> 32) >= qrow):
                ok = False
                break
        if ok:
            return g
    raise ValueError("digit_tables: a digit product could overflow the "
                     "32-bit fold")


def digit_tables(conv, qs, in_primes, vmax: int = 0) -> np.ndarray:
    """The u8 digit matrices of one chunk of a conversion out[m] =
    sum_a y_a conv[a, m] mod qs[m], y_a < in_primes[a], in mma.sync
    m16n8k32's A-fragment order: conv [..., A, M] (A <= CHUNK) -> int32
    [..., MT, 4, 32, 4] (MT = ceil(M / 16) row tiles, digit e, lane,
    register; uint32 bits), A_e[m, 4a + s] = byte_e(conv[a, m] 256^s 2^32
    mod q_m), zero past A limbs and M rows (the factor 2^32 cancels the
    fold's Montgomery step).  Raises unless the kernels' fold is exact for
    the largest bytes the inputs can have (`fold_group`), and for odd
    primes below 2^31: above 2^15 x < 2^47; a prime below 2^16 has zero
    bytes 2 and 3 in A, so H = 0 and x < 2^32."""
    ae, peak = _digit_bytes(conv, qs, in_primes)
    fold_group(peak.reshape((-1,) + peak.shape[-2:]).max(0)[None], qs, vmax)
    return _fragments(ae)


def chunked_tables(conv, qs, in_primes, vmax: int = 0):
    """`digit_tables` of each chunk of CHUNK limbs: conv [A, M] ->
    (int32 [ceil(A / CHUNK), MT, 4, 32, 4], the chunks a fold may take,
    `fold_group`); in_primes [A] (a limb past the digit's has prime 1: no
    input, zero bytes)."""
    conv = np.asarray(conv, dtype=np.int64)
    pin = np.asarray(in_primes, dtype=np.int64)
    nch = -(-conv.shape[0] // CHUNK)
    parts = [_digit_bytes(conv[c * CHUNK:(c + 1) * CHUNK], qs,
                          pin[c * CHUNK:(c + 1) * CHUNK])
             for c in range(nch)]
    group = fold_group(np.stack([pk for _, pk in parts]), qs, vmax)
    return np.stack([_fragments(ae) for ae, _ in parts]), group


def chunk_instance(nch: int, group: int) -> int:
    """The chunked kernels' instance (its NCH) that nch chunks folded every
    `group` chunks launch."""
    return nch if nch in HELD_CHUNKS and group >= nch else 0


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
    `dinvsh` [J, W], conv_w `conv` [J, W, M] (W = nch * CHUNK, nch the
    widest digit's chunks; zero past a digit's limbs) and the basis primes
    `bq` [M]; `cuts[j]`, the limbs before which the plain version reduces
    its lazy sum.  On a CUDA device also the kernel's `kernel_tables()`:
    the digit matrices `afrag` [J, nch, MT, 4, 32, 4] (`chunked_tables`),
    the fold's constants `bfold` [3, M] (`fold_table`) and `group`, the
    chunks one fold takes (`fold_group`, the least over the digits); else
    None."""

    def __init__(self, params, level: int, device):
        kst = params.ks_tables(level)
        groups = kst["groups"]
        basis = [int(q) for q in kst["basis"]]
        J, M = len(groups), len(basis)
        nch = max(-(-len(g["limbs"]) // CHUNK) for g in groups)
        W = nch * CHUNK
        dig = np.zeros((J, 2), dtype=np.int32)
        dq = np.zeros((J, W), dtype=np.uint64)
        dinv = np.zeros((J, W), dtype=np.uint64)
        dinvsh = np.zeros((J, W), dtype=np.uint64)
        conv = np.zeros((J, W, M), dtype=np.uint64)
        self.cuts = []
        for j, g in enumerate(groups):
            limbs = list(g["limbs"])
            a = len(limbs)
            if limbs != list(range(limbs[0], limbs[0] + a)):
                raise ValueError(f"ks_modup: digit {j} at level {level} is "
                                 f"not a contiguous limb range")
            qa = [int(params.q_primes[i]) for i in limbs]
            self.cuts.append(lazy_reductions(
                f"ks_modup digit {j} at level {level}",
                [(q - 1) * (max(basis) - 1) for q in qa], max(basis) - 1))
            dig[j] = (limbs[0], a)
            dq[j, :a] = qa
            dinv[j, :a] = g["inv_w"]
            dinvsh[j, :a] = g["inv_sh"]
            conv[j, :a] = g["conv_w"]
        self.level, self.J, self.M, self.nch = level, J, M, nch

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.dig = up(dig)
        self.dq, self.dinv, self.dinvsh, self.conv, self.bq = (
            up(_bits32(a)) for a in (dq, dinv, dinvsh, conv, basis))
        self.afrag = self.bfold = self.group = None
        if torch.device(device).type == "cuda":
            self.afrag, self.bfold, self.group = self.kernel_tables()

    def kernel_tables(self):
        """(afrag, bfold, group) on the tables' device, from their
        constants."""
        conv, dq, basis = (_widen(t).cpu().numpy()
                           for t in (self.conv, self.dq, self.bq))
        # a digit's unused limbs have prime 0 here: no input, zero bytes
        tabs = [chunked_tables(conv[j], basis, np.maximum(dq[j], 1))
                for j in range(self.J)]
        return (torch.from_numpy(np.stack([a for a, _ in tabs]))
                .to(self.bq.device),
                torch.from_numpy(fold_table(basis)).to(self.bq.device),
                min(g for _, g in tabs))


class ModdownTables:
    """ks_moddown's constants of one level on one device: the special
    primes `sp`, inv_w `sinv` and Shoup companions `sinvsh` [K], 1/p_i
    `inv_p` (float32) [K], conv_w `conv` [K, R], the q primes `q` and
    P mod q `pmod` [R] and `cuts`, the rows before which the plain version
    reduces its lazy sum; `pinv`, sub_scale's table of P^-1 mod q
    (R = l+1).  On a CUDA device also the kernel's `kernel_tables()`:
    conv_w's digit matrices `afrag` [nch, MT, 4, 32, 4] (nch = ceil(K /
    CHUNK)), the fold's constants `fold` [3, R] with the correction
    factor -P 2^32 mod q, and `group`, the chunks one fold takes
    (`fold_group`); else None."""

    def __init__(self, params, level: int, device):
        mdt = params.md_tables(level)
        sp = [int(p) for p in params.special_primes]
        qs = [int(q) for q in params.q_primes[:level + 1]]
        K, R = len(sp), len(qs)
        self.cuts = lazy_reductions(f"ks_moddown at level {level}",
                                    [(p - 1) * (max(qs) - 1) for p in sp],
                                    max(qs) - 1)
        self.level, self.K, self.R = level, K, R
        self.nch = -(-K // CHUNK)

        def up(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        self.sp, self.sinv, self.sinvsh, self.conv, self.q, self.pmod = (
            up(_bits32(a)) for a in (sp, mdt["inv_w"], mdt["inv_sh"],
                                     mdt["conv_w"], qs, mdt["pmod_w"]))
        self.inv_p = up((1.0 / np.asarray(sp, dtype=np.float64))
                        .astype(np.float32))
        self.pinv = up(scale_table(qs, mdt["pinv_w"]))
        self.afrag = self.fold = self.group = None
        if torch.device(device).type == "cuda":
            self.afrag, self.fold, self.group = self.kernel_tables()

    def kernel_tables(self):
        """(afrag, fold, group) on the tables' device, from their
        constants."""
        conv, qs, sp, pmod = (_widen(t).cpu().numpy().tolist() for t in
                              (self.conv, self.q, self.sp, self.pmod))
        afrag, group = chunked_tables(conv, qs, sp, self.K)
        fold = fold_table(qs, [(-pm << 32) % q for pm, q in zip(pmod, qs)])
        return (torch.from_numpy(afrag).to(self.q.device),
                torch.from_numpy(fold).to(self.q.device), group)


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
            if a in tab.cuts[j]:
                acc.remainder_(bq)
            y = c[first + a].long() * _widen(tab.dinv[j, a]) \
                % _widen(tab.dq[j, a])
            acc += y[None, :] * _widen(tab.conv[j, a]).reshape(-1, 1)
        acc.remainder_(bq)
    return out.to(torch.int32)


def _fma(a, b, c):
    """float32 a * b + c rounded once (the float64 product of two float32
    values is exact; the float64 sum rounds only for a product far below
    the sum, where a double rounding needs ~29 particular bits)."""
    return (a.double() * b.double() + c.double()).float()


def vhat_frac(yf, inv_p, K: int):
    """sum_i yf_i * inv_p_i in float32 over the K special rows of yf
    [..., K, N], in XLA:CPU's order for the reference's jnp.sum (its loop
    over K, as LLVM vectorizes it at 8 float32 lanes): for K = 8 and
    K >= 16 lane l < 8 holds u_l = yf_l inv_p_l rounded, then
    u_l = fma(yf_{8c+l}, inv_p_{8c+l}, u_l) for c = 1 .. K//8 - 1; the
    lanes are added in halves (u_l + u_{l+4}, then + u_{l+2}, then
    + u_{l+1}), and the K % 8 rows left follow as a fused multiply-add
    chain from that sum.  Any other K (1-7, 9-15) is one fused
    multiply-add chain acc = fma(yf_i, inv_p_i, acc) from 0, each step
    rounded once.  Orders differ only where the sum falls within a float32
    ulp of a half-integer: v_hat then differs by one, and the result by
    one unit in that coefficient (ROADMAP queue 3)."""
    acc = torch.zeros_like(yf[..., 0:1, :])
    rows = range(K)
    lanes = XLA_LANES
    if K == lanes or K >= 2 * lanes:
        u = [yf[..., i:i + 1, :] * inv_p[i] for i in range(lanes)]
        for i in range(lanes, K // lanes * lanes):
            u[i % lanes] = _fma(yf[..., i:i + 1, :], inv_p[i], u[i % lanes])
        while len(u) > 1:
            h = len(u) // 2
            u = [u[i] + u[i + h] for i in range(h)]
        acc, rows = u[0], range(K // lanes * lanes, K)
    for i in rows:
        acc = _fma(yf[..., i:i + 1, :], inv_p[i], acc)
    return acc


def ks_moddown_plain(d, tab: ModdownTables) -> torch.Tensor:
    K = tab.K
    ps = _widen(tab.sp).reshape(-1, 1)
    y = d.long() * _widen(tab.sinv).reshape(-1, 1) % ps           # [..., K, N]
    qv = _widen(tab.q).reshape(-1, 1)
    conv = _widen(tab.conv)
    acc = None
    for i in range(K):
        if i in tab.cuts:
            acc.remainder_(qv)
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
    A_e as int32 [..., 4, 16 MT, 4 CHUNK] (e, row, k = 4a + s)."""
    f = _widen(afrag).movedim(-3, -4)                     # [..., e, MT, l, r]
    *lead, MT = f.shape[:-2]
    words = torch.empty(tuple(lead) + (MT, 16, CHUNK), dtype=torch.int64,
                        device=f.device)
    words[..., torch.as_tensor(FRAG_ROW), torch.as_tensor(FRAG_WORD)] = f
    shifts = 8 * torch.arange(4, device=f.device)
    byte = (words[..., None] >> shifts) & 255             # [..., MT, 16, a, s]
    return byte.reshape(tuple(lead) + (16 * MT, 4 * CHUNK)).to(
        torch.int32)


def convert_digits_model(y, afrag, fold, vhat=None, group: int | None = None,
                         peaks: dict | None = None):
    """The kernels' conversion: y int64 [B, nch * CHUNK, N] (values below
    2^32; zero past the digit's limbs), afrag [nch, MT, 4, 32, 4] (nch the
    digit's own chunks), fold [3, M], vhat (ks_moddown's v_hat, int64
    [B, 1, N]), group (the chunks a fold takes, `fold_group`; all of them
    by default) -> int64 [B, M, N] canonical, computed as the kernels do:
    the bytes B[4a + s] = byte_s(y_a) of each chunk's limbs, the chunks'
    products A_e @ B summed as int32 into S_e over each run of `group`
    chunks, L = S_0 + (S_1 << 8), H = S_2 + (S_3 << 8) (32-bit),
    x = L + 2^16 H (+ vhat corr in the first run), then the Montgomery step
    m = x_lo q^-1 mod 2^32, r = x_hi - hi(m q), plus q if negative; the
    runs' partials added mod q (one run: one fold a word).  `peaks` (if
    given) gets the largest S_e, L, H and x_hi - q over the runs (x_hi - q
    negative: every fold is canonical)."""
    Bn, _, N = y.shape
    M = fold.shape[1]
    nch = afrag.shape[0]
    group = nch if group is None else group
    q, qinv, corr = (_widen(fold[i]).reshape(-1, 1) for i in range(3))
    shifts = (8 * torch.arange(4, device=y.device)).reshape(1, 1, 4, 1)
    out = None
    for c0 in range(0, nch, group):
        S = 0
        for c in range(c0, min(c0 + group, nch)):
            A = _digit_matrices(afrag[c])                 # [4, Mp, 32]
            yc = y[:, c * CHUNK:(c + 1) * CHUNK]
            b = ((yc[:, :, None, :] >> shifts) & 255).reshape(Bn, 4 * CHUNK,
                                                              N)
            S = S + (A[:, None] @ b.to(torch.int32)[None])[:, :, :M].long()
        L = S[0] + (S[1] << 8)
        H = S[2] + (S[3] << 8)
        x = L + (H << 16)
        if vhat is not None and c0 == 0:
            x = x + vhat * corr
        m = (x & MASK32) * qinv & MASK32
        r = (x >> 32) - ((m * q) >> 32)
        r = torch.where(r < 0, r + q, r)
        out = r if out is None else torch.where(out + r >= q, out + r - q,
                                                out + r)
        if peaks is not None:
            for k, v in (("S", S), ("L", L), ("H", H),
                         ("xq", (x >> 32) - q)):
                peaks[k] = max(peaks.get(k, -1 << 62),
                               int(v.max()) if v.numel() else 0)
    return out


def ks_modup_model(c, tab: ModupTables, j0: int, j1: int,
                   peaks: dict | None = None) -> torch.Tensor:
    """ks_modup as the kernel computes it (`convert_digits_model` per
    digit over its own ceil(cnt / CHUNK) chunks; a padded digit zero)."""
    afrag, bfold, group = tab.kernel_tables() if tab.afrag is None else \
        (tab.afrag, tab.bfold, tab.group)
    N = c.shape[-1]
    out = torch.zeros((j1 - j0, tab.M, N), dtype=torch.int64,
                      device=c.device)
    dig = tab.dig.tolist()
    for j in range(j0, min(j1, tab.J)):
        first, cnt = dig[j]
        nch = -(-cnt // CHUNK)
        y = torch.zeros((1, nch * CHUNK, N), dtype=torch.int64,
                        device=c.device)
        y[0, :cnt] = c[first:first + cnt].long() * \
            _widen(tab.dinv[j, :cnt]).reshape(-1, 1) % \
            _widen(tab.dq[j, :cnt]).reshape(-1, 1)
        out[j - j0] = convert_digits_model(y, afrag[j, :nch], bfold,
                                           group=group, peaks=peaks)[0]
    return out.to(torch.int32)


def ks_moddown_model(d, tab: ModdownTables,
                     peaks: dict | None = None) -> torch.Tensor:
    """ks_moddown as the kernel computes it: the float32 v_hat of
    `vhat_frac` over all K rows, then `convert_digits_model` with the
    correction folded into the first fold."""
    afrag, fold, group = tab.kernel_tables() if tab.afrag is None else \
        (tab.afrag, tab.fold, tab.group)
    K = tab.K
    d3 = d if d.dim() == 3 else d[None]
    y = d3.long() * _widen(tab.sinv).reshape(-1, 1) % \
        _widen(tab.sp).reshape(-1, 1)                     # [B, K, N]
    vhat = torch.round(vhat_frac(y.to(torch.float32), tab.inv_p, K)
                       ).to(torch.int64)
    pad = torch.zeros((y.shape[0], tab.nch * CHUNK - K, y.shape[-1]),
                      dtype=torch.int64, device=y.device)
    out = convert_digits_model(torch.cat([y, pad], 1), afrag, fold, vhat,
                               group, peaks)
    return out.reshape(d.shape[:-2] + out.shape[-2:]).to(torch.int32)


def byte_extremes(primes, inv_w, pick) -> np.ndarray:
    """Residues c int64 [rows, N] whose Shoup products y = c * inv_w mod q
    have extreme bytes, the conversions' widest digit sums: pick [rows, N]
    in {0, 1, 2} gives y = 0, y = q - 1 or the largest y < q whose bytes
    below q - 1's top byte are all 0xFF (the three low bytes for a prime
    above 2^24); primes, inv_w [rows] (inv_w invertible mod q)."""
    q = np.asarray([int(v) for v in primes], dtype=np.int64)[:, None]
    w = np.asarray([pow(int(a), -1, int(b)) for a, b in zip(inv_w, primes)],
                   dtype=np.int64)[:, None]
    low = np.asarray([8 * ((int(v) - 1).bit_length() - 1 >> 3)
                      for v in primes], dtype=np.int64)[:, None]
    ff = ((q - 1) >> low << low) | ((1 << low) - 1)
    ff = np.where(ff < q, ff, ff - (1 << low))
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
    lib = _library()
    args = (c.data_ptr(), tab.dig.data_ptr(), tab.dq.data_ptr(),
            tab.dinv.data_ptr(), tab.dinvsh.data_ptr(), tab.afrag.data_ptr(),
            tab.bfold.data_ptr(), out.data_ptr(), j0, j1 - j0, tab.J, tab.M,
            N)
    err = lib.ks_modup_launch(*args, _stream(c)) if tab.nch == 1 else \
        lib.ks_modup_chunks_launch(*args, tab.nch, tab.group, _stream(c))
    if err != 0:
        raise RuntimeError(f"ks_modup kernel launch failed: CUDA error {err}")
    global launches_modup, launches_modup_chunks
    launches_modup += 1
    launches_modup_chunks += tab.nch > 1
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
    lib = _library()
    args = (d.data_ptr(), tab.sp.data_ptr(), tab.sinv.data_ptr(),
            tab.sinvsh.data_ptr(), tab.inv_p.data_ptr(), tab.afrag.data_ptr(),
            tab.fold.data_ptr(), out.data_ptr(), B, tab.K, tab.R, N)
    err = lib.ks_moddown_launch(*args, _stream(d)) if tab.nch == 1 else \
        lib.ks_moddown_chunks_launch(*args, tab.nch, tab.group, _stream(d))
    if err != 0:
        raise RuntimeError(f"ks_moddown kernel launch failed: CUDA error "
                           f"{err}")
    global launches_moddown, launches_moddown_chunks
    launches_moddown += 1
    launches_moddown_chunks += tab.nch > 1
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
        lib.ks_modup_chunks_launch.argtypes = [P] * 8 + [I] * 7 + [P]
        lib.ks_moddown_chunks_launch.argtypes = [P] * 8 + [I] * 6 + [P]
        lib.sub_scale_launch.argtypes = [P, L, L, P, L, L, P, P] + \
            [I] * 3 + [P]
        for fn in (lib.ks_modup_launch, lib.ks_moddown_launch,
                   lib.ks_modup_chunks_launch, lib.ks_moddown_chunks_launch,
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
