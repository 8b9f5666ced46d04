"""CKKS primitive operations on torch tensors.  Counterpart of
`aesfhe_tpu/core/ops_impl.py` (its main-path set, the bootstrap's pair
rescale and ModRaise included).

Conventions: ciphertext data are int32 tensors of uint32 Montgomery residues
in the NTT evaluation domain; every residue is < q <= 2^30, so int32 holds
it non-negative and `.long()` widens it.  Each function widens its inputs,
computes in int64 (see core/rns.py) and returns int32.  `tabs` is the
DeviceTables of one (params, device).  The digit inner product of every
key-switch goes through `ks_inner.ks_inner`, its basis conversions and the
epilogue of the mod-down and of the rescales through `ks_legs`, the LUT
sums (`ct_linear_combo`, `ct_linear_combo_dense`) through `lut_sum` (the
CUDA kernels on the card).  The functions the reference names with
`jax.named_scope("ckks.…")`, and the elementwise ops it leaves unnamed,
run inside profiler spans (`trace.install`, at the end of this module), so
a profile splits device time by primitive.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import trace
from . import ks_inner as ks_inner_mod
from . import ks_legs, lut_sum, ntt, rns
from .params import CKKSParams


class _RowTables:
    """Per-prime constants of one row selection (cached), and its NTT rows
    (the kernels' row vector into the full twiddle tables)."""

    def __init__(self, tabs: "DeviceTables", rows: tuple[int, ...]):
        idx = torch.as_tensor(rows, dtype=torch.int64, device=tabs.device)
        self.q = tabs.q[idx]
        self.qinv = tabs.qinv[idx]
        self.r2 = tabs.r2[idx]
        self.rinv = tabs.rinv[idx]
        self.q32 = rns.narrow(self.q)
        self.qinv32 = rns.narrow(self.qinv)
        self.ntt = tabs.ntt.rows(rows)


class DeviceTables:
    """The params' host tables as int64 tensors on one device, and the NTT
    tables of every prime (`ntt.DeviceNTT`: on a card also the kernels'
    32-bit tables), uploaded once."""

    def __init__(self, params: CKKSParams, device):
        self.device = torch.device(device)
        t = params.tables

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        self.ntt = ntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, self.device)
        self.q = dev(params.q_arr)
        self.qinv = dev(params.qinv_arr)
        self.r2 = dev(params.r2_arr)
        self.rinv = dev(params.rinv_arr)
        self.xhalf_sign_neg = torch.as_tensor(params.xhalf_sign_neg,
                                              device=self.device)
        self._rows: dict[tuple, _RowTables] = {}
        self._consts: dict = {}

    def rows(self, rows) -> _RowTables:
        key = tuple(int(r) for r in rows)
        tr = self._rows.get(key)
        if tr is None:
            tr = _RowTables(self, key)
            self._rows[key] = tr
        return tr

    def const(self, key, make, dtype=torch.int64) -> torch.Tensor:
        """A host table `make()` as a tensor on the device, uploaded once per
        key: an upload from pageable host memory waits for the device's
        queue, so per-call uploads would stall the host on every op."""
        return self.table(key, lambda: torch.as_tensor(
            np.asarray(make()), dtype=dtype, device=self.device))

    def table(self, key, make):
        """`make()` (tables already on the device), made once per key."""
        t = self._consts.get(key)
        if t is None:
            t = make()
            self._consts[key] = t
        return t


def _rows(params: CKKSParams, level: int, with_special: bool) -> np.ndarray:
    """Row indices into the all_primes axis for the active basis."""
    r = list(range(level + 1))
    if with_special:
        r += list(range(params.num_q, params.L_tot))
    return np.asarray(r, dtype=np.int32)


def _q_tr(params, tabs, level):
    return tabs.rows(_rows(params, level, False))


def _dev(a, tabs, rows=None):
    """Host numpy table -> int64 tensor on the tables' device, reshaped."""
    t = torch.as_tensor(np.asarray(a, dtype=np.int64), device=tabs.device)
    return t if rows is None else t.reshape(rows)


def ntt_rows(x, tr: _RowTables, to_mont: bool = False,
             out_dtype=torch.int64):
    """int32/int64 [..., L, N] natural -> bit-reversed eval order (the
    kernel on the card, its plain version on the CPU); to_mont converts the
    input to the Montgomery form first (rns.to_mont)."""
    return ntt.ntt_fwd(x, tr.ntt, to_mont, out_dtype)


def intt_rows(x, tr: _RowTables, from_mont: bool = False,
              out_dtype=torch.int64):
    """The inverse; from_mont converts the result out of the Montgomery
    form (rns.from_mont)."""
    return ntt.ntt_inv(x, tr.ntt, from_mont, out_dtype)


# ---------------------------------------------------------------------------
# Elementwise ciphertext ops (eval domain)
# ---------------------------------------------------------------------------

def ct_add(params, tabs, a, b):
    q = _q_tr(params, tabs, a.shape[1] - 1).q.reshape(1, -1, 1)
    return rns.add_mod(a.long(), b.long(), q).int()


def ct_sub(params, tabs, a, b):
    q = _q_tr(params, tabs, a.shape[1] - 1).q.reshape(1, -1, 1)
    return rns.sub_mod(a.long(), b.long(), q).int()


def ct_negate(params, tabs, a):
    q = _q_tr(params, tabs, a.shape[1] - 1).q.reshape(1, -1, 1)
    return rns.neg_mod(a.long(), q).int()


def ct_tensor(params, tabs, a, b):
    """Degree-1 x degree-1 tensor product -> degree-2 data [3, l+1, N]."""
    tr = _q_tr(params, tabs, a.shape[1] - 1)
    q = tr.q.reshape(-1, 1)
    ri = tr.rinv.reshape(-1, 1)
    a0, a1 = a[0].long(), a[1].long()
    b0, b1 = b[0].long(), b[1].long()
    d0 = rns.mont_mul(a0, b0, q, ri)
    d1 = rns.add_mod(rns.mont_mul(a0, b1, q, ri), rns.mont_mul(a1, b0, q, ri), q)
    d2 = rns.mont_mul(a1, b1, q, ri)
    return torch.stack([d0, d1, d2]).int()


def ct_mul_dense_pt(params, tabs, a, pt):
    """ct [k, l+1, N] x dense plaintext [l+1, N]."""
    tr = _q_tr(params, tabs, a.shape[1] - 1)
    return rns.mont_mul(a.long(), pt.long()[None], tr.q.reshape(1, -1, 1),
                        tr.rinv.reshape(1, -1, 1)).int()


def ct_mul_scalar_pt(params, tabs, a, consts):
    """ct x slot-constant complex plaintext; consts int32 [l+1, 4]."""
    q = _q_tr(params, tabs, a.shape[1] - 1).q.reshape(1, -1, 1)
    return lut_sum.scalar_terms(a.long(), consts[None], q,
                                tabs.xhalf_sign_neg).int()


def ct_add_scalar_pt(params, tabs, a, consts_mont):
    """ct + slot-constant complex plaintext; consts_mont int32 [l+1, 2]
    (re_mont, imz_mont).  Only the degree-0 component changes."""
    q = _q_tr(params, tabs, a.shape[1] - 1).q.reshape(-1, 1)
    re_m = consts_mont[:, 0:1].long()
    imz_m = consts_mont[:, 1:2].long()
    neg = tabs.xhalf_sign_neg[None, :]
    pt_eval = torch.where(neg, rns.sub_mod(re_m, imz_m, q),
                          rns.add_mod(re_m, imz_m, q))
    out = a.clone()
    out[0] = rns.add_mod(a[0].long(), pt_eval, q).int()
    return out


def ct_linear_combo(params, tabs, stack, consts):
    """sum_k stack[k] * scalar_pt(consts[k]); stack [K, deg+1, l+1, N],
    consts [K, l+1, 4].  Returns [deg+1, l+1, N] (caller rescales).  One
    launch of the LUT-sum kernel on the card (lut_sum.lut_sum)."""
    return lut_sum.lut_sum(stack, consts, tabs.xhalf_sign_neg,
                           _q_tr(params, tabs, stack.shape[2] - 1))


def ct_linear_combo_dense(params, tabs, stack, pts):
    """sum_k stack[k] * dense_pt[k]; stack [K, deg+1, l+1, N], pts
    [K, l+1, N] Montgomery eval.  Returns [deg+1, l+1, N].  One launch of
    the LUT-sum kernel on the card (lut_sum.lut_sum_dense)."""
    return lut_sum.lut_sum_dense(stack, pts,
                                 _q_tr(params, tabs, stack.shape[2] - 1))


def ct_tensor_sum(params, tabs, a_stack, b_stack):
    """sum_k tensor(a[k], b[k]) -> degree-2 data [3, l+1, N]; a_stack and
    b_stack [K, 2, l+1, N]."""
    tr = _q_tr(params, tabs, a_stack.shape[2] - 1)
    q = tr.q.reshape(-1, 1)
    d0 = d1 = d2 = None
    for k in range(a_stack.shape[0]):
        a0, a1 = a_stack[k, 0].long(), a_stack[k, 1].long()
        b0, b1 = b_stack[k, 0].long(), b_stack[k, 1].long()
        t0 = (a0 * b0) % q
        t1 = (a0 * b1) % q + (a1 * b0) % q
        t2 = (a1 * b1) % q
        d0, d1, d2 = ((t0, t1, t2) if d0 is None
                      else (d0 + t0, d1 + t1, d2 + t2))
    ri = tr.rinv.reshape(-1, 1)
    return torch.stack([(d % q) * ri % q for d in (d0, d1, d2)]).int()


def walsh_sub_bytes_core(params, tabs, a_stack, b_stack, consts):
    """All 8 Walsh-LUT output planes from two character bases.

    a_stack/b_stack: [U=16, 2, l+1, N]; consts: [8, U, V, l+1, 2] (w, w_shoup)
    of the real Walsh weights at the combine scale.  Returns [8, 3, l+1, N]
    degree-2 pre-relin sums out[k] = sum_u a[u] * (sum_v consts[k,u,v] b[v]).
    Per u the combined right-hand side is consumed at once, so one
    [8, 2, l+1, N] slice is live at a time."""
    tr = _q_tr(params, tabs, a_stack.shape[2] - 1)
    q1 = tr.q.reshape(1, 1, -1, 1)
    q2 = tr.q.reshape(1, -1, 1)
    b = b_stack.long()
    d0 = d1 = d2 = None
    for u in range(a_stack.shape[0]):
        rhs = None                                    # [8, 2, l+1, N]
        for v in range(b.shape[0]):
            w = consts[:, u, v, None, :, 0:1].long()  # [8, 1, l+1, 1]
            t = (b[v][None] * w) % q1
            rhs = t if rhs is None else rhs + t
        rhs %= q1
        a0 = a_stack[u, 0].long()[None]
        a1 = a_stack[u, 1].long()[None]
        r0, r1 = rhs[:, 0], rhs[:, 1]
        t0 = (a0 * r0) % q2
        t1 = (a0 * r1) % q2 + (a1 * r0) % q2
        t2 = (a1 * r1) % q2
        d0, d1, d2 = ((t0, t1, t2) if d0 is None
                      else (d0 + t0, d1 + t1, d2 + t2))
    ri = tr.rinv.reshape(1, -1, 1)
    return torch.stack([(d % q2) * ri % q2 for d in (d0, d1, d2)],
                       dim=1).int()


def ct_automorphism(params, tabs, a, perm):
    """Galois automorphism as an eval-domain gather; perm int64 [N]."""
    return a[..., perm]


# ---------------------------------------------------------------------------
# Rescale and level drop
# ---------------------------------------------------------------------------

def ct_rescale(params, tabs, a):
    """Drop the top prime q_l: out[i] = (a[i] - lift(a[l])) / q_l mod q_i,
    with centered lifting of the dropped limb.  [k, l+1, N] -> [k, l, N]."""
    k, lp1, n = a.shape
    level = lp1 - 1
    assert level >= 1, "no levels left to rescale"
    ql = int(params.q_primes[level])
    tr_rest = _q_tr(params, tabs, level - 1)
    tr_last = tabs.rows([level])
    last_plain = intt_rows(a[:, level:level + 1, :], tr_last, from_mont=True)
    q_rest = tr_rest.q.reshape(1, -1, 1)
    red = rns.barrett_reduce(last_plain, q_rest)
    rest = [int(q) for q in params.q_primes[:level]]
    ql_mod = tabs.const(("ql_mod", level),
                        lambda: [ql % q for q in rest]).reshape(1, -1, 1)
    lifted = torch.where(last_plain >= (ql + 1) // 2,
                         rns.sub_mod(red, ql_mod, q_rest), red)
    lifted_eval = ntt_rows(lifted, tr_rest, to_mont=True,
                           out_dtype=torch.int32)
    qlinv = tabs.const(("rescale_w", level), lambda: ks_legs.scale_table(
        rest, [pow(ql, -1, q) for q in rest]), dtype=torch.int32)
    return ks_legs.sub_scale(a[:, :level, :], lifted_eval, qlinv)


def ct_rescale_pair(params, tabs, a):
    """Drop the top two primes q_a = q_l, q_b = q_{l-1} with one rounding:
    Garner-combine the two dropped limbs into v mod q_a*q_b, lift the
    centred v into every remaining prime, subtract, multiply by
    (q_a*q_b)^-1.  [k, l+1, N] -> [k, l-1, N]."""
    k, lp1, n = a.shape
    level = lp1 - 1
    assert level >= 2, "need two droppable limbs"
    qa = int(params.q_primes[level])
    qb = int(params.q_primes[level - 1])
    tr_rest = _q_tr(params, tabs, level - 2)
    tr_pair = tabs.rows([level - 1, level])
    pair_plain = intt_rows(a[:, level - 1:, :], tr_pair, from_mont=True)
    v_b = pair_plain[:, 0:1, :]                          # value mod q_b
    v_a = pair_plain[:, 1:2, :]                          # value mod q_a
    # Garner: v = v_a + q_a * t,  t = (v_b - v_a) * q_a^-1 mod q_b
    t = rns.shoup_mul(rns.sub_mod(v_b, rns.barrett_reduce(v_a, qb), qb),
                      pow(qa % qb, -1, qb), qb)
    # exact centred test: v >= (q_a*q_b + 1)/2  <=>
    #   t > (q_b-1)/2  or  (t == (q_b-1)/2 and v_a >= (q_a+1)/2)
    h = (qb - 1) // 2
    high = (t > h) | ((t == h) & (v_a >= (qa + 1) // 2))
    q_rest = tr_rest.q.reshape(1, -1, 1)
    rest = [int(q) for q in params.q_primes[:level - 1]]

    def const(name, make):
        return tabs.const((name, level), make).reshape(1, -1, 1)

    qa_mod = const("pair_qa", lambda: [qa % q for q in rest])
    qab_mod = const("pair_qab", lambda: [qa * qb % q for q in rest])
    qab_inv = tabs.const(("pair_scale", level), lambda: ks_legs.scale_table(
        rest, [pow(qa * qb % q, -1, q) for q in rest]), dtype=torch.int32)
    lift = rns.add_mod(rns.barrett_reduce(v_a, q_rest),
                       rns.shoup_mul(rns.barrett_reduce(t, q_rest), qa_mod,
                                     q_rest), q_rest)
    lifted = torch.where(high, rns.sub_mod(lift, qab_mod, q_rest), lift)
    return ks_legs.sub_scale(a[:, :level - 1, :],
                             ntt_rows(lifted, tr_rest, to_mont=True,
                                      out_dtype=torch.int32), qab_inv)


def ct_drop_to(params: CKKSParams, a, target_level: int):
    """Modulus switch down by dropping limbs (scale unchanged)."""
    return a[:, :target_level + 1, :]


def mod_raise_core(params, tabs, a):
    """Bootstrap ModRaise: [k, 1, N] over q0 -> [k, num_q, N] over the full
    chain by centred-lifting the bottom-prime coefficients into every prime
    (the plaintext becomes m + q0*I)."""
    q0 = int(params.q_primes[0])
    tr0 = tabs.rows([0])
    tr_all = _q_tr(params, tabs, params.top_level)
    plain = intt_rows(a, tr0, from_mont=True)                  # [k, 1, N]
    qv = tr_all.q.reshape(1, -1, 1)
    q0_mod = tabs.const(("q0_mod",), lambda: [q0 % int(q) for q in
                                              params.q_primes])
    red = rns.barrett_reduce(plain, qv)
    lifted = torch.where(plain >= (q0 + 1) // 2,
                         rns.sub_mod(red, q0_mod.reshape(1, -1, 1), qv), red)
    return ntt_rows(lifted, tr_all, to_mont=True, out_dtype=torch.int32)


# ---------------------------------------------------------------------------
# Hybrid key-switch
# ---------------------------------------------------------------------------

def ks_decompose(params, tabs, c_eval, j0: int = 0, j1: int | None = None):
    """Digit-decompose, basis-extend and NTT a polynomial for key switching.

    c_eval int32 [l+1, N] -> d_eval int32 [j1 - j0, M, N] (Montgomery eval
    over active q + specials): digits j0 <= j < j1, by default every digit
    active at this level.  A digit past the active ones is padding and
    comes out zero, as the reference's padded digit tables
    (`parallel/dist_keyswitch.py:_padded_digit_tables`: inv_w = 0) make it,
    so a rank of the digit-sharded key-switch extends and NTTs only its own
    digits.  Automorphisms commute with it limb-wise, so one decomposition
    serves every rotation of a hoisted batch."""
    lp1, n = c_eval.shape
    level = lp1 - 1
    groups = params.ks_tables(level)["groups"]
    j1 = len(groups) if j1 is None else j1
    tr_b = tabs.rows(_rows(params, level, True))
    live = range(j0, min(j1, len(groups)))
    npad = j1 - j0 - len(live)

    def padding():
        return torch.zeros((npad, len(tr_b.q), n), dtype=torch.int32,
                           device=c_eval.device)

    if not live:
        return padding()
    tr_q = _q_tr(params, tabs, level)
    c_plain = intt_rows(c_eval, tr_q, from_mont=True, out_dtype=torch.int32)
    tab = tabs.table(("ks_modup", level), lambda: ks_legs.ModupTables(
        params, level, tabs.device))
    # ext[j, m] = sum_{a in digit j} y_a * (Qt_j/q_a mod basis_m) mod basis_m
    ext = ks_legs.ks_modup(c_plain, tab, live.start, live.stop)
    out = ntt_rows(ext, tr_b, to_mont=True, out_dtype=torch.int32)
    return torch.cat([out, padding()]) if npad else out


def _key_rows(params: CKKSParams, level: int, key_cap):
    """Physical row indices of (q_0..q_level | specials) inside a switch key
    stored with `key_cap` (None = full basis layout)."""
    if key_cap is None:
        return np.asarray(_rows(params, level, True), dtype=np.int32)
    assert level <= key_cap, (
        f"switch key capped at level {key_cap} used at level {level}")
    K = params.num_special
    return np.concatenate([np.arange(level + 1),
                           key_cap + 1 + np.arange(K)]).astype(np.int32)


def _ks_inner(d_eval, key_b, key_a, rows_key, tr_b: _RowTables):
    """Digit inner product over [J, M, N] operands (the CUDA kernel on the
    card, its plain version on the CPU)."""
    return ks_inner_mod.ks_inner(d_eval, key_b, key_a, rows_key,
                                 tr_b.q32, tr_b.qinv32)


def ks_inner_and_moddown(params, tabs, d_eval, key_b, key_a, key_cap=None):
    """Inner product of extended digits with a switch key + P mod-down."""
    M = d_eval.shape[1]
    level = M - 1 - params.num_special
    tr_b = tabs.rows(_rows(params, level, True))
    acc = _ks_inner(d_eval, key_b, key_a, _key_rows(params, level, key_cap),
                    tr_b)
    ba = _mod_down_specials(params, tabs, acc, level)
    return ba[0], ba[1]


def hoisted_rotate(params, tabs, data, d_eval, perm, key_b, key_a,
                   key_cap=None):
    """One Galois rotation given the shared decomposition d_eval of c1:
    permute the extended digits, inner-product with the rotation's key,
    mod-down, add the permuted c0."""
    p0 = data[0][..., perm]
    b, a = ks_inner_and_moddown(params, tabs, d_eval[..., perm].contiguous(),
                                key_b, key_a, key_cap)
    q = _q_tr(params, tabs, data.shape[1] - 1).q.reshape(-1, 1)
    return torch.stack([rns.add_mod(p0.long(), b.long(), q).int(), a])


def keyswitch(params, tabs, c_eval, key_b, key_a, key_cap=None):
    """Switch a single polynomial c (under s') to a pair (b, a) under s.

    c_eval int32 [l+1, N]; key_b/key_a int32 [dnum, rows, N] (full basis or
    the level-capped layout of key_cap, see keys.SwitchKey.cap)."""
    d_eval = ks_decompose(params, tabs, c_eval)
    return ks_inner_and_moddown(params, tabs, d_eval, key_b, key_a, key_cap)


def _mod_down_specials(params, tabs, x, level: int):
    """x int32 or int64 [..., l+1+K, N] (canonical residues) over (active q
    | specials) -> int32 [..., l+1, N] ~ x / P: one iNTT of the K special
    rows, the approximate CRT conversion P -> active q with the centered
    overshoot correction (`ks_legs.ks_moddown`), one NTT of the q rows,
    then (x_q - conv) * P^-1 (`ks_legs.sub_scale`).

    The raw conversion sum_i y_i (P/p_i) equals [x]_P + v P for an integer
    v in [0, K); v_hat = round(sum_i y_i / p_i) in float32 removes it, the
    sum in the order the reference's compiled reduction takes
    (`ks_legs.vhat_frac`), so v_hat is the same integer."""
    K = params.num_special
    lp1 = level + 1
    tr_s = tabs.rows(np.arange(params.num_q, params.num_q + K))
    tr_q = _q_tr(params, tabs, level)
    tab = tabs.table(("ks_moddown", level), lambda: ks_legs.ModdownTables(
        params, level, tabs.device))
    d_plain = intt_rows(x[..., lp1:, :], tr_s, from_mont=True,
                        out_dtype=torch.int32)
    conv = ks_legs.ks_moddown(d_plain, tab)
    conv_eval = ntt_rows(conv, tr_q, to_mont=True, out_dtype=torch.int32)
    return ks_legs.sub_scale(x[..., :lp1, :].to(torch.int32), conv_eval,
                             tab.pinv)


def _mod_down_specials_exact(params, tabs, x, level: int):
    """Exact (rounding) mod-down oracle: divides by the special primes one
    at a time with centered lifting.  x int64 [l+1+K, N] -> int64 [l+1, N]."""
    K = params.num_special
    lp1 = level + 1
    cur = x[:lp1]
    spec = [x[lp1 + i:lp1 + i + 1] for i in range(K)]
    tr_q = _q_tr(params, tabs, level)
    qv = tr_q.q.reshape(-1, 1)
    q_list = [int(q) for q in params.q_primes[:lp1]]
    for si in range(K):
        p = int(params.special_primes[si])
        tr_s = tabs.rows([params.num_q + si])
        d_plain = intt_rows(spec[si], tr_s, from_mont=True)
        neg_branch = d_plain >= (p + 1) // 2
        red = rns.barrett_reduce(d_plain, qv)
        p_mod = _dev([p % q for q in q_list], tabs, (-1, 1))
        lifted = torch.where(neg_branch, rns.sub_mod(red, p_mod, qv), red)
        diff = rns.sub_mod(cur, ntt_rows(lifted, tr_q, to_mont=True), qv)
        cur = rns.shoup_mul(diff, _dev([pow(p, -1, q) for q in q_list], tabs,
                                       (-1, 1)), qv)
        for sj in range(si + 1, K):
            pj = int(params.special_primes[sj])
            trj = tabs.rows([params.num_q + sj])
            redj = rns.barrett_reduce(d_plain, pj)
            liftedj = torch.where(neg_branch,
                                  rns.sub_mod(redj, p % pj, pj), redj)
            dj = rns.sub_mod(spec[sj], ntt_rows(liftedj, trj, to_mont=True),
                             pj)
            spec[sj] = rns.shoup_mul(dj, pow(p, -1, pj), pj)
    return cur


trace.install(sys.modules[__name__])
