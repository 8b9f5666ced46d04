"""CKKS primitive operations on torch tensors.  Counterpart of
`aesfhe_tpu/core/ops_impl.py` (its main-path set, the bootstrap's pair
rescale and ModRaise included).

Conventions: ciphertext data are int32 tensors of uint32 Montgomery residues
in the NTT evaluation domain; every residue is < q <= 2^30, so int32 holds
it non-negative and `.long()` widens it.  Each function widens its inputs,
computes in int64 (see core/rns.py) and returns int32.  `tabs` is the
DeviceTables of one (params, device).  The digit inner product of every
key-switch goes through `ks_inner.ks_inner` (the CUDA kernel on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from . import ks_inner as ks_inner_mod
from . import ntt, rns
from .params import CKKSParams


class _RowTables:
    """Per-prime constants of one row selection (cached), plus twiddle
    tables sliced on demand: a view when the rows are one contiguous run."""

    def __init__(self, tabs: "DeviceTables", rows: tuple[int, ...]):
        idx = torch.as_tensor(rows, dtype=torch.int64, device=tabs.device)
        self._tabs = tabs
        self.q = tabs.q[idx]
        self.qinv = tabs.qinv[idx]
        self.r2 = tabs.r2[idx]
        self.rinv = tabs.rinv[idx]
        self.ninv = tabs.ninv[idx]
        self.q32 = rns.narrow(self.q)
        self.qinv32 = rns.narrow(self.qinv)
        runs = []
        for r in rows:
            if runs and runs[-1][1] == r:
                runs[-1][1] = r + 1
            else:
                runs.append([r, r + 1])
        self._runs = runs

    def _take(self, full):
        if len(self._runs) == 1:
            a, b = self._runs[0]
            return full[a:b]
        return torch.cat([full[a:b] for a, b in self._runs])

    def w(self):
        return self._take(self._tabs.w)

    def wi(self):
        return self._take(self._tabs.wi)


class DeviceTables:
    """The params' host tables as int64 tensors on one device."""

    def __init__(self, params: CKKSParams, device):
        self.device = torch.device(device)
        t = params.tables

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        self.w = dev(t.w)
        self.wi = dev(t.wi)
        self.ninv = dev(t.ninv)
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
        t = self._consts.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(make()), dtype=dtype,
                                device=self.device)
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


def ntt_rows(x, tr: _RowTables):
    """int64 [..., L, N] natural -> bit-reversed eval order."""
    return ntt.ntt_fwd(x, tr.w(), tr.q)


def intt_rows(x, tr: _RowTables):
    return ntt.ntt_inv(x, tr.wi(), tr.q, tr.ninv)


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


def _scalar_terms(x, consts, q, neg):
    """x * (re + s_i * imz) with s_i = -1 on xhalf_sign_neg slots; consts
    columns (re_w, re_shoup, imz_w, imz_shoup), shaped to broadcast."""
    t_re = rns.shoup_mul(x, consts[..., 0:1].long(), q)
    t_im = rns.shoup_mul(x, consts[..., 2:3].long(), q)
    return torch.where(neg, rns.sub_mod(t_re, t_im, q),
                       rns.add_mod(t_re, t_im, q))


def ct_mul_scalar_pt(params, tabs, a, consts):
    """ct x slot-constant complex plaintext; consts int32 [l+1, 4]."""
    q = _q_tr(params, tabs, a.shape[1] - 1).q.reshape(1, -1, 1)
    return _scalar_terms(a.long(), consts[None], q,
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
    consts [K, l+1, 4].  Returns [deg+1, l+1, N] (caller rescales)."""
    q = _q_tr(params, tabs, stack.shape[2] - 1).q.reshape(1, -1, 1)
    acc = None
    for k in range(stack.shape[0]):
        t = _scalar_terms(stack[k].long(), consts[k][None], q,
                          tabs.xhalf_sign_neg)
        acc = t if acc is None else rns.add_mod(acc, t, q)
    return acc.int()


def ct_linear_combo_dense(params, tabs, stack, pts):
    """sum_k stack[k] * dense_pt[k]; stack [K, deg+1, l+1, N], pts
    [K, l+1, N] Montgomery eval.  Returns [deg+1, l+1, N]."""
    tr = _q_tr(params, tabs, stack.shape[2] - 1)
    q = tr.q.reshape(1, -1, 1)
    acc = None
    for k in range(stack.shape[0]):
        t = (stack[k].long() * pts[k].long()[None]) % q
        acc = t if acc is None else acc + t
    # sum_k mont_mul(x_k, p_k) = (sum_k x_k p_k mod q) * 2^-32 mod q
    return ((acc % q) * tr.rinv.reshape(1, -1, 1) % q).int()


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
    last = a[:, level:level + 1, :].long()
    last_plain = rns.from_mont(intt_rows(last, tr_last),
                               tr_last.q.reshape(1, -1, 1),
                               tr_last.rinv.reshape(1, -1, 1))
    q_rest = tr_rest.q.reshape(1, -1, 1)
    red = rns.barrett_reduce(last_plain, q_rest)
    rest = [int(q) for q in params.q_primes[:level]]
    ql_mod = tabs.const(("ql_mod", level),
                        lambda: [ql % q for q in rest]).reshape(1, -1, 1)
    lifted = torch.where(last_plain >= (ql + 1) // 2,
                         rns.sub_mod(red, ql_mod, q_rest), red)
    lifted_m = rns.to_mont(lifted, q_rest, tr_rest.r2.reshape(1, -1, 1),
                           tr_rest.rinv.reshape(1, -1, 1))
    lifted_eval = ntt_rows(lifted_m, tr_rest)
    qlinv = tabs.const(("qlinv", level),
                       lambda: [pow(ql, -1, q) for q in rest]).reshape(1, -1, 1)
    diff = rns.sub_mod(a[:, :level, :].long(), lifted_eval, q_rest)
    return rns.shoup_mul(diff, qlinv, q_rest).int()


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
    pair_plain = rns.from_mont(intt_rows(a[:, level - 1:, :].long(), tr_pair),
                               tr_pair.q.reshape(1, -1, 1),
                               tr_pair.rinv.reshape(1, -1, 1))
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
    qab_inv = const("pair_qab_inv",
                    lambda: [pow(qa * qb % q, -1, q) for q in rest])
    lift = rns.add_mod(rns.barrett_reduce(v_a, q_rest),
                       rns.shoup_mul(rns.barrett_reduce(t, q_rest), qa_mod,
                                     q_rest), q_rest)
    lifted = torch.where(high, rns.sub_mod(lift, qab_mod, q_rest), lift)
    lifted_m = rns.to_mont(lifted, q_rest, tr_rest.r2.reshape(1, -1, 1),
                           tr_rest.rinv.reshape(1, -1, 1))
    diff = rns.sub_mod(a[:, :level - 1, :].long(),
                       ntt_rows(lifted_m, tr_rest), q_rest)
    return rns.shoup_mul(diff, qab_inv, q_rest).int()


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
    plain = rns.from_mont(intt_rows(a.long(), tr0), tr0.q.reshape(1, -1, 1),
                          tr0.rinv.reshape(1, -1, 1))          # [k, 1, N]
    qv = tr_all.q.reshape(1, -1, 1)
    q0_mod = tabs.const(("q0_mod",), lambda: [q0 % int(q) for q in
                                              params.q_primes])
    red = rns.barrett_reduce(plain, qv)
    lifted = torch.where(plain >= (q0 + 1) // 2,
                         rns.sub_mod(red, q0_mod.reshape(1, -1, 1), qv), red)
    lifted_m = rns.to_mont(lifted, qv, tr_all.r2.reshape(1, -1, 1),
                           tr_all.rinv.reshape(1, -1, 1))
    return ntt_rows(lifted_m, tr_all).int()


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
    c_plain = rns.from_mont(intt_rows(c_eval.long(), tr_q),
                            tr_q.q.reshape(-1, 1), tr_q.rinv.reshape(-1, 1))
    q_basis = tr_b.q.reshape(1, -1, 1)
    digits = []
    for j in live:
        g = groups[j]
        limbs = g["limbs"]
        qg = tabs.const(("ksd_q", level, j),
                        lambda: [params.q_primes[i] for i in limbs])
        inv_w = tabs.const(("ksd_inv", level, j), lambda: g["inv_w"])
        conv_w = tabs.const(("ksd_conv", level, j), lambda: g["conv_w"])
        y = rns.shoup_mul(c_plain[limbs[0]:limbs[-1] + 1],
                          inv_w.reshape(-1, 1), qg.reshape(-1, 1))  # [a, N]
        # ext[m] = sum_a y_a * (Qt/q_a mod basis_m) mod basis_m
        terms = (y[:, None, :] * conv_w[:, :, None]) % q_basis
        digits.append(terms.sum(dim=0) % q_basis[0])
    dstack = torch.stack(digits)                                   # [d, M, N]
    qb = tr_b.q.reshape(1, -1, 1)
    dm = rns.to_mont(dstack, qb, tr_b.r2.reshape(1, -1, 1),
                     tr_b.rinv.reshape(1, -1, 1))
    out = ntt_rows(dm, tr_b).int()
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
    ba = _mod_down_specials(params, tabs, acc.long(), level).int()
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


def _vhat_frac(yf, inv_p, K: int):
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


def _mod_down_specials(params, tabs, x, level: int):
    """x int64 [..., l+1+K, N] over (active q | specials) -> int64
    [..., l+1, N] ~ x / P: one iNTT of the K special rows, the approximate
    CRT conversion P -> active q, the centered overshoot correction, one NTT
    of the q rows.

    The raw conversion sum_i y_i (P/p_i) equals [x]_P + v P for an integer
    v in [0, K); v_hat = round(sum_i y_i / p_i) in float32 removes it, the
    sum in the order the reference's compiled reduction takes
    (_vhat_frac), so v_hat is the same integer."""
    K = params.num_special
    lp1 = level + 1
    mdt = params.md_tables(level)
    nl = x.dim() - 2

    def shp(name, rows):
        return tabs.const(("md", level, name),
                          lambda: mdt[name]).reshape((1,) * nl + (rows, 1))

    tr_s = tabs.rows(np.arange(params.num_q, params.num_q + K))
    tr_q = _q_tr(params, tabs, level)
    qv = tr_q.q.reshape((1,) * nl + (lp1, 1))
    ps = tr_s.q.reshape((1,) * nl + (K, 1))

    d_plain = rns.from_mont(intt_rows(x[..., lp1:, :], tr_s), ps,
                            tr_s.rinv.reshape((1,) * nl + (K, 1)))
    y = rns.shoup_mul(d_plain, shp("inv_w", K), ps)
    conv_w = tabs.const(("md", level, "conv_w"), lambda: mdt["conv_w"])
    conv = None
    for i in range(K):
        t = (y[..., i:i + 1, :] * conv_w[i].reshape((1,) * nl + (lp1, 1))) % qv
        conv = t if conv is None else conv + t
    conv %= qv

    inv_p = tabs.const(
        ("md_inv_p",),
        lambda: (1.0 / np.asarray(params.special_primes, dtype=np.float64)
                 ).astype(np.float32), dtype=torch.float32)
    vhat = torch.round(_vhat_frac(y.to(torch.float32), inv_p, K)
                       ).to(torch.int64)
    corr = rns.shoup_mul(vhat, shp("pmod_w", lp1), qv)
    conv = rns.sub_mod(conv, corr, qv)

    conv_m = rns.to_mont(conv, qv, tr_q.r2.reshape((1,) * nl + (lp1, 1)),
                         tr_q.rinv.reshape((1,) * nl + (lp1, 1)))
    diff = rns.sub_mod(x[..., :lp1, :], ntt_rows(conv_m, tr_q), qv)
    return rns.shoup_mul(diff, shp("pinv_w", lp1), qv)


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
        d_plain = rns.from_mont(intt_rows(spec[si], tr_s),
                                tr_s.q.reshape(-1, 1), tr_s.rinv.reshape(-1, 1))
        neg_branch = d_plain >= (p + 1) // 2
        red = rns.barrett_reduce(d_plain, qv)
        p_mod = _dev([p % q for q in q_list], tabs, (-1, 1))
        lifted = torch.where(neg_branch, rns.sub_mod(red, p_mod, qv), red)
        lifted_m = rns.to_mont(lifted, qv, tr_q.r2.reshape(-1, 1),
                               tr_q.rinv.reshape(-1, 1))
        diff = rns.sub_mod(cur, ntt_rows(lifted_m, tr_q), qv)
        cur = rns.shoup_mul(diff, _dev([pow(p, -1, q) for q in q_list], tabs,
                                       (-1, 1)), qv)
        for sj in range(si + 1, K):
            pj = int(params.special_primes[sj])
            trj = tabs.rows([params.num_q + sj])
            redj = rns.barrett_reduce(d_plain, pj)
            liftedj = torch.where(neg_branch,
                                  rns.sub_mod(redj, p % pj, pj), redj)
            lm = rns.to_mont(liftedj, pj, trj.r2.reshape(-1, 1),
                             trj.rinv.reshape(-1, 1))
            dj = rns.sub_mod(spec[sj], ntt_rows(lm, trj), pj)
            spec[sj] = rns.shoup_mul(dj, pow(p, -1, pj), pj)
    return cur
