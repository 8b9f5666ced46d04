"""CKKS bootstrapping: ModRaise -> CoeffToSlot -> EvalMod -> SlotToCoeff.
Counterpart of `aesfhe_tpu/bootstrap.py`: the factored and the dense BSGS
linear maps, both flavors (regular and small), the eager `bootstrap` and
`FusedBootstrap`, which replays the whole bootstrap as one captured CUDA
graph (the reference traces it into XLA programs).

  ModRaise     reinterpret the bottom-prime residues as integers over the
               full chain: decrypts to m + q0*I with |I| <~ sqrt(h)/2
  CoeffToSlot  homomorphic inverse embedding as factored FFT-stage groups
               (hoisted-BSGS over rotation diagonals), then a conjugation
               split into the two real coefficient halves
  EvalMod      x -> (q0/Delta) sin(2 pi x Delta/q0) / (2 pi): a Chebyshev
               expansion of cos at reduced range + r double angles
  SlotToCoeff  the forward embedding back to coefficient placement

The decode matrix factors by decimation in time over the 5^j orbit into
log2(sc) two-diagonal butterfly stages, merged into radix-2^5 groups; the
CoeffToSlot groups are the conjugate transposes of the SlotToCoeff groups
and the trailing bit reversal cancels between the two (EvalMod is
slot-wise).  Both coefficient halves ride one chain as c_k + i c_{k+sc}.

With `hi_prec` (prod_boot) CoeffToSlot and EvalMod run at a paired-prime
scale ~2^54: diagonals encoded at 2^54, every product rescaled by two
primes at once (Engine.multiply_pair / fused_ptd_sum(rescales=2)).

The host half (plans, Chebyshev coefficients, EvalMod scales) is numpy and
equals the reference's; the device half runs on the engine's torch device.
Encoded diagonal stacks are kept on the device in the BootstrapKey's
`diags`, keyed (tag, gamma, level, sc_key) as the reference keys them.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from . import kernels, trace
from .core import ks_inner as ks_inner_mod
from .core import ops_impl
from .core.ciphertext import Ciphertext, Plaintext
from .core.keys import GaloisKeySet, gen_rotation_keys


@dataclass
class BootstrapKey:
    small: bool = False
    rot: GaloisKeySet | None = None
    # the dense BSGS split (factored=False): baby x giant = slot_count
    baby: int = 0
    giant: int = 0
    K: float = 0.0            # EvalMod input range |t| <= K
    cheb_deg: int = 31
    double_angles: int = 2
    # CoeffToSlot noise prescale of the single-prime tier: the chain runs on
    # values f x larger and the last group's diagonals carry 1/f
    prescale: float = 16.0
    # paired-prime (~2^54) CoeffToSlot + EvalMod (see the module docstring)
    hi_prec: bool = False
    factored: bool = True
    hi_scale: float = float(2 ** 54)
    stc_plan: list = field(default_factory=list)
    cts_plan: list = field(default_factory=list)
    # encoded diagonals on the device: factored stacks (tag, gamma, level,
    # sc_key) -> int32 [entries, level+1, N], dense diagonals (tag, d,
    # level) -> int32 [level+1, N]; and how often a lookup hit or missed
    diags: dict = field(default_factory=dict)
    diag_hits: int = 0
    diag_misses: int = 0


# ---------------------------------------------------------------------------
# Factored FFT-stage machinery (host numpy; diagonal-dict matrices)
#
# A linear map M on C^sc is stored as {delta: u} meaning
#   (M x)[k] = sum_delta u[k] * x[(k + delta) mod sc],
# i.e. u is the rotation diagonal at column offset delta; homomorphically
# each term is multiply_plain(rotate(ct, -delta), u).
# ---------------------------------------------------------------------------

def _bsgs_split(n_slots: int) -> tuple[int, int]:
    b = 1
    while b * b < n_slots:
        b *= 2
    return b, n_slots // b


def _fft_stages(params) -> list[dict]:
    """Butterfly stages of the decode map: E = S_1 * S_2 * ... * S_L * BR.
    Stage s has 2^(s-1) identical blocks of size t = sc/2^(s-1); block rows
    (i < h | i >= h), h = t/2, combine as u[i] +- tw[i]*u[i+h] with
    tw[j] = psi_C^(2^(s-1) * 5^j mod 2N)."""
    sc = params.slot_count
    n = params.n
    two_n = 2 * n
    L = sc.bit_length() - 1
    stages = []
    k = np.arange(sc)
    for s in range(1, L + 1):
        t = sc >> (s - 1)
        h = t >> 1
        e = np.ones(h, dtype=np.int64)
        acc = 1
        for jj in range(h):
            e[jj] = acc
            acc = acc * 5 % two_n
        tw = np.exp(1j * np.pi * (((1 << (s - 1)) * e) % two_n) / n)
        i = k % t
        u0 = np.where(i < h, 1.0 + 0j, -tw[(i - h) % h])
        up = np.where(i < h, tw[i % h], 0j)          # (k, k+h)
        um = np.where(i >= h, 1.0 + 0j, 0j)          # (k, k-h)
        st: Dict[int, np.ndarray] = {0: u0}
        for d, u in ((h % sc, up), ((-h) % sc, um)):
            # stage 1 has h = sc/2 where +h and -h coincide mod sc
            st[d] = st[d] + u if d in st else u
        stages.append(st)
    return stages


def _diag_mul(A: dict, B: dict, sc: int) -> dict:
    """Compose A*B (apply B first) in rotation-diagonal form."""
    out: Dict[int, np.ndarray] = {}
    for a, ua in A.items():
        for b, vb in B.items():
            d = (a + b) % sc
            term = ua * np.roll(vb, -a)
            if d in out:
                out[d] = out[d] + term
            else:
                out[d] = term.copy()
    return {d: u for d, u in out.items() if np.max(np.abs(u)) > 1e-14}


def _diag_transpose_conj(A: dict, sc: int) -> dict:
    """conj(A)^T: entry (k, k+d) -> (k+d, k): offset -d, value rolled by d."""
    return {(-d) % sc: np.roll(np.conj(u), d) for d, u in A.items()}


def _diag_apply_host(A: dict, x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x, dtype=np.complex128)
    for d, u in A.items():
        out += u * np.roll(x, -d)
    return out


def _group_sizes(L: int, r: int = 5) -> list[int]:
    m = -(-L // r)
    base = L // m
    rem = L % m
    return [base + (1 if i < rem else 0) for i in range(m)]


def _pow2_hops(gamma: int) -> list[int]:
    """Signed power-of-two decomposition of a giant multiplier (shortest
    greedy form): gamma = sum(hops), each hop +-2^k, so giant rotations
    need keys only for power-of-two multiples of the stride g*B."""
    hops = []
    g = gamma
    while g:
        p = 1 << (abs(g).bit_length() - 1)
        if abs(g) - p > 2 * p - abs(g):
            p <<= 1
        p = p if g > 0 else -p
        hops.append(p)
        g -= p
    return hops


def _group_plan(mat: dict, sc: int) -> dict:
    """BSGS plan for one grouped diagonal matrix: every offset is a multiple
    of a power-of-two granularity g; delta = g*(beta + B*gamma).  Giant
    rotations run as power-of-two hop chains, so `giant_steps` only lists
    +-g*B*2^k."""
    offs = sorted(mat.keys())
    nz = [d for d in offs if d != 0]
    g = 0
    for d in nz:
        g = np.gcd(g, d)
    g = int(g) if g else 1
    count = len(offs)
    B = 1
    while B * B < count:
        B *= 2
    entries = []
    baby_steps = set()
    giant_steps = set()
    for d, u in mat.items():
        m = d // g
        # signed giant split: beta in [0,B), gamma = round toward -inf
        beta = m % B
        gamma = (m - beta) // B
        # offsets near sc wrap: prefer the signed representative
        m_signed = m if m <= (sc // g) // 2 else m - sc // g
        beta_s = m_signed % B
        gamma_s = (m_signed - beta_s) // B
        if abs(gamma_s) < abs(gamma):
            beta, gamma = beta_s, gamma_s
        entries.append(dict(delta=d, u=u, beta=int(beta), gamma=int(gamma)))
        baby_steps.add(-g * int(beta))
        for h in _pow2_hops(int(gamma)):
            giant_steps.add(-g * B * h)
    return dict(g=g, B=B, entries=entries,
                baby_steps=sorted(baby_steps), giant_steps=sorted(giant_steps))


def build_factored_plans(params, radix: int = 5):
    """(stc_plan, cts_plan): per-group BSGS plans.  SlotToCoeff applies the
    groups last-first; CoeffToSlot applies their conjugate transposes in
    reverse order, with 1/n spread evenly over the groups."""
    sc = params.slot_count
    stages = _fft_stages(params)
    L = len(stages)
    sizes = _group_sizes(L, radix)
    groups = []
    idx = 0
    for sz in sizes:
        G = stages[idx]
        for s in range(idx + 1, idx + sz):
            G = _diag_mul(G, stages[s], sc)
        groups.append(G)
        idx += sz
    stc_groups = list(reversed(groups))
    m = len(groups)
    scale = (1.0 / params.n) ** (1.0 / m)
    cts_groups = []
    for G in groups:
        Gt = _diag_transpose_conj(G, sc)
        cts_groups.append({d: u * scale for d, u in Gt.items()})
    stc_plan = [_group_plan(G, sc) for G in stc_groups]
    cts_plan = [_group_plan(G, sc) for G in cts_groups]
    return stc_plan, cts_plan


def _flavor_config(params, small: bool):
    """(K, double_angles, cheb_deg) for a bootstrap flavor: |I| concentrates
    around sqrt(h)/2, K = 1.5 sqrt(h) + 4 leaves ~5 sigma; noise grows ~4^r
    through the double angles, so r stays small and the degree pays."""
    h = params.secret_hamming or params.n // 2
    K = 1.5 * np.sqrt(h) + 4
    da = 2 if small else 1
    theta_max = (2 * np.pi * K + np.pi / 2) / (2 ** da)
    deg = int(1.3 * theta_max) + 24
    return K, da, deg


def _cts_diag(params, half: int):
    """CoeffToSlot diagonals of the dense map: F[k, j] =
    psi_C^(-e_j (k + offset)) / N (host check of the factored plans)."""
    sc = params.slot_count
    n = params.n
    two_n = 2 * n
    e = params.slot_exp

    def diag_fn_factory(offset):
        def diag_fn(d):
            k = np.arange(sc)
            j = (k - d) % sc
            expnt = (-(e[j] * (k + offset))) % two_n
            return np.exp(1j * np.pi * expnt / n) / n
        return diag_fn

    return diag_fn_factory(0), diag_fn_factory(half)


def _stc_diag(params, half: int):
    """SlotToCoeff diagonals of the dense map: E[j, k] = psi_C^(e_j (k +
    offset))."""
    sc = params.slot_count
    n = params.n
    two_n = 2 * n
    e = params.slot_exp

    def diag_fn_factory(offset):
        def diag_fn(d):
            j = np.arange(sc)
            k = (j - d) % sc
            expnt = (e[j] * (k + offset)) % two_n
            return np.exp(1j * np.pi * expnt / n)
        return diag_fn

    return diag_fn_factory(0), diag_fn_factory(half)


def _chebyshev_coeffs(f, deg: int) -> np.ndarray:
    k = np.arange(deg + 1)
    nodes = np.cos(np.pi * (k + 0.5) / (deg + 1))
    vals = f(nodes)
    coeffs = np.zeros(deg + 1)
    for m in range(deg + 1):
        coeffs[m] = 2.0 / (deg + 1) * np.sum(vals * np.cos(np.pi * m *
                                                           (k + 0.5) /
                                                           (deg + 1)))
    coeffs[0] /= 2
    return coeffs


def eval_mod_scales(bk: BootstrapKey, q0: int, delta: float):
    """(a_scale, b_shift, theta_max): u = x*a_scale + b_shift maps
    x = (m + q0*I)/Delta onto the Chebyshev domain
    u = (2 pi t - pi/2)/(2^r theta_max), t = x*Delta/q0.  a_scale is applied
    before CoeffToSlot so the linear maps work on O(1) values."""
    r = bk.double_angles
    theta_max = (2 * np.pi * bk.K + np.pi / 2) / (2 ** r)
    a_scale = (2 * np.pi * delta / q0) / (2 ** r) / theta_max
    b_shift = (-np.pi / 2) / (2 ** r) / theta_max
    return a_scale, b_shift, theta_max


def create_bootstrap_key(engine, sk, small: bool = False,
                         factored: bool | None = None,
                         rot: GaloisKeySet | None = None,
                         hi_prec: bool | None = None) -> BootstrapKey:
    """A bootstrap key of either flavor (`small`: two double angles and a
    lower Chebyshev degree) with a Galois key per rotation step, generated
    from the engine's generator unless `rot` brings them: the steps depend
    only on params, so the two flavors can share one set.  `factored`
    (default: slot_count >= 8) picks the factored FFT-stage plans over the
    dense BSGS maps; hi_prec defaults to the big rings (N >= 4096)."""
    params = engine.params
    if params.rescale_primes != 1:
        raise NotImplementedError(
            "bootstrap targets single-prime-rescale profiles")
    sc = params.slot_count
    if factored is None:
        factored = sc >= 8
    K, da, deg = _flavor_config(params, small)
    if hi_prec is None:
        hi_prec = params.n >= 4096
    if factored:
        tl = params.top_level
        hi_scale = float(params.q_primes[tl]) * float(params.q_primes[tl - 1])
        stc_plan, cts_plan = build_factored_plans(params)
        if rot is None:
            # CoeffToSlot and SlotToCoeff share one symmetric step set
            steps = set()
            for plan in stc_plan + cts_plan:
                steps |= {s % sc for s in plan["baby_steps"]}
                steps |= {s % sc for s in plan["giant_steps"]}
            steps.discard(0)
            rot = gen_rotation_keys(params, engine.tabs, sk, engine.rng,
                                    sorted(steps))
        return BootstrapKey(small=small, rot=rot, K=K, cheb_deg=deg,
                            double_angles=da, factored=True,
                            prescale=1.0 if hi_prec else 16.0,
                            hi_prec=hi_prec, hi_scale=hi_scale,
                            stc_plan=stc_plan, cts_plan=cts_plan)
    baby, giant = _bsgs_split(sc)
    if rot is None:
        steps = set(range(1, baby)) | {g * baby for g in range(1, giant)}
        rot = gen_rotation_keys(params, engine.tabs, sk, engine.rng,
                                sorted(steps))
    return BootstrapKey(small=small, rot=rot, baby=baby, giant=giant, K=K,
                        cheb_deg=deg, double_angles=da, factored=False)


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------

def _mod_raise(engine, ct: Ciphertext) -> Ciphertext:
    """Bottom-prime ciphertext -> full-level ciphertext of m + q0*I."""
    data0 = ops_impl.ct_drop_to(engine.params, ct.data, 0)
    return Ciphertext(ops_impl.mod_raise_core(engine.params, engine.tabs,
                                              data0), ct.scale)


def _apply_linear_map(engine, ct: Ciphertext, diag_fn, tag: str,
                      bk: BootstrapKey) -> Ciphertext:
    """out_slots = M @ in_slots, diag_fn(d) -> complex [sc] diagonal
    diag_d[k] = M[k, (k-d) mod sc], by BSGS: the babies rot(ct, b) share
    one digit decomposition; per giant g one plaintext multiply-accumulate
    of the diagonals pre-rolled by -gB, then one rotation by gB."""
    params = engine.params
    B, G = bk.baby, bk.giant
    babies = engine.hoisted_rotations(ct, bk.rot, list(range(B)))
    out = None
    for g in range(G):
        acc = None
        for b in range(B):
            d = g * B + b
            lvl = babies[b].level
            key = (tag, d, lvl)
            pt = bk.diags.get(key)
            if pt is None:
                bk.diag_misses += 1
                pt = engine.encode(np.roll(diag_fn(d), -g * B),
                                   level=lvl).data
                bk.diags[key] = pt
            else:
                bk.diag_hits += 1
            term = engine.multiply_plain(babies[b],
                                         Plaintext(pt, params.scale))
            acc = term if acc is None else engine.add(acc, term)
        if g:
            acc = engine.rotate(acc, bk.rot, g * B)
        out = acc if out is None else engine.add(out, acc)
    return out


def _apply_group(engine, ct: Ciphertext, plan: dict, tag: str,
                 bk: BootstrapKey, scalar: complex = 1.0, hi: bool = False,
                 out_scale: float | None = None) -> Ciphertext:
    """One grouped FFT-stage matrix (times `scalar`) by hoisted BSGS: the
    babies rot(ct, -g*beta) share one digit decomposition; per giant gamma
    the terms share (level, scale) and fuse into one multiply-accumulate
    rescaled once (twice with `hi`), then rotate by g*B*gamma as a chain of
    power-of-two hops.  `hi` encodes the diagonals so the two rescales
    land on out_scale (default hi_scale)."""
    params = engine.params
    sc = params.slot_count
    g, B = plan["g"], plan["B"]
    babies = engine.hoisted_rotations(ct, bk.rot, plan["baby_steps"])
    baby_map = dict(zip(plan["baby_steps"], babies))
    by_gamma: Dict[int, list] = {}
    for ent in plan["entries"]:
        by_gamma.setdefault(ent["gamma"], []).append(ent)
    lvl = ct.level
    # the cached content is roll(u * scalar) encoded at enc_scale, so the
    # key holds both (the scalar of the first SlotToCoeff group and the hi
    # enc_scale depend on the bootstrap input's scale)
    mag = round(np.log2(abs(scalar)) * 1e6) if scalar != 0 else 0
    if hi:
        tgt = bk.hi_scale if out_scale is None else out_scale
        enc_scale = (tgt * float(params.q_primes[lvl]) *
                     float(params.q_primes[lvl - 1]) / ct.scale)
        sc_key = (mag, round(np.angle(scalar) * 1e6),
                  round(np.log2(enc_scale) * 1e6))
    else:
        enc_scale = params.scale
        sc_key = (mag, round(np.angle(scalar) * 1e6))
    out = None
    for gamma, ents in sorted(by_gamma.items()):
        key = (tag, gamma, lvl, sc_key)
        ptd = bk.diags.get(key)
        if ptd is None:
            bk.diag_misses += 1
            pays = [engine.encode_payload(
                np.roll(ent["u"] * scalar, g * B * gamma), enc_scale)
                for ent in ents]
            ptd = engine.materialize_payloads(pays, lvl)
            bk.diags[key] = ptd
        else:
            bk.diag_hits += 1
        b_cts = [baby_map[-g * ent["beta"]] for ent in ents]
        acc = engine.fused_ptd_sum(b_cts, ptd, enc_scale,
                                   rescales=2 if hi else 1)
        for h in _pow2_hops(gamma):
            acc = engine.rotate(acc, bk.rot, (-g * B * h) % sc)
        out = acc if out is None else engine.add(out, acc)
    return out


def _apply_chain(engine, ct: Ciphertext, plans: list, tag: str,
                 bk: BootstrapKey, hi: bool = False) -> Ciphertext:
    for i, plan in enumerate(plans):
        ct = _apply_group(engine, ct, plan, f"{tag}{i}", bk, hi=hi)
    return ct


def _cheb_eval_ps(engine, coeffs: np.ndarray, u: Ciphertext, rlk,
                  baby: int = 8, hi: bool = False) -> Ciphertext:
    """Paterson-Stockmeyer evaluation of sum_i coeffs[i] T_i(u): babies
    T_1..T_{baby-1} and power-of-two giants T_{2^j}, then a recursive split
    with T_{m+j} = 2 T_j T_m - T_{m-j}.  `hi`: every ct*ct product drops a
    prime pair.  The squarings drift the tracked scale (s -> s^2/(q q'));
    the engine tracks it exactly (_true_sigma), so nothing re-targets it
    here."""
    def mul(a, b):
        if hi:
            return engine.multiply_pair(a, b, rlk)
        return engine.multiply(a, b, rlk)

    def step2(a, b):
        t = mul(a, b)
        return engine.add(t, t)

    deg = len(coeffs) - 1
    while deg > 0 and abs(coeffs[deg]) < 1e-14:
        deg -= 1
    T: Dict[int, Ciphertext] = {1: u}
    for m in range(2, baby):
        k = m // 2
        if m % 2 == 0:
            T[m] = engine.add_plain(step2(T[k], T[k]), -1.0)
        else:
            T[m] = engine.sub(step2(T[k], T[k + 1]), T[1])
    # giants by repeated doubling (baby is a power of two)
    g = 1
    while g < baby:
        g *= 2
        if g not in T:
            k = g // 2
            T[g] = engine.add_plain(step2(T[k], T[k]), -1.0)
    while g * 2 <= deg:
        g *= 2
        k = g // 2
        T[g] = engine.add_plain(step2(T[k], T[k]), -1.0)

    def rec(c: Dict[int, float]):
        """-> (ciphertext | None, constant): value = ct + constant."""
        nz = {k: v for k, v in c.items() if abs(v) > 1e-14}
        const = nz.pop(0, 0.0)
        direct = {k: v for k, v in nz.items() if k in T}
        rest = {k: v for k, v in nz.items() if k not in T}
        parts = []
        if direct:
            ks = sorted(direct)
            parts.append(engine.linear_combination(
                [T[k] for k in ks], [direct[k] for k in ks]))
        if rest:
            # every power of two <= deg is materialized, so d is not one,
            # mm < d strictly, and rest has no T_mm coefficient
            d = max(rest)
            mm = 1
            while mm * 2 <= d:
                mm *= 2
            q = {j: 2.0 * rest.get(mm + j, 0.0)
                 for j in range(1, d - mm + 1)}
            low: Dict[int, float] = {}
            for i, v in rest.items():
                if i < mm:
                    low[i] = low.get(i, 0.0) + v
            for j in range(1, d - mm + 1):
                low[mm - j] = low.get(mm - j, 0.0) - rest.get(mm + j, 0.0)
            q_ct, q_k = rec(q)
            if q_ct is not None:
                parts.append(mul(T[mm], q_ct))
            if abs(q_k) > 1e-14:
                parts.append(engine.multiply(T[mm], q_k))
            lo_ct, lo_k = rec(low)
            const += lo_k
            if lo_ct is not None:
                parts.append(lo_ct)
        if not parts:
            return None, const
        acc = parts[0]
        for p in parts[1:]:
            acc = engine.add(acc, p)
        return acc, const

    c0 = {i: float(coeffs[i]) for i in range(deg + 1)}
    out_ct, out_k = rec(c0)
    # rec holds itself through its closure: without this the cycle keeps
    # the basis T (~1 GiB of ciphertexts at prod_boot) on the card until
    # the next garbage collection, so the peak follows the collector
    del rec
    if abs(out_k) > 1e-14:
        out_ct = engine.add_plain(out_ct, out_k)
    return out_ct


def _eval_mod(engine, u_raw: Ciphertext, bk: BootstrapKey, rlk, q0: int,
              delta: float, final_mult: complex = 1.0) -> Ciphertext:
    """Input slots u_raw = x*a_scale; returns slots ~ m/Delta via the
    Chebyshev cos, r double angles and the cubic arcsine correction.  With
    hi_prec the result is the raw sine at the hi scale (final_mult and the
    correction are folded into the first SlotToCoeff group)."""
    hi = bk.hi_prec

    def mul(a, b):
        if hi:
            return engine.multiply_pair(a, b, rlk)
        return engine.multiply(a, b, rlk)

    _, b_shift, theta_max = eval_mod_scales(bk, q0, delta)
    u = engine.add_plain(u_raw, b_shift)
    coeffs = _chebyshev_coeffs(lambda v: np.cos(theta_max * v), bk.cheb_deg)
    y = _cheb_eval_ps(engine, coeffs, u, rlk, hi=hi)
    for _ in range(bk.double_angles):
        y2 = mul(y, y)
        y2 = engine.add(y2, y2)
        y = engine.add_plain(y2, -1.0)        # cos(2t) = 2cos^2 - 1
    if hi:
        return y
    # y = sin(2 pi m/q0); arcsin(y) ~ y + y^3/6, the renormalizing scalar
    # multiplies re-target the drifted scale
    y2 = mul(y, y)
    y3 = mul(y2, y)
    corr = engine.add(y, engine.multiply_renorm(y3, 1.0 / 6.0,
                                                target_scale=y.scale))
    return engine.multiply_renorm(corr, final_mult * q0 /
                                  (2 * np.pi * delta))


class _PhaseTimer:
    """The time of a bootstrap's three phases, added to the engine's
    counters `boot.cts_ns` (ModRaise through the conjugation split),
    `boot.evalmod_ns` and `boot.stc_ns` while a profiler records
    (`trace.on()`).  On the card each phase boundary records a timing event
    on the current stream; a `capture` timer's events are external, so
    under a graph capture they become event nodes of the graph and every
    replay times its own phases (the start is recorded before the replay).
    On the CPU, which runs synchronously, the marks take the host clock.
    Nothing waits for the card until `add`, which a capture never calls."""

    PHASES = ("cts", "evalmod", "stc")

    def __init__(self, engine, data: torch.Tensor, capture: bool = False):
        self.engine = engine
        self.cuda = data.is_cuda
        self.on = capture or (trace.on() and not (
            self.cuda and torch.cuda.is_current_stream_capturing()))
        self.stamps: list = [None] * (len(self.PHASES) + 1)
        if self.on and self.cuda:
            self.stamps = [torch.cuda.Event(enable_timing=True,
                                            external=capture)
                           for _ in self.stamps]
            if capture:
                # the CUDA events exist once recorded: create them before
                # the capture, which then records them as graph nodes
                for e in self.stamps[1:]:
                    e.record()

    def _stamp(self, i: int):
        if not self.on:
            return
        if self.cuda:
            self.stamps[i].record()
        else:
            self.stamps[i] = time.perf_counter_ns()

    def start(self):
        self._stamp(0)

    @contextlib.contextmanager
    def phase(self, name: str):
        """The phase's span, then its end's mark."""
        with trace.span("ckks.boot." + name):
            yield
        self._stamp(self.PHASES.index(name) + 1)

    def add(self):
        """Wait for the last mark and add each phase's nanoseconds."""
        if not self.on:
            return
        st = self.stamps
        if self.cuda:
            st[-1].synchronize()
            ns = [round(a.elapsed_time(b) * 1e6) for a, b in zip(st, st[1:])]
        else:
            ns = [b - a for a, b in zip(st, st[1:])]
        for name, v in zip(self.PHASES, ns):
            self.engine.counters[f"boot.{name}_ns"] += v


def _boot_front(engine, ct: Ciphertext, raised: Ciphertext, conj_key,
                bk: BootstrapKey) -> tuple:
    """Prescale + CoeffToSlot + conjugation half-split.  `ct` gives the
    input scale (for eval_mod_scales), `raised` is its ModRaise.  Returns
    the two real coefficient-half ciphertexts EvalMod consumes."""
    params = engine.params
    q0 = int(params.q_primes[0])
    a_scale, _, _ = eval_mod_scales(bk, q0, ct.scale)
    hi = bk.hi_prec
    f = bk.prescale
    plans = bk.cts_plan
    if hi:
        # a_scale rides the first group's diagonals, whose exact-scale
        # encode lifts Delta -> hi_scale at no level
        yp = _apply_group(engine, raised, plans[0], "fcts0lift", bk,
                          scalar=a_scale * f, hi=True)
        for i, plan in enumerate(plans[1:-1], 1):
            yp = _apply_group(engine, yp, plan, f"fcts{i}", bk, hi=True)
    else:
        yp = engine.multiply(raised, a_scale * f)
        yp = _apply_chain(engine, yp, plans[:-1], "fcts", bk)
    y_a = _apply_group(engine, yp, plans[-1], f"fctsA{f:g}", bk,
                       scalar=1.0 / f, hi=hi)
    # y_b = -i * y_a: one exact zeta4 multiply instead of a second group
    y_b = engine.negate(engine.multiply_i(y_a))
    ct_a = engine.add(y_a, engine.conjugate(y_a, conj_key))
    ct_b = engine.add(y_b, engine.conjugate(y_b, conj_key))
    return ct_a, ct_b


def _boot_back(engine, m_a: Ciphertext, m_b: Ciphertext, bk: BootstrapKey,
               in_scale: float) -> Ciphertext:
    """Half-recombine + SlotToCoeff."""
    params = engine.params
    if bk.hi_prec:
        v = engine.add(m_a, engine.multiply_i(m_b))
        fm = int(params.q_primes[0]) / (2 * np.pi * in_scale)
        # fm and the hi -> Delta pair drop fold into SlotToCoeff group 0
        v = _apply_group(engine, v, bk.stc_plan[0], "fstc0drop", bk,
                         scalar=fm, hi=True, out_scale=params.scale)
        return _apply_chain(engine, v, bk.stc_plan[1:], "fstc1on", bk)
    return _apply_chain(engine, engine.add(m_a, m_b), bk.stc_plan, "fstc",
                        bk)


def bootstrap(engine, ct: Ciphertext, relin_key, conj_key,
              bootstrap_key: BootstrapKey) -> Ciphertext:
    """Refresh `ct` (any level; only its bottom prime is read).  While a
    profiler records, the phases' times go to the engine's `boot.*_ns`
    counters (`_PhaseTimer`)."""
    with trace.span("ckks.boot"):
        pt = _PhaseTimer(engine, ct.data)
        pt.start()
        out = _bootstrap(engine, ct, relin_key, conj_key, bootstrap_key, pt)
        pt.add()
    return out


def _bootstrap(engine, ct: Ciphertext, relin_key, conj_key,
               bootstrap_key: BootstrapKey, pt: _PhaseTimer) -> Ciphertext:
    """The bootstrap's three phases, each marked on `pt`."""
    if bootstrap_key is None or bootstrap_key.rot is None:
        raise NotImplementedError(
            "bootstrap keys missing: create them with "
            "engine.create_bootstrap_key(sk) on a bootstrappable profile")
    params = engine.params
    engine._count("bootstrap")
    q0 = int(params.q_primes[0])
    if bootstrap_key.factored:
        with pt.phase("cts"):
            raised = _mod_raise(engine, ct)
            ct_a, ct_b = _boot_front(engine, ct, raised, conj_key,
                                     bootstrap_key)
        with pt.phase("evalmod"):
            m_a = _eval_mod(engine, ct_a, bootstrap_key, relin_key, q0,
                            ct.scale)
            # the *i of the half-recombine folds into EvalMod's final
            # constant (an exact zeta4 multiply in _boot_back when hi)
            m_b = _eval_mod(engine, ct_b, bootstrap_key, relin_key, q0,
                            ct.scale, final_mult=1j)
        with pt.phase("stc"):
            return _boot_back(engine, m_a, m_b, bootstrap_key, ct.scale)
    # dense: two maps per direction over the closed-form diagonals
    half = params.slot_count
    with pt.phase("cts"):
        a_scale, _, _ = eval_mod_scales(bootstrap_key, q0, ct.scale)
        raised = engine.multiply(_mod_raise(engine, ct), a_scale)
        f_a, f_b = _cts_diag(params, half)
        w_a = _apply_linear_map(engine, raised, f_a, "cts_a", bootstrap_key)
        w_b = _apply_linear_map(engine, raised, f_b, "cts_b", bootstrap_key)
        ct_a = engine.add(w_a, engine.conjugate(w_a, conj_key))
        ct_b = engine.add(w_b, engine.conjugate(w_b, conj_key))
    with pt.phase("evalmod"):
        m_a = _eval_mod(engine, ct_a, bootstrap_key, relin_key, q0, ct.scale)
        m_b = _eval_mod(engine, ct_b, bootstrap_key, relin_key, q0, ct.scale)
    with pt.phase("stc"):
        e_a, e_b = _stc_diag(params, half)
        return engine.add(
            _apply_linear_map(engine, m_a, e_a, "stc_a", bootstrap_key),
            _apply_linear_map(engine, m_b, e_b, "stc_b", bootstrap_key))


class FusedBootstrap:
    """The whole bootstrap at one input signature (level, scale), replayed
    as one captured CUDA graph, so no eager op of it (138 key-switches
    among them at prod_boot) waits on the host's dispatch.  Counterpart of
    the reference's FusedBootstrap, which traces the same phases into XLA
    programs.

    On a CUDA device the constructor bootstraps `sample_ct` eagerly (the
    warm-up: it fills every lazy device cache the bootstrap reads -- the
    diagonal stacks, the row tables and constants with the NTT kernels' row
    vectors, the Galois permutations, the scalar encodings, the key-switch
    kernel's row vectors; the twiddle tables come with the engine's
    DeviceTables), keeps that result in `warm_out`, then captures the
    bootstrap from a static input buffer into one graph.  A capture that
    would upload, or that grows any cache, raises: nothing falls back to
    the eager path.  The engine counters and the kernels' launch counts
    tick once during the capture, when nothing runs; they are put back,
    and every replay adds the capture's deltas.  The graph holds the phase
    timer's three event nodes (`_PhaseTimer`), read after a replay while a
    profiler records.  The instance
    holds every tensor the graph reads, since a graph keeps raw pointers.

    On the CPU nothing is captured: __call__ runs the eager bootstrap at the
    static input scale, so the signature checks and the tracked output scale
    are the same as the card's."""

    def __init__(self, engine, relin_key, conj_key, bk: BootstrapKey,
                 sample_ct: Ciphertext):
        if not bk.factored:
            raise NotImplementedError("FusedBootstrap needs the factored "
                                      "transform path")
        self.engine = engine
        self.relin_key = relin_key
        self.conj_key = conj_key
        self.bk = bk
        self.in_level = sample_ct.level
        self.in_scale = float(sample_ct.scale)
        self.out_scale: float | None = None
        self.warm_out: Ciphertext | None = None
        self.graph = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.deltas: dict = {}
        if sample_ct.data.is_cuda:
            self._capture(sample_ct)

    def _run(self, data) -> Ciphertext:
        return bootstrap(self.engine, Ciphertext(data, self.in_scale),
                         self.relin_key, self.conj_key, self.bk)

    def _caches(self) -> dict:
        eng = self.engine
        return dict(diags=self.bk.diags, rows=eng.tabs._rows,
                    ntt_rows=eng.tabs.ntt._rows, consts=eng.tabs._consts,
                    perms=eng._perm_cache, scalars=eng._consts_cache,
                    trivial=eng._trivial_cache,
                    ks_rows=ks_inner_mod._rows_dev)

    def _tally(self) -> dict:
        t = dict(self.engine.counters)
        t.update({f"{k}_launches": v
                  for k, v in {**kernels.launch_counts(),
                               **kernels.variant_counts()}.items()})
        t["diag_hits"] = self.bk.diag_hits
        return t

    def _add(self, deltas: dict):
        for k, v in deltas.items():
            if k.endswith("_launches"):
                kernels.add_launches({k[:-len("_launches")]: v})
            elif k == "diag_hits":
                self.bk.diag_hits += v
            else:
                self.engine.counters[k] += v

    def _capture(self, sample_ct: Ciphertext):
        dev = sample_ct.data.device
        self.warm_out = self._run(sample_ct.data)
        self.out_scale = float(self.warm_out.scale)
        torch.cuda.synchronize(dev)
        sizes = {k: len(c) for k, c in self._caches().items()}
        before = self._tally()
        t0 = time.perf_counter()
        self._static_in = sample_ct.data.clone()
        self._timer = _PhaseTimer(self.engine, self._static_in, capture=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            # entering the capture empties the allocator's cache, so the
            # pool's size is the growth from here
            reserved = torch.cuda.memory_reserved(dev)
            out = _bootstrap(self.engine,
                             Ciphertext(self._static_in, self.in_scale),
                             self.relin_key, self.conj_key, self.bk,
                             self._timer)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = self._tally()
        self.deltas = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
        self._add({k: -v for k, v in self.deltas.items()})
        grown = {k: (sizes[k], len(c)) for k, c in self._caches().items()
                 if len(c) != sizes[k]}
        if grown:
            raise RuntimeError(f"FusedBootstrap: caches grew during the "
                               f"capture (before, after): {grown}")
        if float(out.scale) != self.out_scale:
            raise RuntimeError("FusedBootstrap: the captured bootstrap "
                               "tracks another output scale than the eager "
                               "warm-up")
        self._static_out = out.data
        # the graph reads these by raw pointer: keep them alive as long as
        # it lives, whatever the bounded caches evict later
        self._held = [list(c.values()) for c in self._caches().values()]
        self.graph = graph

    def __call__(self, ct: Ciphertext) -> Ciphertext:
        if ct.level != self.in_level:
            raise ValueError(
                f"fused bootstrap built for input level {self.in_level}, "
                f"got {ct.level}")
        if abs(ct.scale - self.in_scale) / self.in_scale > 1e-7:
            raise ValueError(
                f"fused bootstrap built for input scale {self.in_scale}, "
                f"got {ct.scale}")
        if self.graph is None:
            out = self._run(ct.data)
            if self.out_scale is None:
                self.out_scale = float(out.scale)
            return Ciphertext(out.data, self.out_scale)
        if ct.data.shape != self._static_in.shape:
            raise ValueError(f"fused bootstrap built for data of shape "
                             f"{tuple(self._static_in.shape)}, got "
                             f"{tuple(ct.data.shape)}")
        self._static_in.copy_(ct.data)
        with trace.span("ckks.boot"):
            timed = trace.on()
            if timed:
                self._timer.start()
            self.graph.replay()
            if timed:
                self._timer.add()
        self._add(self.deltas)
        # the next replay overwrites the static output
        return Ciphertext(self._static_out.clone(), self.out_scale)
