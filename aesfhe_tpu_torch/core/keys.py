"""Key generation: secret, public, relinearization and Galois keys of the
hybrid RNS key-switch.  Counterpart of `aesfhe_tpu/core/keys.py`.

Sampling runs on the host with numpy from an explicit
`numpy.random.Generator`, draw for draw as the reference samples from its
module generator; the NTT into the evaluation domain is the port's own.
For one seed the keys equal the reference's bit for bit.

Production keygen: pass `rng=OSEntropyRNG()` (or set AESFHE_KEYGEN_RNG=os,
which `Engine(rng=None)` reads): every sampling call then draws through a
PCG64 freshly keyed from the kernel CSPRNG via `secrets`, so no long-lived
deterministic stream state exists to leak or roll back.
"""
from __future__ import annotations

import os
import secrets
from dataclasses import dataclass

import numpy as np
import torch

from . import ops_impl, rns
from .params import CKKSParams


class OSEntropyRNG:
    """numpy Generator facade re-keyed from the OS on every call.

    Each sampling method draws through a PCG64 seeded with 256 fresh bits
    of kernel entropy, so consecutive keys share no PRG state; the PCG64
    expansion only whitens within one call's output block."""

    def _g(self) -> np.random.Generator:
        return np.random.default_rng(secrets.randbits(256))

    def choice(self, *a, **k):
        return self._g().choice(*a, **k)

    def random(self, *a, **k):
        return self._g().random(*a, **k)

    def normal(self, *a, **k):
        return self._g().normal(*a, **k)

    def integers(self, *a, **k):
        return self._g().integers(*a, **k)


def default_rng():
    """The generator of an engine built without one: OSEntropyRNG when
    AESFHE_KEYGEN_RNG=os, else a fresh numpy Generator."""
    if os.environ.get("AESFHE_KEYGEN_RNG") == "os":
        return OSEntropyRNG()
    return np.random.default_rng()


@dataclass
class SecretKey:
    s_eval: torch.Tensor  # int32 [L_tot, N] Montgomery eval (all primes)
    s_coeff: np.ndarray   # int8 [N] ternary, host


@dataclass
class PublicKey:
    b: torch.Tensor       # int32 [num_q, N]
    a: torch.Tensor


@dataclass
class SwitchKey:
    """Key switching s' -> s: per digit group (b_j, a_j) over the basis.

    cap=None: rows cover the full basis [dnum, L_tot, N].  cap=l: rows cover
    q_0..q_l plus the specials ([dnum_l, l+1+K, N]), a key that serves
    switches at levels <= l."""
    b: torch.Tensor       # int32 [dnum(_cap), rows, N]
    a: torch.Tensor
    cap: int | None = None


@dataclass
class GaloisKeySet:
    keys: dict            # galois element -> SwitchKey


def _sample_ternary(rng: np.random.Generator, n: int,
                    hamming: int | None = None) -> np.ndarray:
    if hamming is not None:
        s = np.zeros(n, dtype=np.int64)
        idx = rng.choice(n, hamming, replace=False)
        s[idx] = rng.choice(np.array([-1, 1]), hamming)
        return s
    u = rng.random(n)
    return np.where(u < 0.25, -1, np.where(u < 0.5, 1, 0)).astype(np.int64)


def _sample_gauss(rng: np.random.Generator, n: int, std: float) -> np.ndarray:
    return np.round(rng.normal(0.0, std, n)).astype(np.int64)


def _sample_uniform_rns(rng: np.random.Generator, primes, shape) -> np.ndarray:
    """Independent uniform residues per prime (== uniform mod the product)."""
    out = np.zeros((len(primes),) + shape, dtype=np.uint32)
    for i, q in enumerate(primes):
        out[i] = rng.integers(0, q, shape, dtype=np.uint32)
    return out


def _int_to_rns(v: np.ndarray, primes) -> np.ndarray:
    """Signed int64 [.., N] -> uint32 residues [L, ..]."""
    out = np.zeros((len(primes),) + v.shape, dtype=np.uint32)
    for i, q in enumerate(primes):
        out[i] = np.mod(v, np.int64(q)).astype(np.uint32)
    return out


def _to_eval(params: CKKSParams, tabs, residues_u32: np.ndarray, rows):
    """Plain coefficient residues [L, N] (host) -> Montgomery eval int32 on
    the tables' device."""
    tr = tabs.rows(rows)
    x = torch.as_tensor(residues_u32.astype(np.int32), device=tabs.device)
    return ops_impl.ntt_rows(x, tr, to_mont=True, out_dtype=torch.int32)


def gen_secret_key(params: CKKSParams, tabs, rng) -> SecretKey:
    s = _sample_ternary(rng, params.n, params.secret_hamming)
    res = _int_to_rns(s, params.all_primes)
    rows = np.arange(params.L_tot)
    return SecretKey(_to_eval(params, tabs, res, rows), s.astype(np.int8))


def gen_public_key(params: CKKSParams, tabs, sk: SecretKey, rng) -> PublicKey:
    primes = params.q_primes
    rows = np.arange(params.num_q)
    a_res = _sample_uniform_rns(rng, primes, (params.n,))
    e_res = _int_to_rns(_sample_gauss(rng, params.n, params.error_std), primes)
    a_eval = _to_eval(params, tabs, a_res, rows).long()
    e_eval = _to_eval(params, tabs, e_res, rows).long()
    tr = tabs.rows(rows)
    q = tr.q.reshape(-1, 1)
    s_q = sk.s_eval[:params.num_q].long()
    b = rns.add_mod(rns.neg_mod(rns.mont_mul(a_eval, s_q, q,
                                             tr.rinv.reshape(-1, 1)), q),
                    e_eval, q)
    return PublicKey(b=b.int(), a=a_eval.int())


def gen_switch_key(params: CKKSParams, tabs, sk: SecretKey, s_prime_eval,
                   rng, lvl_cap: int | None = None) -> SwitchKey:
    """ksk_j = (-a_j s + e_j + P g_j s', a_j) over QP.  In RNS the gadget
    P g_j is (P mod q_i) on the group's own primes and 0 elsewhere.
    `lvl_cap` makes a level-capped key (see SwitchKey.cap)."""
    n = params.n
    if lvl_cap is None:
        rows = np.arange(params.L_tot)
        groups = params.groups
    else:
        rows = np.asarray(list(range(lvl_cap + 1)) +
                          list(range(params.num_q,
                                     params.num_q + params.num_special)))
        groups = [[i for i in grp if i <= lvl_cap] for grp in params.groups]
        groups = [g for g in groups if g]
    basis_primes = tuple(params.all_primes[r] for r in rows)
    tr = tabs.rows(rows)
    q = tr.q.reshape(-1, 1)
    ri = tr.rinv.reshape(-1, 1)
    rows_t = torch.as_tensor(rows, device=tabs.device)
    s_rows = sk.s_eval.index_select(0, rows_t).long()
    sp_rows = (s_prime_eval.index_select(0, rows_t) if lvl_cap is not None
               else s_prime_eval).long()
    P = 1
    for p in params.special_primes:
        P *= p
    b_list, a_list = [], []
    for grp in groups:
        a_res = _sample_uniform_rns(rng, basis_primes, (n,))
        e_res = _int_to_rns(_sample_gauss(rng, n, params.error_std),
                            basis_primes)
        a_eval = _to_eval(params, tabs, a_res, rows).long()
        e_eval = _to_eval(params, tabs, e_res, rows).long()
        b = rns.add_mod(rns.neg_mod(rns.mont_mul(a_eval, s_rows, q, ri), q),
                        e_eval, q)
        # + P g_j s' on the group's own rows (q-row i is physical row i in
        # both layouts since i <= lvl_cap)
        pg = np.zeros((len(rows), 1), dtype=np.int64)
        for i in grp:
            pg[i, 0] = P % params.q_primes[i]
        term = rns.shoup_mul(sp_rows, torch.as_tensor(pg, device=tabs.device),
                             q)
        b_list.append(rns.add_mod(b, term, q).int())
        a_list.append(a_eval.int())
    return SwitchKey(b=torch.stack(b_list), a=torch.stack(a_list), cap=lvl_cap)


def gen_relin_key(params: CKKSParams, tabs, sk: SecretKey, rng) -> SwitchKey:
    tr = tabs.rows(np.arange(params.L_tot))
    s = sk.s_eval.long()
    s2 = rns.mont_mul(s, s, tr.q.reshape(-1, 1), tr.rinv.reshape(-1, 1))
    return gen_switch_key(params, tabs, sk, s2.int(), rng)


def gen_galois_key(params: CKKSParams, tabs, sk: SecretKey, galois_elt: int,
                   rng, lvl_cap: int | None = None) -> SwitchKey:
    perm = torch.as_tensor(params.galois_perm(galois_elt).astype(np.int64),
                           device=tabs.device)
    return gen_switch_key(params, tabs, sk, sk.s_eval[..., perm], rng,
                          lvl_cap=lvl_cap)


def gen_rotation_keys(params: CKKSParams, tabs, sk: SecretKey, rng,
                      steps: list[int] | None = None) -> GaloisKeySet:
    """Power-of-two ladder (both signs) for arbitrary-step rotation, or the
    explicitly requested steps."""
    sc = params.slot_count
    wanted: set[int] = set()
    if steps is None:
        p2 = 1
        while p2 < sc:
            wanted.add(p2)
            wanted.add(sc - p2)
            p2 *= 2
    else:
        for s in steps:
            wanted.add(s % sc)
    wanted.discard(0)
    keys = {}
    for s in sorted(wanted):
        g = params.rot_galois_elt(s)
        if g not in keys:
            keys[g] = gen_galois_key(params, tabs, sk, g, rng)
    return GaloisKeySet(keys=keys)
