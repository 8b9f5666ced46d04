"""Bit-sliced (Walsh-basis) homomorphic AES round services.  Counterpart of
`aesfhe_tpu/ops/bitplane.py`.

Each AES state byte is held as 8 bit-planes encoded +-1 ((-1)^bit), one
ciphertext per plane, byte p of the packed blocks at slot p:
  - XOR with a plaintext key is one dense plaintext multiply per plane;
  - SubBytes is a bilinear form in the Walsh (character) basis: the 16
    subset products of the low-nibble planes and of the high-nibble planes
    (depth 2), then out_k = sum_{u,v} W[k][u,v] A_u B_v with one
    relinearization per plane (depth 4 in all);
  - ShiftRows is hoisted rotations + one dense mask combine (1 level);
  - MixColumns is GF(2)-linear on bits: each output plane is a product of
    5-7 masked-rotated input planes (depth 4-5);
  - a cubic sign-cleanse z -> z(3 - z^2)/2 ends each round (3 levels).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..aes_tables import AES_SBOX, gmul
from ..core import ops_impl
from ..core.ciphertext import Ciphertext
from .xor_service import EngineWrapper


def mul_bits(m: int, k: int) -> tuple:
    """Input bit indices k' that bit k of GF-product m (x) x depends on."""
    return tuple(kp for kp in range(8) if (gmul(m, 1 << kp) >> k) & 1)


def _parity_table() -> np.ndarray:
    v = np.arange(256, dtype=np.uint16)
    p = v.copy()
    for s in (4, 2, 1):
        p ^= p >> s
    return (p & 1).astype(np.int8)


_PARITY = _parity_table()


def walsh_tables(table: np.ndarray) -> np.ndarray:
    """[8, 256] Walsh-Hadamard spectra of the byte LUT's component bits:
    (-1)^{bit_k(table[x])} = sum_u W[k, u] chi_u(x), chi_u(x) =
    (-1)^{popcount(u & x)}; exact multiples of 1/128."""
    x = np.arange(256)
    chi = 1.0 - 2.0 * _PARITY[np.bitwise_and.outer(x, x)]
    f = 1.0 - 2.0 * ((table[np.newaxis, :] >> np.arange(8)[:, None]) & 1)
    return (f @ chi.T) / 256.0


def chi_signs(u: int, bytes_vec: np.ndarray) -> np.ndarray:
    """chi_u at a byte vector: per-slot +-1 signs."""
    return 1.0 - 2.0 * _PARITY[np.bitwise_and(bytes_vec.astype(np.int64), u)]


AES_INV_SBOX = np.zeros(256, dtype=np.uint8)
AES_INV_SBOX[AES_SBOX] = np.arange(256, dtype=np.uint8)

MIX = [[2, 3, 1, 1],
       [1, 2, 3, 1],
       [1, 1, 2, 3],
       [3, 1, 1, 2]]
INV_MIX = [[14, 11, 13, 9],
           [9, 14, 11, 13],
           [13, 9, 14, 11],
           [11, 13, 9, 14]]


@dataclass
class BitState:
    """8 ciphertexts; bits[k] holds (-1)^{bit k of byte} per slot."""
    bits: List[Ciphertext]

    @property
    def level(self) -> int:
        return min(b.level for b in self.bits)


class BitSliceService:
    # the dense-plaintext LRU holds one round's working set: 8 ARK sign
    # planes, ~7 ShiftRows mask variants, 4 row masks
    _PT_CACHE_CAP = 24
    # the inverse round's key-folded row masks, kept apart from that LRU:
    # a cipher's 9 round keys x 8 planes x 4 rows, so a cipher after the
    # first encodes none of them
    _FOLD_CACHE_CAP = 9 * 8 * 4

    def __init__(self, eng_wrap: EngineWrapper):
        self.eng = eng_wrap
        self.sc = eng_wrap.engine.params.slot_count
        idx = np.arange(self.sc)
        self._row = (idx % 16) % 4
        self._col = (idx % 16) // 4
        self._W = {False: walsh_tables(AES_SBOX),
                   True: walsh_tables(AES_INV_SBOX)}
        self._pt_cache: Dict = {}
        self._fold_cache: Dict = {}
        self._walsh_const_cache: Dict = {}
        # direct Galois keys of the hoisted rotation batches: ShiftRows uses
        # +-4r, MixColumns' in-column row rotations +-1..3
        eng_wrap.ensure_rotation_steps(
            [1, 2, 3, -1, -2, -3, 4, 8, 12, -4, -8, -12])

    def _cached_pt(self, key, vec: np.ndarray, level: int | None = None,
                   scale: float | None = None, folded: bool = False):
        """Device-encoded dense weight vector, LRU-cached within a round
        (c64 embedding: ~1e-6 relative error, far below the +-1 sign margin
        and the 0/1 mask contrast).  `level` caps the encode height; a later
        call needing more rows re-encodes.  `scale` (default Delta) is the
        encode scale.  `folded` keeps the entry in the cipher-wide cache of
        key-folded masks instead."""
        eng = self.eng.engine
        need = eng.params.top_level if level is None else level
        scale = eng.params.scale if scale is None else scale
        cache, cap = ((self._fold_cache, self._FOLD_CACHE_CAP) if folded
                      else (self._pt_cache, self._PT_CACHE_CAP))
        pt = cache.pop(key, None)
        if pt is None or pt.level < need or pt.scale != scale:
            pt = eng.encode(np.asarray(vec, dtype=np.float64), level=need,
                            scale=scale, device=True)
        cache[key] = pt
        while len(cache) > cap:
            cache.pop(next(iter(cache)))
        return pt

    # -- encode / decode ---------------------------------------------------
    def encrypt_state(self, state_bytes: np.ndarray) -> BitState:
        b = np.asarray(state_bytes, dtype=np.uint8)
        return BitState([
            self.eng.encrypt(1.0 - 2.0 * ((b >> k) & 1).astype(np.float64),
                             device=True)
            for k in range(8)])

    def decrypt_state(self, st: BitState) -> np.ndarray:
        out = np.zeros(self.sc, dtype=np.uint8)
        for k, ct in enumerate(st.bits):
            bit = np.real(self.eng.decrypt(ct, device=True)) < 0
            out |= bit.astype(np.uint8) << k
        return out

    # -- AddRoundKey ---------------------------------------------------------
    def _key_signs(self, key16: np.ndarray, k: int) -> np.ndarray:
        tiled = np.tile(np.asarray(key16, dtype=np.uint8), self.sc // 16)
        return 1.0 - 2.0 * ((tiled >> k) & 1).astype(np.float64)

    def xor_plain(self, st: BitState, key16: np.ndarray) -> BitState:
        """AddRoundKey: (-1)^(x^k) = (-1)^x (-1)^k, one dense plaintext
        multiply per plane."""
        out = []
        for k in range(8):
            ck = ("ark", bytes(np.asarray(key16, dtype=np.uint8)), k)
            pt = self._cached_pt(ck, self._key_signs(key16, k),
                                 level=st.bits[k].level)
            out.append(self.eng.multiply_plain(st.bits[k], pt))
        return BitState(out)

    # -- subset products (character basis) -----------------------------------
    def _subset_products(self, bits4: Sequence[Ciphertext]) -> Dict[int, Ciphertext]:
        """{u: prod_{i in u} bits4[i]} for u in 1..15 at one (level, scale),
        depth 2: pairs multiply singles, triples a scale-adjusted single and
        a pair, the quad two pairs."""
        eng = self.eng.engine
        rlk = self.eng.relin_key
        P: Dict[int, Ciphertext] = {1 << i: ct for i, ct in enumerate(bits4)}
        pairs = [u for u in range(1, 16) if bin(u).count("1") == 2]
        for u in pairs:
            lo = u & -u
            P[u] = eng.multiply(P[lo], P[u ^ lo], rlk)
        s_pair = P[pairs[0]].scale
        adj = {b: eng._adjust_scale(P[b], s_pair) for b in (1, 2, 4, 8)}
        for u in (7, 11, 13, 14):
            lo = u & -u
            P[u] = eng.multiply(adj[lo], P[u ^ lo], rlk)
        P[15] = eng.multiply(P[3], P[12], rlk)
        s2 = P[15].scale
        lvl2 = P[15].level
        out: Dict[int, Ciphertext] = {}
        for u in range(1, 16):
            ct = P[u]
            # a sub-1e-7 mismatch is a value error far below the sign margin
            if abs(ct.scale - s2) / s2 > 1e-7:
                ct = eng._adjust_scale(ct, s2)
            out[u] = eng._drop(ct, lvl2)
        return out

    # -- SubBytes -------------------------------------------------------------
    def sub_bytes(self, st: BitState, inverse: bool = False,
                  round_key: Optional[np.ndarray] = None) -> BitState:
        """out_k = sum_{u,v} W[k][u,v] A_u B_v.  With `round_key`, evaluates
        SBOX[x ^ rk] at no extra depth: chi_{uv}(x ^ rk) = chi_{uv}(x)
        chi_{uv}(rk) only flips coefficient signs (per-slot dense weights)."""
        eng = self.eng.engine
        rlk = self.eng.relin_key
        W = self._W[inverse]
        A = self._subset_products(st.bits[0:4])
        B = self._subset_products(st.bits[4:8])
        lvl = A[1].level
        s2 = A[1].scale
        one = eng.trivial_ct(1.0, level=lvl, scale=s2)
        lhs = [one] + [A[u] for u in range(1, 16)]
        blist = [one] + [B[v] for v in range(1, 16)]
        if round_key is None:
            # all 8 planes through one fused sum, then per-plane relin and
            # the two rescales of the two-stage form
            params = eng.params
            target = params.scale
            a_stack = torch.stack([ct.data[:, :lvl + 1] for ct in lhs])
            b_stack = torch.stack([ct.data[:, :lvl + 1] for ct in blist])
            consts = self._walsh_consts(inverse, lvl, target)
            raw = ops_impl.walsh_sub_bytes_core(params, eng.tabs,
                                                a_stack, b_stack, consts)
            eng._count("pt_mul", 128)
            eng._count("ct_mul", 128)
            outs = []
            for k in range(8):
                ct = Ciphertext(raw[k], s2 * s2 * target)
                eng._count("keyswitch")
                ct = Ciphertext(eng._relin_data(ct.data, rlk), ct.scale)
                outs.append(eng._rescale(eng._rescale(ct)))
            return BitState(outs)
        rk = np.tile(np.asarray(round_key, dtype=np.uint8), self.sc // 16)
        key_lo, key_hi = (rk & 0x0F), (rk >> 4)
        outs = []
        for k in range(8):
            rhs = []
            for u in range(16):
                su = chi_signs(u, key_lo)
                dense = [W[k][(v << 4) | u] * su * chi_signs(v, key_hi)
                         for v in range(16)]
                rhs.append(eng.linear_combination(blist, dense))
            outs.append(eng.inner_product(lhs, rhs, rlk))
        return BitState(outs)

    def _walsh_consts(self, inverse: bool, level: int, target: float):
        """[8, 16, 16, level+1, 2] (w, w_shoup) table of the real Walsh
        weights W[k][(v<<4)|u] encoded at `target`, cached per (table,
        level)."""
        ck = (inverse, level, round(target))
        hit = self._walsh_const_cache.get(ck)
        if hit is not None:
            return hit
        W = self._W[inverse]
        params = self.eng.engine.params
        C = W[:, (np.arange(16)[None, :] << 4) | np.arange(16)[:, None]]
        re_i = np.round(C * target).astype(np.int64)      # [8, 16, 16]
        qs = np.asarray(params.active_primes(level), dtype=np.int64)
        re_q = np.mod(re_i[..., None], qs[None, None, None, :])
        re_sh = ((re_q.astype(np.uint64) << np.uint64(32)) //
                 qs.astype(np.uint64)[None, None, None, :])
        consts = np.stack([re_q, re_sh], axis=-1).astype(np.uint32)
        dev = torch.as_tensor(consts.view(np.int32),
                              device=self.eng.engine.device)
        self._walsh_const_cache[ck] = dev
        return dev

    # -- ShiftRows ------------------------------------------------------------
    def _sr_variants(self, inverse: bool):
        """[(step, mask)] masked-rotation variants of in-block ShiftRows:
        output slot p (row r, col c) reads slot p + delta, done as
        rotate(-delta) then an output-side mask."""
        row, col = self._row, self._col
        out = []
        for r in range(4):
            if r == 0:
                out.append((0, row == 0))
                continue
            if not inverse:
                keep = (row == r) & (col < 4 - r)       # delta = 4r
                wrap = (row == r) & (col >= 4 - r)      # delta = 4r - 16
                out.append((-4 * r, keep))
                out.append((16 - 4 * r, wrap))
            else:
                keep = (row == r) & (col >= r)          # delta = -4r
                wrap = (row == r) & (col < r)           # delta = 16 - 4r
                out.append((4 * r, keep))
                out.append((4 * r - 16, wrap))
        return out

    def shift_rows(self, st: BitState, inverse: bool = False,
                   fold_key: Optional[np.ndarray] = None) -> BitState:
        """Per plane: hoisted rotations + one dense mask combine (1 level).
        `fold_key` folds a following AddRoundKey into the mask weights."""
        eng = self.eng.engine
        rot_keys = self.eng.rot_key
        variants = self._sr_variants(inverse)
        steps = sorted({s % self.sc for s, _ in variants})
        fold_b = (bytes(np.asarray(fold_key, dtype=np.uint8))
                  if fold_key is not None else None)
        out = []
        for k in range(8):
            by_step = dict(zip(steps, eng.hoisted_rotations(
                st.bits[k], rot_keys, steps)))
            sign = (self._key_signs(fold_key, k)
                    if fold_key is not None else 1.0)
            cts, weights = [], []
            for vi, (s, mask) in enumerate(variants):
                cts.append(by_step[s % self.sc])
                ck = (("srf", inverse, vi, fold_b, k) if fold_b is not None
                      else ("sr", inverse, vi))
                weights.append(self._cached_pt(
                    ck, mask.astype(np.float64) * sign,
                    level=st.bits[k].level))
            out.append(eng.linear_combination(cts, weights))
        return BitState(out)

    # -- MixColumns -----------------------------------------------------------
    def _mix_plan(self, inverse: bool):
        """plans[k] = factor slots, each a per-row (source plane k', term j);
        every row has the same factor count, so output plane k is ONE
        product of n(k) mask-combined ciphertexts (XOR of +-1 = product)."""
        matrix = INV_MIX if inverse else MIX
        plans = []
        for k in range(8):
            per_row = []
            for r in range(4):
                fl = []
                for j in range(4):
                    for kp in mul_bits(matrix[r][j], k):
                        fl.append((kp, j))
                per_row.append(fl)
            n = len(per_row[0])
            assert all(len(f) == n for f in per_row), "row arity mismatch"
            plans.append([[per_row[r][i] for r in range(4)]
                          for i in range(n)])
        return plans

    def _mix_rot_step(self, r: int, j: int) -> int:
        # output slot r+4c reads in[j+4c]: source offset j - r, in-column
        return (r - j) % self.sc

    def mix_columns(self, st: BitState, inverse: bool = False,
                    fold_key: Optional[np.ndarray] = None,
                    align: bool = True) -> BitState:
        """out_k = prod_i G_i(k), G_i(k) = sum_r mask_r * rot(plane, -delta);
        rotations hoisted per source plane.  `fold_key` folds a following
        AddRoundKey into the first factor's row masks (its key signs at
        the output slots), at no level.

        `align=False`, for a cleanse that follows and retargets every plane
        to Delta: the masks are encoded at the scale that lands each factor
        on Delta (a tree of depth 5 would raise its inputs' scale, ~2.2
        Delta after SubBytes and ShiftRows, to the 32nd power, past what
        the cleanse's constants can encode), and each plane is left at its
        own tree's level and scale (the inverse's 19-factor planes would
        otherwise pay one more level to meet the 11-factor planes' scale)."""
        eng = self.eng.engine
        rlk = self.eng.relin_key
        rot_keys = self.eng.rot_key
        plans = self._mix_plan(inverse)
        need: Dict[int, set] = {}
        for k in range(8):
            for slot in plans[k]:
                for r, (kp, j) in enumerate(slot):
                    need.setdefault(kp, set()).add(self._mix_rot_step(r, j))
        rotated: Dict[int, Dict[int, Ciphertext]] = {}
        for kp, steps in need.items():
            steps = sorted(steps)
            rotated[kp] = dict(zip(steps, eng.hoisted_rotations(
                st.bits[kp], rot_keys, steps)))
        lvl_mask = max(b.level for b in st.bits)
        mask_scale = None
        if not align:
            b = st.bits[0]
            mask_scale = (eng.params.scale * float(eng.params.q_primes[
                b.level]) / b.scale)
        row_masks = [self._cached_pt(("row", r),
                                     (self._row == r).astype(np.float64),
                                     level=lvl_mask, scale=mask_scale)
                     for r in range(4)]
        fold_b = (bytes(np.asarray(fold_key, dtype=np.uint8))
                  if fold_key is not None else None)
        out = []
        for k in range(8):
            factors = []
            for i, slot in enumerate(plans[k]):
                cts = [rotated[kp][self._mix_rot_step(r, j)]
                       for r, (kp, j) in enumerate(slot)]
                masks = row_masks
                if i == 0 and fold_b is not None:
                    sign = self._key_signs(fold_key, k)
                    masks = [self._cached_pt(
                        ("rowf", r, fold_b, k),
                        (self._row == r).astype(np.float64) * sign,
                        level=lvl_mask, scale=mask_scale, folded=True)
                        for r in range(4)]
                factors.append(eng.linear_combination(cts, masks))
            while len(factors) > 1:          # balanced product tree
                nxt = [eng.multiply(factors[i], factors[i + 1], rlk)
                       for i in range(0, len(factors) - 1, 2)]
                if len(factors) % 2:
                    nxt.append(factors[-1])
                factors = nxt
            out.append(factors[0])
        if not align:
            return BitState(out)
        # odd-arity leftovers sit one level above: align the set
        lvl = min(ct.level for ct in out)
        target = min(ct.scale for ct in out)
        aligned = []
        for ct in out:
            if abs(ct.scale - target) / target > 1e-7:
                ct = eng._adjust_scale(ct, target)
            aligned.append(eng._drop(ct, min(lvl, ct.level)))
        lvl = min(ct.level for ct in aligned)
        return BitState([eng._drop(ct, lvl) for ct in aligned])

    # -- noise management -----------------------------------------------------
    def cleanse(self, st: BitState) -> BitState:
        """Cubic sign-cleanse z -> z(3 - z^2)/2: squashes additive noise
        around +-1 and retargets the tracked scale back to Delta."""
        eng = self.eng.engine
        rlk = self.eng.relin_key
        params = eng.params
        out = []
        for ct in st.bits:
            z2 = eng.multiply(ct, ct, rlk)
            q_w = 1.0
            for i in range(params.rescale_primes):
                q_w *= float(params.q_primes[z2.level - i])
            lvl_f = z2.level - params.rescale_primes
            q_f = 1.0
            for i in range(params.rescale_primes):
                q_f *= float(params.q_primes[lvl_f - i])
            # coefficient scale chosen so the final product lands on Delta
            sigma = (params.scale * q_f * q_w) / (ct.scale * z2.scale)
            w = eng.linear_combination([z2], [-0.5], constant=1.5,
                                       coeff_scale=sigma)
            res = eng.multiply(ct, w, rlk)
            out.append(Ciphertext(res.data, params.scale))
        return BitState(out)
