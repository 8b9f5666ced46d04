"""Merged ShiftRows + MixColumns (and the inverse) on SIMD-packed AES
states, in the nibble-pair domain.  Counterpart of
`aesfhe_tpu/ops/mixcolumns_service.py`.

Layout: state byte (row r, col c) of block b lives at slot 16b + r + 4c.
ShiftRows then MixColumns gives
    out[r + 4c] = XOR_j M[r][j] * s[j + 4((c + j) mod 4)]
so the source of output (r, c, term j) is at in-block offset
    d(r, j) = 5j - r        (mod 16, wrapping when c + j >= 4).

GF-constant multiples T_m = m (x) s are slotwise 2D nibble LUT pairs,
computed ONCE from the unrotated state; the 16 (r, j) terms are masked
rotations of the right T_m (the rotations of one T_m share a hoisted digit
decomposition); the XOR folds are 16x16 LUTs on a balanced tree.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..coeffs import generate as coeffgen
from ..core.ciphertext import Ciphertext
from .gf_service import GFService
from .xor_service import (CoefficientCache, EngineWrapper, XORService,
                          bilinear_lut)
from .zeta import ZetaEncoder

COEFF_DIR = coeffgen.COEFF_DIR

MIX = [[2, 3, 1, 1],
       [1, 2, 3, 1],
       [1, 1, 2, 3],
       [3, 1, 1, 2]]
INV_MIX = [[14, 11, 13, 9],
           [9, 14, 11, 13],
           [13, 9, 14, 11],
           [11, 13, 9, 14]]


class NibblePair(tuple):
    """(hi_ct, lo_ct), both zeta16-domain."""
    __slots__ = ()

    def __new__(cls, hi, lo):
        return super().__new__(cls, (hi, lo))

    @property
    def hi(self):
        return self[0]

    @property
    def lo(self):
        return self[1]


class AESFHETransformer:
    """Merged ShiftRows+MixColumns (forward and inverse), SIMD multi-block."""

    def __init__(self, engine_wrapper: EngineWrapper, xor_svc: XORService,
                 gf_svc: GFService | None = None):
        self.eng = engine_wrapper
        self.xor_svc = xor_svc
        self.gf_svc = gf_svc
        self._gf2d = {}
        for m in (2, 3, 9, 11, 13, 14):
            self._gf2d[m] = (
                CoefficientCache(COEFF_DIR / f"gf{m}_hi2d_coeffs.json"),
                CoefficientCache(COEFF_DIR / f"gf{m}_lo2d_coeffs.json"))
        sc = self.eng.engine.slot_count
        idx = np.arange(sc)
        self._row = (idx % 16) % 4
        self._col = (idx % 16) // 4
        self._mask_cache: Dict = {}

    # ------------------------------------------------------------------
    def _gf_mul_pair(self, pair: NibblePair, m: int,
                     _bases=None) -> NibblePair:
        """(hi, lo) -> the nibble pair of m (x) byte, via two 2D zeta16 LUTs
        sharing the input power bases."""
        if m == 1:
            return pair
        xs = self.xor_svc
        if _bases is None:
            _bases = (xs._build_power_basis(pair.hi),
                      xs._build_power_basis(pair.lo))
        bh, bl = _bases
        out = [self._bilinear(bh, bl, cache.load_coeffs())
               for cache in self._gf2d[m]]
        return NibblePair(out[0], out[1])

    def _bilinear(self, bx: Dict[int, Ciphertext], by: Dict[int, Ciphertext],
                  coeffs) -> Ciphertext:
        return bilinear_lut(self.eng, bx, by, coeffs)

    def _xor_pair(self, a: NibblePair, b: NibblePair) -> NibblePair:
        xs = self.xor_svc
        return NibblePair(xs.xor_cipher(a.hi, b.hi),
                          xs.xor_cipher(a.lo, b.lo))

    def _term_plan(self, matrix, inverse: bool):
        """[(j, m, mask_key, delta)] for every nonempty masked-rotation
        term; the masks are dense plaintexts encoded once (exact host
        path)."""
        row, col = self._row, self._col
        plan = []
        for j in range(4):
            for r in range(4):
                m = matrix[r][j]
                if not inverse:
                    d = 5 * j - r                 # may be negative
                    wrapped = (col + j) >= 4      # output col c with c+j>=4
                    d_wrap = d - 16
                else:
                    d = j - 5 * r
                    wrapped = col < r
                    d_wrap = d + 16
                for which, (mask, delta) in enumerate((
                        (((row == r) & ~wrapped).astype(float), d),
                        (((row == r) & wrapped).astype(float), d_wrap))):
                    if not mask.any():
                        continue
                    ck = (r, j, inverse, which)
                    if ck not in self._mask_cache:
                        self._mask_cache[ck] = self.eng.encode(mask)
                    plan.append((j, m, ck, delta))
        return plan

    def rotation_steps(self, inverse: bool = False) -> list[int]:
        """The slot rotations `_mix_terms` hoists (each needs a direct
        Galois key)."""
        sc = self.eng.engine.slot_count
        matrix = INV_MIX if inverse else MIX
        return sorted({(-delta) % sc
                       for _, _, _, delta in self._term_plan(matrix, inverse)}
                      - {0})

    def _mix_terms(self, tms: Dict[int, NibblePair], matrix,
                   inverse: bool) -> list[NibblePair]:
        """V_j = sum_r mask(r, ...) * rot(T_{matrix[r][j]}): the four XOR
        operands of the merged transform.  The rotations of one T share a
        hoisted digit decomposition where direct rotation keys exist, and
        fall back to per-step rotations (power-of-two ladder) otherwise."""
        eng = self.eng
        sc = eng.engine.slot_count
        plan = self._term_plan(matrix, inverse)
        steps_per_m: Dict[int, set] = {}
        for j, m, ck, delta in plan:
            steps_per_m.setdefault(m, set()).add((-delta) % sc)
        rotated: Dict[int, Dict[int, NibblePair]] = {}
        for m, steps in steps_per_m.items():
            steps = sorted(steps)
            t = tms[m]
            try:
                his = eng.engine.hoisted_rotations(t.hi, eng.rot_key, steps)
                los = eng.engine.hoisted_rotations(t.lo, eng.rot_key, steps)
            except KeyError:
                his = [eng.rotate(t.hi, s) for s in steps]
                los = [eng.rotate(t.lo, s) for s in steps]
            rotated[m] = {s: NibblePair(h, l)
                          for s, h, l in zip(steps, his, los)}
        vs = []
        for j in range(4):
            acc_h = acc_l = None
            for jj, m, ck, delta in plan:
                if jj != j:
                    continue
                pm = self._mask_cache[ck]
                t = rotated[m][(-delta) % sc]
                th = eng.multiply_plain(t.hi, pm)
                tl = eng.multiply_plain(t.lo, pm)
                acc_h = th if acc_h is None else eng.add(acc_h, th)
                acc_l = tl if acc_l is None else eng.add(acc_l, tl)
            vs.append(NibblePair(acc_h, acc_l))
        return vs

    # one LUT stage: power basis (3) + bilinear sum (2)
    SEG_STAGE_DEPTH = 5

    def merged_shift_mix_pairs(self, pair: NibblePair,
                               inverse: bool = False,
                               refresh=None) -> NibblePair:
        """Nibble-pair state -> nibble-pair ShiftRows+MixColumns (or the
        exact inverse: InvMixColumns then InvShiftRows).

        `refresh(pair, need) -> pair` enables segment-refresh scheduling:
        the transform refreshes between its LUT stages (GF multiples ->
        masked-rotation sums -> two XOR-tree levels), so each stage of at
        most 7 levels runs right after a refresh.  Every intermediate is a
        root of unity per slot (the masks partition the slots), so each
        refresh's cleanse applies."""
        xs = self.xor_svc
        need = self.SEG_STAGE_DEPTH

        def _r(p, depth=need):
            return refresh(p, depth) if refresh is not None else p

        pair = _r(pair)
        bases = (xs._build_power_basis(pair.hi),
                 xs._build_power_basis(pair.lo))
        matrix = INV_MIX if inverse else MIX
        needed = sorted(set(m for rw in matrix for m in rw))
        tms = {m: self._gf_mul_pair(pair, m, _bases=bases) for m in needed}
        # mask+rotate costs 1 level, then an XOR stage: refresh the GF
        # multiples that cannot afford both
        tms = {m: _r(p, need + 1) for m, p in tms.items()}
        v = self._mix_terms(tms, matrix, inverse)
        # balanced XOR tree: ((V0^V1) ^ (V2^V3)), depth 2 instead of 3
        v = [_r(p) for p in v]
        a = self._xor_pair(v[0], v[1])
        b = self._xor_pair(v[2], v[3])
        a, b = _r(a), _r(b)
        return self._xor_pair(a, b)

    # ------------------------------------------------------------------
    def merged_shift_mix(self, state_bytes: np.ndarray) -> Ciphertext:
        """Plain state bytes -> encrypted merged ShiftRows+MixColumns, byte
        domain out."""
        z = ZetaEncoder.to_zeta(np.asarray(state_bytes), 256)
        return self.merged_shift_mix_ct(self.eng.encrypt(z))

    def merged_shift_mix_ct(self, ct: Ciphertext,
                            inverse: bool = False) -> Ciphertext:
        xs = self.xor_svc
        hi, lo = xs.extract_nibbles(ct)
        out = self.merged_shift_mix_pairs(NibblePair(hi, lo), inverse)
        return xs.recombine_nibbles16(out.hi, out.lo)

    def merged_inv_mixshift(self, ct_state: Ciphertext) -> Ciphertext:
        """InvMixColumns + InvShiftRows on a byte-domain state."""
        return self.merged_shift_mix_ct(ct_state, inverse=True)
