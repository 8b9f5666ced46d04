"""Homomorphic AES-128 over SIMD-packed blocks.  Counterpart of
`aesfhe_tpu/pipeline.py`.

Two pipelines:
  - AESFHE128, the zeta nibble-pair pipeline: a byte is the pair
    (zeta16^hi, zeta16^lo); SubBytes and the GF multipliers are 16x16 2D
    LUT pairs, XOR with the plaintext round key costs only plaintext
    multiplies, and ShiftRows+MixColumns is one merged transform.  One
    round is ~47 levels (ARK 5, SubBytes+cleanse 14, shift-mix 23, ARK 5).
  - AESFHE128Bitsliced, on 8 +-1 bit planes: one middle round = AddRoundKey
    (1 level) + SubBytes (4) + ShiftRows (1) + MixColumns (4-5) +
    sign-cleanse (3) ~= 14 levels.

One ciphertext (pair) packs slot_count/16 blocks, column-major per 16-slot
block (2048 blocks at N=2^16).

Under a profiler each round is a `ckks.aes.round` span around its stages'
spans (`trace.py`): `ckks.aes.ark`, `ckks.aes.sub_bytes`,
`ckks.aes.shift_mix` and `ckks.aes.refresh`.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from . import trace
from .coeffs import generate as coeffgen
from .core.ciphertext import Ciphertext
from .keyexp import equivalent_inverse_keys, expand_key_128
from .ops.bitplane import BitSliceService, BitState
from .ops.mixcolumns_service import AESFHETransformer, NibblePair
from .ops.shiftrows_service import AESFHEShiftRows
from .ops.xor_service import CoefficientCache, EngineWrapper, XORService
from .ops.zeta import ZetaEncoder, split_nibbles
from .utils.aes_utils import chunk_bytes, pkcs7_pad
from .utils.serialization import (load_ciphertext, params_fingerprint,
                                  save_ciphertext)

COEFF_DIR = coeffgen.COEFF_DIR


class AESFHE128:
    """AES-128 on zeta16 nibble pairs: ARK(rk0); rounds 1-9 [SubBytes,
    ShiftRows+MixColumns, ARK]; round 10 [SubBytes, ShiftRows, ARK].

    `refresh` (a Ciphertext -> Ciphertext rejuvenator, e.g.
    EngineWrapper.bootstrap) runs before an op that would exhaust the chain.
    `segment_refresh` moves the refreshes inside the round, between LUT
    stages: a production bootstrap chain leaves ~19 levels after a refresh,
    which holds one LUT stage but not a 14-23 level round segment."""

    def __init__(self, eng_wrap: EngineWrapper, xor_svc: XORService,
                 transformer: AESFHETransformer,
                 shiftrows: AESFHEShiftRows,
                 key: bytes | np.ndarray,
                 refresh: Optional[Callable[[Ciphertext], Ciphertext]] = None):
        self.eng = eng_wrap
        self.xor = xor_svc
        self.tf = transformer
        self.sr = shiftrows
        self.round_keys = expand_key_128(key)           # [11, 16]
        self.refresh = refresh
        # root-of-unity cleanses after each real refresh: a small ring's
        # bootstrap leaves ~0.03 on the zeta16 circle and needs 4; a
        # prod-shaped hi-precision chain refreshes at ~1e-3 and needs 2
        self.post_boot_cleanses = self.POST_BOOT_CLEANSES
        self.segment_refresh = False
        self._sbox2d = (
            CoefficientCache(COEFF_DIR / "sbox_hi2d_coeffs.json"),
            CoefficientCache(COEFF_DIR / "sbox_lo2d_coeffs.json"))
        self._inv_sbox2d = (
            CoefficientCache(COEFF_DIR / "inv_sbox_hi2d_coeffs.json"),
            CoefficientCache(COEFF_DIR / "inv_sbox_lo2d_coeffs.json"))

    # ------------------------------------------------------------------
    @property
    def blocks_per_ct(self) -> int:
        return self.eng.engine.slot_count // 16

    def pack_blocks(self, data: bytes) -> tuple[np.ndarray, int]:
        """PKCS#7-pad, chunk into 16-byte blocks, lay them out block after
        block (column-major within a block is byte order)."""
        blocks = chunk_bytes(pkcs7_pad(bytes(data)))
        if len(blocks) > self.blocks_per_ct:
            raise ValueError(f"{len(blocks)} blocks do not fit one "
                             f"ciphertext of {self.blocks_per_ct}")
        flat = np.zeros(self.eng.engine.slot_count, dtype=np.uint8)
        for b, blk in enumerate(blocks):
            flat[16 * b:16 * b + 16] = np.frombuffer(blk, dtype=np.uint8)
        return flat, len(blocks)

    def encrypt_state(self, state_bytes: np.ndarray) -> NibblePair:
        hi, lo = split_nibbles(np.asarray(state_bytes, dtype=np.uint8))
        return NibblePair(self.eng.encrypt(ZetaEncoder.to_zeta(hi, 16)),
                          self.eng.encrypt(ZetaEncoder.to_zeta(lo, 16)))

    def decrypt_state(self, pair: NibblePair) -> np.ndarray:
        hi = ZetaEncoder.from_zeta(self.eng.decrypt(pair.hi), 16)
        lo = ZetaEncoder.from_zeta(self.eng.decrypt(pair.lo), 16)
        return (hi.astype(np.uint8) << 4) | lo.astype(np.uint8)

    # ------------------------------------------------------------------
    def _tile_key(self, rk: np.ndarray) -> np.ndarray:
        return np.tile(rk, self.eng.engine.slot_count // 16)

    def add_round_key(self, pair: NibblePair, round_idx: int) -> NibblePair:
        k_hi, k_lo = split_nibbles(self._tile_key(self.round_keys[round_idx]))
        return NibblePair(self.xor._xor_with_plain_nibbles(pair.hi, k_hi),
                          self.xor._xor_with_plain_nibbles(pair.lo, k_lo))

    def sub_bytes(self, pair: NibblePair, inverse: bool = False,
                  cleanse: bool = True) -> NibblePair:
        caches = self._inv_sbox2d if inverse else self._sbox2d
        bases = (self.xor._build_power_basis(pair.hi),
                 self.xor._build_power_basis(pair.lo))
        hi = self.tf._bilinear(bases[0], bases[1], caches[0].load_coeffs())
        lo = self.tf._bilinear(bases[0], bases[1], caches[1].load_coeffs())
        if cleanse:
            # squash accumulated noise before MixColumns' XOR tree
            # amplifies it past the zeta16 decode margin
            hi = self.xor.cleanse(hi)
            lo = self.xor.cleanse(lo)
        return NibblePair(hi, lo)

    def shift_rows(self, pair: NibblePair, inverse: bool = False) -> NibblePair:
        return NibblePair(self.sr.shift_rows_simd(pair.hi, inverse=inverse),
                          self.sr.shift_rows_simd(pair.lo, inverse=inverse))

    def shift_mix(self, pair: NibblePair, inverse: bool = False) -> NibblePair:
        hook = self._refresh if self.segment_refresh else None
        return self.tf.merged_shift_mix_pairs(pair, inverse=inverse,
                                              refresh=hook)

    # multiplicative depth of each round op (rescale units), measured per
    # stage on the deep profile: ARK 48->43, SubBytes+cleanse 43->29,
    # merged shift-mix 29->6; a refresh runs before an op would exhaust the
    # chain
    SUB_DEPTH = 14
    MIX_DEPTH = 23
    ARK_DEPTH = 5
    CLEANSE_DEPTH = 6
    ROUND_DEPTH = 2 * ARK_DEPTH + SUB_DEPTH + MIX_DEPTH      # 47
    POST_BOOT_CLEANSES = 4
    # per-stage need in segment-refresh mode: one 2D LUT stage is basis (3)
    # + bilinear (2), with no margin (a looser trigger would refresh after
    # every stage on a production chain)
    SEG_STAGE_DEPTH = 5

    def _refresh(self, pair: NibblePair, need: int) -> NibblePair:
        """Refresh both nibbles if fewer than `need` depth units remain,
        then cleanse post_boot_cleanses times.  In segment mode a state
        with plenty of levels is cleansed at each stage boundary instead:
        the in-round cleanses are gone there, and a fresh state descending
        30+ levels before its first refresh would otherwise compound the
        per-stage LUT gain (~30-100x) past the decode margin."""
        if self.refresh is None:
            return pair
        r = self.eng.engine.params.rescale_primes

        def one(ct):
            if ct.level < need * r + 2:
                with trace.span("ckks.aes.refresh"):
                    ct = self.refresh(ct)
                    for _ in range(self.post_boot_cleanses):
                        ct = self.xor.cleanse(ct)
            elif self.segment_refresh and ct.level >= (need + 6) * r + 2:
                with trace.span("ckks.aes.refresh"):
                    ct = self.xor.cleanse(ct)
            return ct

        return NibblePair(one(pair.hi), one(pair.lo))

    def _cleanse_input(self, pair: NibblePair) -> NibblePair:
        """Cleanse the input once where the chain holds that on top of a
        round (not on deep, whose 48 levels hold exactly one).  A fresh
        public-key encryption's phase error grows ~N (its ternary mask is
        dense): 1.7e-4 zeta16 steps at N=2^10, 1.7e-2 at N=2^16 on
        prod_boot's primes, and the round's LUTs amplify that past the 0.5
        decode margin (every byte wrong).  The reference has no such step;
        one cleanse brings the error to ~1e-3 steps."""
        if not self.input_cleanse_fits(min(pair.hi.level, pair.lo.level)):
            return pair
        return self.cleanse_pair(pair)

    def input_cleanse_fits(self, level: int) -> bool:
        """Whether a cleanse and one round fit above `level`."""
        r = self.eng.engine.params.rescale_primes
        return level >= (self.ROUND_DEPTH + self.CLEANSE_DEPTH) * r + 1

    def cleanse_pair(self, pair: NibblePair) -> NibblePair:
        return NibblePair(self.xor.cleanse(pair.hi), self.xor.cleanse(pair.lo))

    # ------------------------------------------------------------------
    def encrypt_rounds(self, pair: NibblePair, rounds: int = 10) -> NibblePair:
        """ARK(rk0) then AES rounds 1..rounds (round 10 with plain
        ShiftRows); rounds < 10 is a partial evaluation that equals
        aes_tables.aes128_partial.  In segment mode round 10's ShiftRows
        is refreshed first when a nibble has no level left, where the
        reference raises "out of levels"."""
        seg = self.segment_refresh
        with trace.span("ckks.aes.ark"):
            pair = self.add_round_key(self._cleanse_input(pair), 0)
        for r in range(1, rounds + 1):
            with trace.span("ckks.aes.round"):
                pair = self._refresh(pair, self.SEG_STAGE_DEPTH if seg
                                     else self.SUB_DEPTH)
                # in segment mode the refresh's cleanses replace the
                # post-SubBytes cleanse (11 levels would not fit the budget)
                with trace.span("ckks.aes.sub_bytes"):
                    pair = self.sub_bytes(pair, cleanse=not seg)
                if r == 10:
                    if seg and min(pair.hi.level, pair.lo.level) == 0:
                        # the reference refreshes nothing here, and a
                        # segment's SubBytes ends at level 0 on prod_boot's
                        # chain: its ShiftRows (one mask product) would run
                        # out of levels
                        pair = self._refresh(pair, 0)
                    with trace.span("ckks.aes.shift_mix"):
                        pair = self.shift_rows(pair)
                else:
                    if not seg:
                        pair = self._refresh(pair, self.MIX_DEPTH)
                    with trace.span("ckks.aes.shift_mix"):
                        pair = self.shift_mix(pair)
                pair = self._refresh(pair, self.SEG_STAGE_DEPTH if seg
                                     else self.ARK_DEPTH)
                with trace.span("ckks.aes.ark"):
                    pair = self.add_round_key(pair, r)
        return pair

    def decrypt_rounds(self, pair: NibblePair, rounds: int = 10) -> NibblePair:
        """Inverse cipher: undo rounds `rounds`..1, then ARK(rk0).

        The reference cleanses after the inverse SubBytes and nowhere else.
        But the inverse MixColumns runs every term through a GF(9/11/13/14)
        LUT pair and amplifies its input's phase error ~40-70x (the forward
        transform ~35x: half its terms are x1), and the inverse S-box LUT
        amplifies that further: in the reference's order one round from a
        fresh encryption decodes 85 of 2048 bytes wrong on deep.  So here
        the AddRoundKey output is cleansed before the inverse MixColumns,
        and the inverse SubBytes runs without a cleanse (the same levels).
        In segment mode the refreshes go between the stages as
        encrypt_rounds places them."""
        seg = self.segment_refresh
        with trace.span("ckks.aes.ark"):
            pair = self._cleanse_input(pair)
        for r in range(rounds, 0, -1):
            with trace.span("ckks.aes.round"):
                pair = self._refresh(pair, self.SEG_STAGE_DEPTH if seg else
                                     self.ARK_DEPTH + self.CLEANSE_DEPTH
                                     + self.MIX_DEPTH)
                with trace.span("ckks.aes.ark"):
                    pair = self.add_round_key(pair, r)
                with trace.span("ckks.aes.shift_mix"):
                    if not seg:
                        pair = self.cleanse_pair(pair)
                    if r == 10:
                        pair = self.shift_rows(pair, inverse=True)
                    else:
                        pair = self.shift_mix(pair, inverse=True)
                pair = self._refresh(pair, self.SEG_STAGE_DEPTH if seg
                                     else self.SUB_DEPTH - self.CLEANSE_DEPTH)
                with trace.span("ckks.aes.sub_bytes"):
                    pair = self.sub_bytes(pair, inverse=True, cleanse=False)
        pair = self._refresh(pair, self.SEG_STAGE_DEPTH if seg
                             else self.ARK_DEPTH)
        with trace.span("ckks.aes.ark"):
            return self.add_round_key(pair, 0)

    def encrypt_bytes(self, data: bytes, rounds: int = 10) -> bytes:
        """Host bytes in, homomorphically AES-encrypted host bytes out."""
        flat, nblocks = self.pack_blocks(data)
        pair = self.encrypt_rounds(self.encrypt_state(flat), rounds=rounds)
        return bytes(self.decrypt_state(pair)[:16 * nblocks])


class AESFHE128Bitsliced:
    ROUND_DEPTH = 14          # rescale units consumed by one middle round

    def __init__(self, eng_wrap: EngineWrapper, key: bytes | np.ndarray,
                 refresh: Optional[Callable[[Ciphertext], Ciphertext]] = None):
        self.eng = eng_wrap
        self.svc = BitSliceService(eng_wrap)
        self.round_keys = expand_key_128(key)
        self.inv_round_keys = equivalent_inverse_keys(self.round_keys)
        self.refresh = refresh

    def encrypt_state(self, state_bytes: np.ndarray) -> BitState:
        return self.svc.encrypt_state(state_bytes)

    def decrypt_state(self, st: BitState) -> np.ndarray:
        return self.svc.decrypt_state(st)

    def _refresh(self, st: BitState, need_levels: int) -> BitState:
        """Pair-packed refresh: two real planes ride one complex refresh as
        p0 + i*p1 (exact i-multiply), unpacked by one conjugation and two
        2-term combines, then sign-cleansed.  A no-op without `refresh` or
        while the state still has `need_levels` levels."""
        if self.refresh is None:
            return st
        eng = self.eng.engine
        need = need_levels * eng.params.rescale_primes + 2
        if min(b.level for b in st.bits) >= need:
            return st
        with trace.span("ckks.aes.refresh"):
            out = [None] * len(st.bits)
            for p in range(0, len(st.bits), 2):
                packed = eng.add(st.bits[p], eng.multiply_i(st.bits[p + 1]))
                z = self.refresh(packed)
                zc = eng.conjugate(z, self.eng.conj_key)
                out[p] = eng.linear_combination([z, zc], [0.5, 0.5])
                out[p + 1] = eng.linear_combination([z, zc], [-0.5j, 0.5j])
            return self.svc.cleanse(BitState(out))

    def encrypt_rounds(self, st: BitState, rounds: int = 10,
                       checkpoint_dir: str | Path | None = None) -> BitState:
        """FIPS-197 order: ARK(rk_{r-1}) + SubBytes + ShiftRows (+MixColumns
        and cleanse) per round; round 10 folds ARK(rk10) into the ShiftRows
        masks.  A partial run (rounds < 10) closes with ARK(rk_rounds), so
        it matches aes_tables.aes128_partial.

        `checkpoint_dir` saves the 8 plane ciphertexts after each round and,
        on re-entry, resumes after the deepest saved round <= `rounds`."""
        svc = self.svc
        start = 1
        if checkpoint_dir:
            saved, done = self._load_checkpoint(checkpoint_dir, rounds)
            if done:
                st, start = saved, done + 1
        for r in range(start, rounds + 1):
            with trace.span("ckks.aes.round"):
                st = self._refresh(st, self.ROUND_DEPTH)
                with trace.span("ckks.aes.ark"):
                    st = svc.xor_plain(st, self.round_keys[r - 1])
                with trace.stage(self.eng.engine, "sub_bytes"):
                    st = svc.sub_bytes(st)
                with trace.stage(self.eng.engine, "shift_mix"):
                    if r == 10:
                        st = svc.shift_rows(st, fold_key=self.round_keys[10])
                    else:
                        st = svc.cleanse(svc.mix_columns(svc.shift_rows(st)))
            if checkpoint_dir:
                self._save_checkpoint(checkpoint_dir, r, st)
        if rounds < 10:
            with trace.span("ckks.aes.ark"):
                st = svc.xor_plain(st, self.round_keys[rounds])
        return st

    # -- per-round checkpoint / resume ------------------------------------
    @staticmethod
    def _ckpt_path(checkpoint_dir, r: int, k: int) -> Path:
        return Path(checkpoint_dir) / f"round{r:02d}_plane{k}.npz"

    def _run_digest(self) -> str:
        """Binds a checkpoint directory to this evaluation: the params'
        fingerprint and the expanded round keys (the reference's digest)."""
        h = hashlib.sha256()
        h.update(params_fingerprint(self.eng.engine.params).encode())
        for rk in self.round_keys:
            h.update(bytes(np.asarray(rk, dtype=np.uint8)))
        return h.hexdigest()[:16]

    def _save_checkpoint(self, checkpoint_dir, r: int, st: BitState):
        """Each plane written to a temporary file and renamed into place,
        the round's marker last: a crash mid-save never leaves a round that
        looks resumable."""
        d = Path(checkpoint_dir)
        d.mkdir(parents=True, exist_ok=True)
        manifest = d / "manifest.json"
        if not manifest.exists():
            tmp = manifest.with_suffix(".tmp")
            tmp.write_text(json.dumps({"digest": self._run_digest()}))
            os.replace(tmp, manifest)
        for k, ct in enumerate(st.bits):
            path = self._ckpt_path(d, r, k)
            # the temporary keeps the .npz suffix, or np.savez appends one
            tmp = path.with_name("tmp_" + path.name)
            save_ciphertext(tmp, ct)
            os.replace(tmp, path)
        marker = d / f"round{r:02d}.complete"
        tmp = marker.with_suffix(".tmp")
        tmp.write_text("ok")
        os.replace(tmp, marker)

    def _load_checkpoint(self, checkpoint_dir, max_round: int):
        """(state, round) of the deepest complete round <= max_round, or
        (None, 0).  Refuses a directory whose manifest belongs to another
        run (AES key or params differ) or that has planes but no manifest."""
        d = Path(checkpoint_dir)
        manifest = d / "manifest.json"
        if not manifest.exists():
            if any(d.glob("round*_plane*.npz")):
                raise RuntimeError(
                    f"checkpoint dir {d} has round files but no manifest; "
                    "refusing to resume unverifiable state")
            return None, 0
        digest = json.loads(manifest.read_text()).get("digest")
        if digest != self._run_digest():
            raise RuntimeError(
                f"checkpoint dir {d} belongs to a different run (manifest "
                "digest mismatch: AES key or params differ); use a fresh "
                "checkpoint_dir")
        dev = self.eng.engine.device
        for r in range(max_round, 0, -1):
            if not (d / f"round{r:02d}.complete").exists():
                continue
            paths = [self._ckpt_path(d, r, k) for k in range(8)]
            if all(p.exists() for p in paths):
                return BitState([load_ciphertext(p, device=dev)
                                 for p in paths]), r
        return None, 0

    # levels of the inverse round's stages at prod_boot (one scale unit a
    # level): InvSubBytes 4, InvShiftRows 1, InvMixColumns 6 (row masks,
    # then a product tree of depth 5: its planes are products of 11 to 19
    # masked rotations), the cleanse 3, which make ROUND_DEPTH
    INV_MIX_DEPTH = 6
    CLEANSE_DEPTH = 3

    def decrypt_round(self, st: BitState, i: int, rounds: int = 10,
                      work: int | None = None) -> BitState:
        """Round i (1..rounds) of the inverse of a `rounds`-round cipher,
        in the equivalent inverse cipher's order (FIPS-197 5.3.5) with one
        cleanse: InvSubBytes, InvShiftRows, then InvMixColumns with
        AddRoundKey(dw) folded into its first factor's row masks (no
        level), then the cleanse; ROUND_DEPTH levels.  Round i undoes the
        SubBytes and ShiftRows of AES round r = rounds + 1 - i and the
        MixColumns and AddRoundKey of round r - 1.  Round 1 adds w[10]
        first (one plaintext multiply), or for rounds < 10 undoes that
        round's MixColumns first (dw[rounds] folded, and a cleanse); the
        last round folds w[0] into its InvShiftRows masks and ends there.

        A pair-packed refresh first unless i is 1, when the state lacks
        ROUND_DEPTH levels.  `work` then drops the state to that level
        (round 1 of a partial inverse to the levels its extra MixColumns
        needs above it)."""
        svc = self.svc
        eng = self.eng.engine
        r = rounds + 1 - i
        with trace.span("ckks.aes.round"):
            if i > 1:
                st = self._refresh(st, self.ROUND_DEPTH)
            if work is not None:
                if i == 1 and rounds < 10:
                    work += self.INV_MIX_DEPTH + self.CLEANSE_DEPTH
                if st.level > work:
                    st = BitState([eng._drop(b, work) for b in st.bits])
            if i == 1:
                if rounds == 10:
                    with trace.span("ckks.aes.ark"):
                        st = svc.xor_plain(st, self.round_keys[10])
                else:
                    with trace.stage(eng, "shift_mix"):
                        st = svc.cleanse(svc.mix_columns(
                            st, inverse=True,
                            fold_key=self.inv_round_keys[rounds],
                            align=False))
                        # the cleanse left every plane on Delta: one level
                        # for SubBytes' products
                        st = BitState([eng._drop(b, st.level)
                                       for b in st.bits])
            with trace.stage(eng, "sub_bytes"):
                st = svc.sub_bytes(st, inverse=True)
            with trace.stage(eng, "shift_mix"):
                if r == 1:
                    return svc.shift_rows(st, inverse=True,
                                          fold_key=self.round_keys[0])
                st = svc.shift_rows(st, inverse=True)
                return svc.cleanse(svc.mix_columns(
                    st, inverse=True, fold_key=self.inv_round_keys[r - 1],
                    align=False))

    def decrypt_rounds(self, st: BitState, rounds: int = 10) -> BitState:
        """Inverse cipher: the inverse of encrypt_rounds(., rounds), round
        by round (decrypt_round), refreshing where a round lacks levels."""
        for i in range(1, rounds + 1):
            st = self.decrypt_round(st, i, rounds)
        return st
