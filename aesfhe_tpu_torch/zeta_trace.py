"""Stage-by-stage trace of one zeta nibble-pair round, each way.

    python3 -m aesfhe_tpu_torch.zeta_trace [--profile prod_boot] [--seed 0]
                                           [--device cuda] [--segment]

Keygen (relin, conj, direct Galois keys for the merged ShiftRows+MixColumns
steps; with --segment also the bootstrap key), 2048 random blocks at
prod_boot encrypted fresh, then:
  - forward: the stages of AESFHE128.encrypt_rounds(rounds=1) without a
    refresh (the input cleanse where the chain has room, ARK(rk0),
    SubBytes+cleanse, merged ShiftRows+MixColumns, ARK(rk1));
  - inverse: the stages of decrypt_rounds(rounds=1) without a refresh, and
    the reference's inverse order (ARK, inverse MixColumns, inverse
    SubBytes+cleanse, ARK) for comparison;
  - with --segment: one round each way through encrypt_rounds /
    decrypt_rounds in the segment-refresh schedule with the bootstrap
    (segment_refresh=True, post_boot_cleanses=2).
After the fresh encryption and every stage it prints the seconds (the card synchronized), level,
scale/Delta, wrong bytes against the plain AES intermediate, the largest
phase error of the two nibbles in zeta16 steps (a slot decodes right below
0.5), key-switches, kernel launches and bootstraps so far.  Wrong bytes are
reported, not raised: the reference's inverse order is expected to fail.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from . import aes_tables
from .core import ks_inner
from .ops.mixcolumns_service import AESFHETransformer
from .ops.shiftrows_service import AESFHEShiftRows
from .ops.xor_service import EngineWrapper, XORConfig, XORService
from .ops.zeta import phase_error, split_nibbles
from .pipeline import AESFHE128

KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")


def setup(profile: str, seed: int, device, bootstrap: bool):
    """(wrapper, services, keygen seconds) with direct shift-mix keys."""
    t0 = time.perf_counter()
    wrap = EngineWrapper(XORConfig(profile=profile, rotation_steps=(),
                                   device=device, use_bootstrap=bootstrap),
                         rng=np.random.default_rng(seed))
    if bootstrap:
        wrap.rot_key.keys.update(wrap.boot_key.rot.keys)
    xs = XORService(wrap)
    tf = AESFHETransformer(wrap, xs)
    wrap.ensure_rotation_steps(tf.rotation_steps() +
                               tf.rotation_steps(inverse=True))
    sr = AESFHEShiftRows(wrap, xs)
    _sync(wrap)
    return wrap, (xs, tf, sr), time.perf_counter() - t0


def _sync(wrap):
    if wrap.engine.device.type == "cuda":
        torch.cuda.synchronize()


def intermediates(state: np.ndarray, round_keys) -> dict:
    """The plain values after each stage of round 1."""
    sc = len(state)
    a0 = state ^ np.tile(round_keys[0], sc // 16)
    s1 = aes_tables.AES_SBOX[a0]
    m1 = np.concatenate([aes_tables.mix_columns(aes_tables.shift_rows(
        s1[b:b + 16])) for b in range(0, sc, 16)])
    return dict(p=state, a0=a0, s1=s1, m1=m1,
                c1=m1 ^ np.tile(round_keys[1], sc // 16))


def run_stages(aes: AESFHE128, name: str, start: np.ndarray,
               stages) -> list[dict]:
    """Encrypt `start` fresh, then run [(tag, fn(pair), plain value)] and
    print one line per stage."""
    wrap = aes.eng
    eng = wrap.engine
    delta = eng.params.scale
    print(f"== {name}", flush=True)
    pair = aes.encrypt_state(start)
    eng.reset_counters()
    ks_inner.launches = 0
    _sync(wrap)
    rows = []
    for tag, fn, want in [("fresh", None, start)] + list(stages):
        t0 = time.perf_counter()
        if fn is not None:
            pair = fn(pair)
        _sync(wrap)
        sec = time.perf_counter() - t0
        hi, lo = split_nibbles(want)
        err = max(phase_error(wrap.decrypt(pair.hi), hi),
                  phase_error(wrap.decrypt(pair.lo), lo))
        row = dict(stage=tag, s=sec, level=pair.hi.level,
                   scale_over_delta=pair.hi.scale / delta,
                   wrong_bytes=int(np.sum(aes.decrypt_state(pair) != want)),
                   phase_error=err, keyswitch=eng.counters["keyswitch"],
                   launches=ks_inner.launches,
                   bootstraps=eng.counters["bootstrap"])
        rows.append(row)
        print(f"  {tag:10s} {sec:8.3f} s  level {row['level']:2d}  "
              f"scale/Delta {row['scale_over_delta']:.6f}  wrong bytes "
              f"{row['wrong_bytes']:5d}  phase error {err:.3e}  "
              f"key-switches {row['keyswitch']}  launches "
              f"{row['launches']}  bootstraps {row['bootstraps']}",
              flush=True)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="prod_boot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--segment", action="store_true",
                    help="one segment-refresh round each way, with the "
                         "bootstrap, instead of the stage traces")
    args = ap.parse_args(argv)
    wrap, (xs, tf, sr), keygen_s = setup(args.profile, args.seed,
                                         args.device, args.segment)
    if wrap.engine.device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip())
    print(f"keygen {keygen_s:.2f} s, {len(wrap.rot_key.keys)} rotation keys, "
          f"bootstrap key: {wrap.boot_key is not None}", flush=True)
    aes = AESFHE128(wrap, xs, tf, sr, KEY)
    state = np.random.default_rng(args.seed + 1).integers(
        0, 256, wrap.engine.slot_count, dtype=np.uint8)
    v = intermediates(state, aes.round_keys)
    out = {}
    if args.segment:
        aes.refresh = wrap.bootstrap
        aes.segment_refresh = True
        aes.post_boot_cleanses = 2
        out["segment_forward"] = run_stages(
            aes, "segment-refresh forward round", v["p"],
            [("round", lambda p: aes.encrypt_rounds(p, rounds=1), v["c1"])])
        out["segment_inverse"] = run_stages(
            aes, "segment-refresh inverse round", v["c1"],
            [("round", lambda p: aes.decrypt_rounds(p, rounds=1), v["p"])])
        return out

    top = ([("cleanse", aes.cleanse_pair)]
           if aes.input_cleanse_fits(wrap.engine.params.top_level) else [])
    out["forward"] = run_stages(aes, "forward round, no refresh", v["p"], [
        (t, f, v["p"]) for t, f in top] + [
        ("ark0", lambda p: aes.add_round_key(p, 0), v["a0"]),
        ("sub+cl", lambda p: aes.sub_bytes(p), v["s1"]),
        ("shift-mix", lambda p: aes.shift_mix(p), v["m1"]),
        ("ark1", lambda p: aes.add_round_key(p, 1), v["c1"])])
    out["inverse"] = run_stages(aes, "inverse round, no refresh", v["c1"], [
        (t, f, v["c1"]) for t, f in top] + [
        ("ark1", lambda p: aes.add_round_key(p, 1), v["m1"]),
        ("cleanse", aes.cleanse_pair, v["m1"]),
        ("inv-mix", lambda p: aes.shift_mix(p, inverse=True), v["s1"]),
        ("inv-sub", lambda p: aes.sub_bytes(p, inverse=True, cleanse=False),
         v["a0"]),
        ("ark0", lambda p: aes.add_round_key(p, 0), v["p"])])
    out["inverse_reference_order"] = run_stages(
        aes, "inverse round, the reference's order", v["c1"], [
            (t, f, v["c1"]) for t, f in top] + [
            ("ark1", lambda p: aes.add_round_key(p, 1), v["m1"]),
            ("inv-mix", lambda p: aes.shift_mix(p, inverse=True), v["s1"]),
            ("inv-sub+cl", lambda p: aes.sub_bytes(p, inverse=True),
             v["a0"]),
            ("ark0", lambda p: aes.add_round_key(p, 0), v["p"])])
    return out


if __name__ == "__main__":
    main()
