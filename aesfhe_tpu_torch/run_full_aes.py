"""The flagship: the full 10-round bit-sliced homomorphic AES-128 with
pair-packed bootstrap refreshes, held block by block against the AES oracle.
Counterpart of `scripts/run_full_aes.py`.

    python3 -m aesfhe_tpu_torch.run_full_aes [--rounds 10] [--profile prod_boot]
                                             [--seed 0] [--device cuda]
                                             [--boot fused|eager]

Keygen (the round's key family, the bootstrap's Galois keys shared into the
round's rotation set), 2048 blocks at prod_boot (slot_count / 16; block 0 is
FIPS-197 C.1's plaintext, the rest random from the seed), encrypt, drop to
the uniform work level ROUND_DEPTH + 1 = 15, then the rounds: round 1 runs
on the fresh (exact) state, every later round after a refresh of the eight
planes as four pair-packed bootstraps.  The bootstraps replay the fused
bootstrap (one CUDA graph per input signature, captured at the first
refresh, as the reference's flagship sets AESFHE_FUSED_BOOT=1) unless
`--boot eager` asks for the eager one.  The result decrypts to
aes128_partial(block, key, rounds) for every block, and with 10 rounds block
0 equals FIPS-197 C.1's ciphertext.  Prints one JSON line (blocks/s, s per
round, s per bootstrap, counters, peak device memory); writes no file.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import kernels, trace
from .aes_tables import aes128_partial
from .ops.bitplane import BitState
from .ops.xor_service import EngineWrapper, XORConfig
from .pipeline import AESFHE128Bitsliced

FIPS_KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CT = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_state(slot_count: int, seed: int) -> np.ndarray:
    """slot_count bytes = slot_count/16 AES blocks, random from `seed`, with
    block 0 set to FIPS-197 C.1's plaintext."""
    state = np.random.default_rng(seed).integers(0, 256, slot_count,
                                                 dtype=np.uint8)
    state[:16] = np.frombuffer(FIPS_PT, dtype=np.uint8)
    return state


def setup(profile: str, seed: int, device="cuda", fused_boot: bool = True):
    """(AES pipeline with bootstrap refresh, keygen seconds): the key
    family and bootstrap key from `seed`, the bootstrap's Galois keys shared
    with the round's rotation set before the round services add theirs;
    the refresh replays the fused bootstrap unless fused_boot is False."""
    t0 = time.perf_counter()
    wrap = EngineWrapper(XORConfig(profile=profile, rotation_steps=(),
                                   device=device, use_bootstrap=True,
                                   fused_boot=fused_boot),
                         rng=np.random.default_rng(seed))
    wrap.rot_key.keys.update(wrap.boot_key.rot.keys)
    aes = AESFHE128Bitsliced(wrap, FIPS_KEY, refresh=wrap.bootstrap)
    sync(wrap.engine.device)
    return aes, time.perf_counter() - t0


def key_gib(keys) -> float:
    return sum(k.b.numel() + k.a.numel() for k in keys) * 4 / 2 ** 30


def run_round(aes: AESFHE128Bitsliced, st: BitState, r: int,
              rounds: int) -> BitState:
    """Round r of a `rounds`-round run from the uniform work level
    ROUND_DEPTH + 1: a pair-packed refresh first unless r is 1 (the fresh
    state is exact), ARK + SubBytes + ShiftRows (+ MixColumns and cleanse
    before round 10, whose ShiftRows folds ARK(rk10)); a run that stops
    before round 10 closes with ARK(rk_rounds), as aes128_partial does."""
    eng = aes.eng.engine
    svc = aes.svc
    work = aes.ROUND_DEPTH + 1
    with trace.span("ckks.aes.round"):
        if r > 1:
            st = aes._refresh(st, aes.ROUND_DEPTH)
        if st.level > work:
            st = BitState([eng._drop(b, work) for b in st.bits])
        with trace.span("ckks.aes.ark"):
            st = svc.xor_plain(st, aes.round_keys[r - 1])
        with trace.span("ckks.aes.sub_bytes"):
            st = svc.sub_bytes(st)
        with trace.span("ckks.aes.shift_mix"):
            if r == 10:
                return svc.shift_rows(st, fold_key=aes.round_keys[10])
            st = svc.cleanse(svc.mix_columns(svc.shift_rows(st)))
        if r == rounds:
            with trace.span("ckks.aes.ark"):
                st = svc.xor_plain(st, aes.round_keys[rounds])
        return st


def run_flagship(aes: AESFHE128Bitsliced, state: np.ndarray,
                 rounds: int) -> dict:
    """Encrypt `state`, run `rounds` rounds (run_round), decrypt and check
    every block against the AES oracle.  The engine counters and every
    kernel's launch count (`kernels.launch_counts`) are zeroed just before
    the rounds and read just after them."""
    wrap = aes.eng
    eng = wrap.engine
    dev = eng.device
    sc = eng.slot_count
    work = aes.ROUND_DEPTH + 1
    t0 = time.perf_counter()
    st = aes.encrypt_state(state)
    st = BitState([eng._drop(b, work) for b in st.bits])
    sync(dev)
    encrypt_s = time.perf_counter() - t0

    boot_s = []
    refresh = aes.refresh

    def timed_refresh(ct):
        tb = time.perf_counter()
        out = refresh(ct)
        sync(dev)
        boot_s.append(time.perf_counter() - tb)
        return out

    aes.refresh = timed_refresh
    bk = wrap.boot_key
    eng.reset_counters()
    kernels.zero_launches()
    round_s, levels = [], []
    t_all = time.perf_counter()
    try:
        for r in range(1, rounds + 1):
            tr = time.perf_counter()
            st = run_round(aes, st, r, rounds)
            sync(dev)
            round_s.append(time.perf_counter() - tr)
            levels.append(st.level)
    finally:
        aes.refresh = refresh
    wall = time.perf_counter() - t_all
    launches = kernels.launch_counts()
    counters = dict(eng.counters)

    got = aes.decrypt_state(st)
    want = np.concatenate([aes128_partial(state[b:b + 16], FIPS_KEY, rounds)
                           for b in range(0, sc, 16)])
    worst = 0.0
    for ct in st.bits:
        v = np.real(wrap.decrypt(ct))
        if v.shape != (sc,) or not np.all(np.isfinite(v)):
            raise AssertionError("a decrypted plane is not finite or has "
                                 f"shape {v.shape}, not ({sc},)")
        worst = max(worst, float(np.max(np.abs(np.abs(v) - 1.0))))
    out = dict(
        rounds=rounds, blocks=sc // 16, work_level=work,
        encrypt_s=encrypt_s, wall_s=wall,
        blocks_per_s=(sc // 16) / wall, s_per_round=wall / rounds,
        round_s=round_s, round_exit_levels=levels,
        bootstraps=counters["bootstrap"], bootstrap_s=boot_s,
        first_bootstrap_s=boot_s[0] if boot_s else None,
        steady_bootstrap_s=(float(np.median(boot_s[1:]))
                            if len(boot_s) > 1 else None),
        keyswitches=counters["keyswitch"], launches=launches,
        counters=counters,
        diag_stacks=len(bk.diags), diag_hits=bk.diag_hits,
        diag_misses=bk.diag_misses,
        diag_gib=sum(t.numel() for t in bk.diags.values()) * 4 / 2 ** 30,
        fused_boot=wrap.fused_boot,
        graphs=[dict(in_level=f.in_level, in_scale=f.in_scale,
                     capture_s=f.capture_s, pool_gib=f.pool_bytes / 2 ** 30,
                     per_replay=f.deltas)
                for f in wrap.fused_instances.values()],
        max_slot_err=worst,
        bad_bytes=int(np.sum(got != want)),
        exact=bool(np.array_equal(got, want)))
    if rounds == 10:
        out["fips_block0"] = bytes(got[:16]) == FIPS_CT
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="prod_boot")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--boot", choices=("fused", "eager"), default="fused",
                    help="replay the captured bootstrap (fused) or run it "
                         "op by op (eager)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    aes, keygen_s = setup(args.profile, args.seed, args.device,
                          fused_boot=args.boot == "fused")
    wrap = aes.eng
    state = make_state(wrap.engine.slot_count, args.seed + 1)
    res = run_flagship(aes, state, args.rounds)
    res.update(
        profile=args.profile, seed=args.seed, keygen_s=keygen_s,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        bootstrap_keys=len(wrap.boot_key.rot.keys),
        bootstrap_keys_gib=key_gib(wrap.boot_key.rot.keys.values()),
        all_keys=len(wrap.rot_key.keys) + 2,
        peak_device_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None))
    print(json.dumps(res))
    if not res["exact"] or not res.get("fips_block0", True):
        raise SystemExit(f"flagship result wrong: {res['bad_bytes']} bytes "
                         "differ from the AES oracle")
    return res


if __name__ == "__main__":
    main()
