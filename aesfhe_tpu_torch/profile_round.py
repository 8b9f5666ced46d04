"""Where the time of the bit-sliced AES rounds, of one refresh, or of one
zeta round goes on the card.

    python -m aesfhe_tpu_torch.profile_round [--rounds 2] [--profile prod_boot]
    python -m aesfhe_tpu_torch.profile_round --refresh [--graph]
                                             [--profile prod_boot]
    python -m aesfhe_tpu_torch.profile_round --zeta [--profile prod_boot]

Rounds: generates the key family from a seed, encrypts 2048 random blocks,
drops them to the uniform work level ROUND_DEPTH * rounds + 1, runs the
rounds once untraced (warm-up) and once under torch.profiler.

`--refresh`: the flagship's setup (run_full_aes.setup: the bootstrap key
and its Galois keys shared into the round's set), one round from the work
level ROUND_DEPTH + 1 to reach the state a refresh meets, one pair-packed
refresh (4 bootstraps) untraced, which fills the diagonal cache, and a
second one under torch.profiler; then one more bootstrap with the phase
timer on (each phase waits for the card), for the seconds and exit level
of each phase.  The refreshes run the eager bootstrap; with `--graph` the
same warm refresh is traced twice, eager and with every bootstrap a replay
of the fused bootstrap's CUDA graph (captured in its warm-up), each beside
its untraced wall (CUDA events), so the device busy share of each shows
what the graph takes off the host.

`--zeta`: the nibble-pair pipeline (AESFHE128) with direct rotation keys
for its merged ShiftRows+MixColumns, 2048 random blocks encrypted fresh,
ARK(rk0) and round 1 once untraced and once under torch.profiler.

Prints one JSON object: the traced wall time, the summed device kernel
time and its share of the wall (the rest is the card idling on the host),
the key-switch kernel's share, and the kernels that take the most device
time (with `--graph` one such record each for "eager" and "graph").
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import run_full_aes, zeta_trace
from .core import ks_inner
from .ops.bitplane import BitState
from .ops.xor_service import EngineWrapper, XORConfig
from .pipeline import AESFHE128, AESFHE128Bitsliced

KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _rounds_work(args):
    """(what to trace, its description) for the rounds."""
    wrap = EngineWrapper(XORConfig(profile=args.profile, rotation_steps=(),
                                   device="cuda"),
                         rng=np.random.default_rng(args.seed))
    aes = AESFHE128Bitsliced(wrap, KEY)
    eng = wrap.engine
    work = AESFHE128Bitsliced.ROUND_DEPTH * args.rounds + 1
    state = np.random.default_rng(args.seed + 1).integers(
        0, 256, eng.slot_count, dtype=np.uint8)
    st0 = BitState([eng._drop(b, work) for b in
                    aes.encrypt_state(state).bits])
    return (lambda: aes.encrypt_rounds(st0, rounds=args.rounds),
            dict(rounds=args.rounds, work_level=work))


def _refresh_work(args):
    """(what to trace, its description) for one pair-packed refresh."""
    aes, _ = run_full_aes.setup(args.profile, args.seed, fused_boot=False)
    eng = aes.eng.engine
    state = run_full_aes.make_state(eng.slot_count, args.seed + 1)
    st = BitState([eng._drop(b, aes.ROUND_DEPTH + 1) for b in
                   aes.encrypt_state(state).bits])
    st = run_full_aes.run_round(aes, st, 1, 10)
    phases: list = []
    packed = eng.add(st.bits[0], eng.multiply_i(st.bits[1]))

    def phase_run():
        aes.eng.fused_boot = False
        aes.eng.bootstrap(packed, phases=phases)
        return [dict(phase=n, s=s, exit_level=lvl, ops=ops)
                for n, s, lvl, ops in phases]

    return (lambda: aes._refresh(st, aes.ROUND_DEPTH),
            dict(refresh_input_level=st.level, bootstraps_traced=4,
                 phase_run=phase_run, wrap=aes.eng))


def _zeta_work(args):
    """(what to trace, its description) for one zeta round from fresh."""
    wrap, (xs, tf, sr), _ = zeta_trace.setup(args.profile, args.seed,
                                             "cuda", bootstrap=False)
    aes = AESFHE128(wrap, xs, tf, sr, KEY)
    state = np.random.default_rng(args.seed + 1).integers(
        0, 256, wrap.engine.slot_count, dtype=np.uint8)
    pair = aes.encrypt_state(state)
    return (lambda: aes.encrypt_rounds(pair, rounds=1),
            dict(zeta_rounds=1, input_level=pair.hi.level))


def _trace(work) -> dict:
    """Warm-up, one untraced run (CUDA events) and one run under
    torch.profiler: walls, device kernel time and busy shares, the
    key-switch kernel's launches and share, the top kernels."""
    work()                                               # warm-up
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    work()
    ev1.record()
    torch.cuda.synchronize()
    untraced = ev0.elapsed_time(ev1) / 1e3
    ks_inner.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ks_inner.launches

    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type is not None and \
                "cuda" in str(evt.device_type).lower():
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    device_s = sum(kernels.values()) / 1e6
    ks_s = sum(v for k, v in kernels.items() if "ks_inner" in k) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return dict(untraced_wall_s=untraced, traced_wall_s=wall,
                device_kernel_s=device_s,
                device_busy_share=device_s / wall if wall else None,
                device_busy_share_untraced=device_s / untraced,
                ks_inner_s=ks_s, ks_inner_launches=launches,
                ks_inner_share_of_device=ks_s / device_s if device_s else None,
                top_kernels_s=[(k[:90], v / 1e6) for k, v in top])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="prod_boot")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--refresh", action="store_true",
                    help="trace one warm pair-packed refresh instead")
    ap.add_argument("--graph", action="store_true",
                    help="with --refresh: trace it eager and as graph "
                         "replays")
    ap.add_argument("--zeta", action="store_true",
                    help="trace one zeta nibble-pair round instead")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round: needs a CUDA card")
    if args.graph and not args.refresh:
        raise SystemExit("profile_round: --graph needs --refresh")

    work, desc = (_zeta_work if args.zeta else _refresh_work if args.refresh
                  else _rounds_work)(args)
    phase_run = desc.pop("phase_run", None)
    wrap = desc.pop("wrap", None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = dict(card=card, profile=args.profile, **desc)
    if args.graph:
        out["eager"] = _trace(work)
        wrap.fused_boot = True
        out["graph"] = _trace(work)
        out["graphs"] = [dict(capture_s=f.capture_s,
                              pool_gib=f.pool_bytes / 2 ** 30)
                         for f in wrap.fused_instances.values()]
    else:
        out.update(_trace(work))
    if phase_run is not None:
        out["bootstrap_phases"] = phase_run()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
