"""Where the time of the bit-sliced AES rounds, of one refresh, or of one
zeta round goes on the card.

    python -m aesfhe_tpu_torch.profile_round [--rounds 2] [--profile prod_boot]
    python -m aesfhe_tpu_torch.profile_round --refresh [--graph]
                                             [--profile prod_boot]
    python -m aesfhe_tpu_torch.profile_round --zeta [--profile prod_boot]
    python -m aesfhe_tpu_torch.profile_round --bench bitplane [--logn 18]

Rounds: generates the key family from a seed, encrypts 2048 random blocks,
drops them to the uniform work level ROUND_DEPTH * rounds + 1, runs the
rounds once untraced (warm-up) and once under torch.profiler.

`--refresh`: the flagship's setup (run_full_aes.setup: the bootstrap key
and its Galois keys shared into the round's set), one round from the work
level ROUND_DEPTH + 1 to reach the state a refresh meets, one pair-packed
refresh (4 bootstraps) untraced, which fills the diagonal cache, and a
second one under torch.profiler, with each bootstrap's phase times (the
engine's `boot.*_ns` counters, `bootstrap._PhaseTimer`).  The refreshes
run the eager bootstrap; with `--graph` the same warm refresh is traced
twice, eager and with every bootstrap a replay of the fused bootstrap's
CUDA graph (captured in its warm-up), each beside its untraced wall (CUDA
events), so the device busy share of each shows what the graph takes off
the host.

`--zeta`: the nibble-pair pipeline (AESFHE128) with direct rotation keys
for its merged ShiftRows+MixColumns, 2048 random blocks encrypted fresh,
ARK(rk0) and round 1 once untraced and once under torch.profiler.

`--bench MODE`: one step of bench's bitplane or zeta leg (`bench.SETUPS`,
its profile at N=2^logn, 16 levels, seed-0 keys), once untraced and once
under torch.profiler, after a warm-up step.

Prints one JSON object: the traced wall time, the summed device kernel
time and its share of the wall (the rest is the card idling on the host),
each of the port's kernels' device seconds, launches and shares, the
device time by the port's named ranges (`trace.py`: the CKKS primitives
under the reference's jax.named_scope names, the rounds' stages and the
bootstrap's phases; "self" without and "total" with the ranges nested
inside, and the time outside every range), with `--refresh` the
bootstrap's phase times, and the kernels that take the most device time
(with `--graph` one such record each for "eager" and "graph"; a replay's
kernels run under its `ckks.boot` range alone).
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import kernels, run_full_aes, trace, zeta_trace
from .core import ops_impl
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
    return (lambda: aes._refresh(st, aes.ROUND_DEPTH),
            dict(refresh_input_level=st.level, bootstraps_traced=4,
                 wrap=aes.eng))


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


def _bench_work(args):
    """(what to trace, its description) for one step of a bench leg."""
    from . import bench
    leg = bench.SETUPS[args.bench](args.logn, 16, "cuda")
    return (lambda: leg.step(*leg.args),
            dict(bench=args.bench, logn=args.logn, blocks=leg.blocks))


def _trace(work, eng=None) -> dict:
    """Warm-up, one untraced run (CUDA events) and one run under
    torch.profiler: walls, device kernel time and busy shares, the
    key-switch kernel's launches and share, the top kernels; with the
    engine `eng`, the traced run's bootstrap phase times."""
    work()                                               # warm-up
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    work()
    ev1.record()
    torch.cuda.synchronize()
    untraced = ev0.elapsed_time(ev1) / 1e3
    kernels.zero_launches()
    c0 = dict(eng.counters) if eng is not None else {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    phases = None
    if eng is not None:
        boots = eng.counters["bootstrap"] - c0["bootstrap"]
        # boot.<phase>_ns -> ms a bootstrap
        phases = {k[5:-3]: (eng.counters[k] - c0[k]) / max(boots, 1) / 1e6
                  for k in eng.counters if k.startswith("boot.")}

    by_name = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type is not None and \
                "cuda" in str(evt.device_type).lower() and \
                not _is_range(evt.key):
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
    device_s = sum(by_name.values()) / 1e6
    port_s = {k: sum(v for name, v in by_name.items()
                     if re.search(pat, name)) / 1e6
              for k, pat in PORT_KERNELS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(untraced_wall_s=untraced, traced_wall_s=wall,
                device_kernel_s=device_s,
                device_busy_share=device_s / wall if wall else None,
                device_busy_share_untraced=device_s / untraced,
                kernel_s=port_s, launches=launches,
                kernel_share_of_device={k: v / device_s if device_s else None
                                        for k, v in port_s.items()},
                scopes_s=scope_split(prof.events(), device_s),
                bootstrap_phase_ms=phases,
                top_kernels_s=[(k[:90], _body(k), v / 1e6) for k, v in top])


# the port's kernels by their demangled or mangled names: csrc/ntt.cu's
# ntt_cluster<forward?, ...>, ntt_cluster16, ntt_block and the two-pass
# ntt_cols/ntt_runs (also apart: the rings from 2^18), ks_inner.cu's,
# ks_legs.cu's and lut_sum.cu's kernels
PORT_KERNELS = {"ks_inner": "ks_inner_kernel",
                "ntt_fwd": "ntt_(cluster16|cluster|block|cols|runs)"
                           "(<true|ILb1)",
                "ntt_inv": "ntt_(cluster16|cluster|block|cols|runs)"
                           "(<false|ILb0)",
                "ntt_cluster16": "ntt_cluster16",
                "ntt_two_pass": "ntt_(cols|runs)",
                "ks_modup": "ks_modup_kernel",
                "ks_moddown": "ks_moddown_kernel",
                "sub_scale": "sub_scale_kernel",
                "lut_sum": "lut_sum_scalar",
                "lut_sum_dense": "lut_sum_dense"}


def _is_range(name: str) -> bool:
    """A named range (its span on the card's timeline is no kernel)."""
    return name.startswith("ckks.")


def scope_split(events, device_s: float) -> dict:
    """Device seconds by named range.  A kernel belongs to the ranges open
    on the host when its launch call ran (the CUDA runtime event with the
    kernel's correlation id), which holds for torch's kernels and for the
    port's own, launched through ctypes, alike: "self_s" counts it under
    the innermost range, "total_s" under every open range.  "(outside the
    ranges)" is the rest of device_s, launches outside every range and
    kernels whose launch the trace lacks."""
    marks, kernels = [], {}
    for e in events:
        if e.device_type == DeviceType.CPU and _is_range(e.name):
            marks.append((e.time_range.start, 0, e.name))
            marks.append((e.time_range.end, 2, e.name))
        elif e.device_type == DeviceType.CPU and "Launch" in e.name and \
                e.name.startswith("cu"):
            marks.append((e.time_range.start, 1, e.id))
        elif e.device_type == DeviceType.CUDA and not _is_range(e.name):
            kernels[e.id] = kernels.get(e.id, 0.0) + \
                e.time_range.end - e.time_range.start
    own, total, open_ranges = {}, {}, []
    for _, kind, what in sorted(marks, key=lambda m: (m[0], m[1])):
        if kind == 0:
            open_ranges.append(what)
        elif kind == 2:
            open_ranges.reverse()
            open_ranges.remove(what)
            open_ranges.reverse()
        elif open_ranges and what in kernels:
            us = kernels.pop(what)
            own[open_ranges[-1]] = own.get(open_ranges[-1], 0.0) + us
            for name in set(open_ranges):
                total[name] = total.get(name, 0.0) + us
    out = {name: dict(self_s=own.get(name, 0.0) / 1e6,
                      total_s=total[name] / 1e6)
           for name in sorted(total, key=lambda n: -own.get(n, 0.0))}
    out["(outside the ranges)"] = dict(
        self_s=device_s - sum(own.values()) / 1e6, total_s=None)
    return out


def _body(name: str) -> str:
    """What tells torch's templated elementwise kernels apart: the first
    functor or kernel body named inside the template arguments, past the
    launch wrappers (e.g. remainder_kernel_cuda, MulFunctor,
    CUDAFunctor_add, direct_copy_kernel_cuda)."""
    found = re.findall(r"[A-Za-z]\w*(?:Functor\w*|_kernel_cuda|_kernel_impl)",
                       name[name.find("<") + 1:])
    return next((f for f in found
                 if not f.startswith(("gpu_kernel", "BinaryFunctor"))), "")


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
    ap.add_argument("--bench", choices=("bitplane", "zeta"),
                    help="trace one step of bench's leg instead")
    ap.add_argument("--logn", type=int, default=18,
                    help="with --bench: its ring, 2^logn")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round: needs a CUDA card")
    # ops_impl installs its ranges itself; this also gives them to a copy
    # of the package from before they existed, profiled with this script
    # for a before/after comparison
    trace.install(ops_impl)
    if args.graph and not args.refresh:
        raise SystemExit("profile_round: --graph needs --refresh")

    work, desc = (_bench_work if args.bench else _zeta_work if args.zeta
                  else _refresh_work if args.refresh else _rounds_work)(args)
    wrap = desc.pop("wrap", None)
    eng = wrap.engine if wrap is not None else None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = dict(card=card, profile=args.profile, **desc)
    if args.graph:
        out["eager"] = _trace(work, eng)
        wrap.fused_boot = True
        out["graph"] = _trace(work, eng)
        out["graphs"] = [dict(capture_s=f.capture_s,
                              pool_gib=f.pool_bytes / 2 ** 30)
                         for f in wrap.fused_instances.values()]
    else:
        out.update(_trace(work, eng))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
