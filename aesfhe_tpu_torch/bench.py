"""Benchmark of the port: one JSON line.  Counterpart of the root
`bench.py` (which `python -m aesfhe_tpu bench` runs), with its environment
knobs, modes, defaults and field names, so one harness can drive either
package.

    python -m aesfhe_tpu_torch bench [--device cuda|cpu]

Environment:
  AESFHE_BENCH_MODE      "flagship" (default): the 10-round bit-sliced
                         AES-128 with its 36 bootstraps at prod_boot
                         (`python -m aesfhe_tpu_torch.run_full_aes` in a
                         child process), reported only when every block is
                         exact and block 0 equals FIPS-197 C.1;
                         "bitplane": one full middle bit-sliced round
                         (xor_plain, sub_bytes, shift_rows, mix_columns,
                         cleanse), no bootstrap;
                         "zeta": the ARK+SubBytes step of the zeta
                         nibble-pair pipeline (plain-nibble XOR, power
                         bases, the two bilinear S-box LUTs)
  AESFHE_BENCH_LOGN      ring exponent of bitplane/zeta (default 16)
  AESFHE_BENCH_LEVELS    their depth (default 16)
  AESFHE_BENCH_ITERS     their timed iterations (default 5)
  AESFHE_BENCH_SKIP_CPU  skip the CPU leg (vs_baseline = 0)
  AESFHE_BENCH_FLAGSHIP_TIMEOUT  seconds for the flagship child (5400)

bitplane and zeta run on CKKSParams(n=2^LOGN, max_level=LEVELS,
scale_bits=28, num_special_primes=4) with keys from seed 0, warm once, then
time ITERS iterations (the card synchronized before and after each) and
report blocks per median iteration with t_min/t_median/t_max.  Their output
is decrypted and held against the plain AES oracle; a wrong byte exits
non-zero.  vs_baseline is the device's blocks/s over the CPU's on the same
parameters, from a child process with --device cpu whose result is cached
in aesfhe_tpu_torch/build/.

Unlike the reference, a flagship that fails, times out or is not exact
does not fall back to the one-round metric: the tail of the child's output
goes to stderr and the command exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .aes_tables import AES_SBOX, mix_columns, shift_rows
from .kernels import BUILD_DIR

PACKAGE_DIR = Path(__file__).resolve().parent
FLAGSHIP_METRIC = "aes_fhe_10round_blocks_per_s"


@dataclass
class Leg:
    """One timed step: `step(*args)` returns its output, `decode(out)` the
    bytes it decrypts to, `want` the plain oracle's bytes."""
    step: Callable
    args: tuple
    blocks: int
    want: np.ndarray
    decode: Callable
    wrap: object


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_params(logn: int, levels: int):
    """The bitplane and zeta legs' profile (the root bench.py's)."""
    from .core.params import CKKSParams
    return CKKSParams(n=1 << logn, max_level=levels, scale_bits=28,
                      num_special_primes=4)


def _wrapper(logn: int, levels: int, device):
    """bench.py's profile and seed-0 keys (the power-of-two rotation
    ladder, as the reference's EngineContext generates by default)."""
    from .context import EngineContext
    from .ops.xor_service import EngineWrapper
    ctx = EngineContext(params=bench_params(logn, levels), device=device,
                        rng=np.random.default_rng(0))
    return EngineWrapper(ctx=ctx)


def setup_bitplane(logn: int, levels: int, device) -> Leg:
    """One full middle AES round on the bit-sliced pipeline, from a fresh
    encryption of random bytes (seed 0) under round key 1 of the key
    00..0f."""
    from .keyexp import expand_key_128
    from .ops.bitplane import BitSliceService
    wrap = _wrapper(logn, levels, device)
    svc = BitSliceService(wrap)
    sc = wrap.engine.params.slot_count
    state = np.random.default_rng(0).integers(0, 256, sc, dtype=np.uint8)
    rk = expand_key_128(bytes(range(16)))[1]
    st0 = svc.encrypt_state(state)

    def step(st):
        st = svc.xor_plain(st, rk)
        st = svc.sub_bytes(st)
        st = svc.shift_rows(st)
        st = svc.mix_columns(st)
        return svc.cleanse(st)

    s = AES_SBOX[state ^ np.tile(rk, sc // 16)]
    want = np.concatenate([mix_columns(shift_rows(s[b:b + 16]))
                           for b in range(0, sc, 16)])
    return Leg(step, (st0,), sc // 16, want, svc.decrypt_state, wrap)


def setup_zeta(logn: int, levels: int, device) -> Leg:
    """The zeta pipeline's ARK+SubBytes step on one nibble pair: XOR with
    the plain key nibbles, the power bases, the two bilinear S-box LUTs."""
    from .coeffs.generate import COEFF_DIR
    from .ops.mixcolumns_service import AESFHETransformer, NibblePair
    from .ops.xor_service import CoefficientCache, XORService
    from .ops.zeta import ZetaEncoder, split_nibbles
    wrap = _wrapper(logn, levels, device)
    xs = XORService(wrap)
    tf = AESFHETransformer(wrap, xs)
    hi2d = CoefficientCache(COEFF_DIR / "sbox_hi2d_coeffs.json").load_coeffs()
    lo2d = CoefficientCache(COEFF_DIR / "sbox_lo2d_coeffs.json").load_coeffs()
    sc = wrap.engine.params.slot_count
    rng = np.random.default_rng(0)
    state = rng.integers(0, 256, sc, dtype=np.uint8)
    key = np.tile(rng.integers(0, 256, 16, dtype=np.uint8), sc // 16)
    k_hi, k_lo = split_nibbles(key)
    s_hi, s_lo = split_nibbles(state)
    ct_hi = wrap.encrypt(ZetaEncoder.to_zeta(s_hi, 16))
    ct_lo = wrap.encrypt(ZetaEncoder.to_zeta(s_lo, 16))

    def step(hi, lo):
        hi = xs._xor_with_plain_nibbles(hi, k_hi)
        lo = xs._xor_with_plain_nibbles(lo, k_lo)
        bh = xs._build_power_basis(hi)
        bl = xs._build_power_basis(lo)
        return NibblePair(tf._bilinear(bh, bl, hi2d),
                          tf._bilinear(bh, bl, lo2d))

    def decode(out):
        h = ZetaEncoder.from_zeta(wrap.decrypt(out.hi), 16)
        lo = ZetaEncoder.from_zeta(wrap.decrypt(out.lo), 16)
        return (h.astype(np.uint8) << 4) | lo.astype(np.uint8)

    return Leg(step, (ct_hi, ct_lo), sc // 16, AES_SBOX[state ^ key], decode,
               wrap)


SETUPS = {"bitplane": setup_bitplane, "zeta": setup_zeta}


def run_leg(mode: str, logn: int, levels: int, iters: int, device,
            leg: Leg | None = None):
    """(blocks/s at the median iteration, per-iteration stats, the last
    output, the leg).  Warm once, then `iters` timed iterations, each
    between two synchronizes of the card."""
    leg = leg or SETUPS[mode](logn, levels, device)
    dev = leg.wrap.engine.device
    out = leg.step(*leg.args)
    _sync(dev)
    times = []
    for _ in range(max(1, iters)):
        _sync(dev)
        t0 = time.perf_counter()
        out = leg.step(*leg.args)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    stats = {"iters": len(times), "t_min_s": min(times),
             "t_median_s": med, "t_max_s": max(times)}
    return leg.blocks / med, stats, out, leg


def leg_record(mode: str, blocks: int, bps: float, stats: dict,
               vs: float) -> dict:
    """The reference's one-line record of a bitplane or zeta leg."""
    if mode == "zeta":
        metric = "aes_fhe_ark_subbytes_round_step_blocks_per_s"
        unit = f"AES blocks/s ({blocks}-block SIMD ARK+SubBytes step)"
    else:
        metric = "aes_fhe_full_round_blocks_per_s"
        unit = (f"AES blocks/s (full bit-sliced round, {blocks}-block SIMD "
                f"batch, median of iters; t_min/t_max published)")
    return {"metric": metric, "value": bps, "unit": unit, "vs_baseline": vs,
            **stats}


class FlagshipFailed(RuntimeError):
    """The flagship child failed, timed out or was not exact."""


def flagship_record(res: dict) -> dict:
    """The reference's flagship line from a run_full_aes result: blocks/s
    over the 10 rounds, the steady rate at the median of rounds 2-10
    (scripts/run_full_aes.py's formula), rates per second of the rounds'
    wall.  Raises FlagshipFailed unless the run is exact and FIPS-197
    exact."""
    if not res.get("exact") or res.get("fips_block0") is not True:
        raise FlagshipFailed(
            f"flagship not exact: {res.get('bad_bytes')} bytes differ from "
            f"the AES oracle, fips_block0={res.get('fips_block0')}")
    wall, rounds, blocks = res["wall_s"], res["rounds"], res["blocks"]
    rs = res["round_s"]
    steady = (blocks / (rounds * float(np.median(rs[1:])))
              if len(rs) > 1 else blocks / wall)
    logn = (blocks * 32).bit_length() - 1       # 16 slots per block
    return {
        "metric": FLAGSHIP_METRIC,
        "value": res["blocks_per_s"],
        "unit": (f"AES blocks/s (10 rounds incl. {res['bootstraps']} "
                 f"bootstraps, {blocks}-block SIMD batch, {res['profile']} "
                 f"N=2^{logn}; FIPS-197 C.1 exact; no warm-up round: eager "
                 f"torch compiles nothing, so warmup_s is 0.0)"),
        "vs_baseline": 0.0,
        "ms_per_round": 1000 * res["s_per_round"],
        "blocks_per_s_steady": steady,
        "warmup_s": 0.0,
        "rotations_per_s": res["counters"]["rotate"] / wall,
        "keyswitches_per_s": res["keyswitches"] / wall,
        "bootstrap_s_total": float(sum(res["bootstrap_s"])),
    }


def _tail(text: str | bytes | None, n: int = 8) -> list[str]:
    if isinstance(text, bytes):
        text = text.decode(errors="replace")
    return (text or "").strip().splitlines()[-n:]


def run_flagship(device) -> dict:
    """run_full_aes in a child process; its last stdout line parsed.
    Raises FlagshipFailed (with the child's output tails on stderr) when
    the child fails, times out, prints no result or is not exact."""
    budget = _env_int("AESFHE_BENCH_FLAGSHIP_TIMEOUT", 5400)
    cmd = [sys.executable, "-m", "aesfhe_tpu_torch.run_full_aes",
           "--device", str(device)]
    out = err = ""
    try:
        r = subprocess.run(cmd, cwd=PACKAGE_DIR.parent, capture_output=True,
                           text=True, timeout=budget)
        out, err = r.stdout, r.stderr
        if r.returncode != 0:
            raise FlagshipFailed(f"run_full_aes exited {r.returncode}")
        lines = out.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            res = None
        if not isinstance(res, dict):
            raise FlagshipFailed("run_full_aes printed no JSON result")
        return flagship_record(res)
    except (FlagshipFailed, subprocess.TimeoutExpired, KeyError,
            TypeError) as e:
        if isinstance(e, subprocess.TimeoutExpired):
            out, err = e.stdout, e.stderr
        print(f"bench: flagship failed ({type(e).__name__}: {e}); no "
              f"fallback", file=sys.stderr)
        for name, stream in (("stdout", out), ("stderr", err)):
            tail = _tail(stream)
            if tail:
                print(f"bench: flagship {name} tail:", file=sys.stderr)
                for line in tail:
                    print(f"  {line}", file=sys.stderr)
        raise FlagshipFailed(str(e)) from e


def cpu_leg(mode: str, logn: int, levels: int) -> float | None:
    """The CPU's blocks/s of the same leg (one iteration in a child
    process with --device cpu), cached per mode and profile; None if the
    child fails."""
    cache = BUILD_DIR / f"aesfhe_tpu_torch_cpu_leg_{mode}_{logn}_{levels}.json"
    if cache.exists():
        try:
            return float(json.loads(cache.read_text())["value"])
        except (ValueError, KeyError, OSError):
            pass
    env = dict(os.environ, AESFHE_BENCH_MODE=mode, AESFHE_BENCH_CHILD="1",
               AESFHE_BENCH_ITERS="1")
    try:
        r = subprocess.run([sys.executable, "-m", "aesfhe_tpu_torch", "bench",
                            "--device", "cpu"], cwd=PACKAGE_DIR.parent,
                           env=env, capture_output=True, text=True,
                           timeout=5400)
        value = float(json.loads(r.stdout.strip().splitlines()[-1])["value"])
    except (subprocess.TimeoutExpired, ValueError, KeyError, IndexError):
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cache.write_text(json.dumps({"value": value}))
    return value


def check_leg(leg: Leg, out) -> int:
    """Wrong bytes of a leg's output against the plain oracle."""
    return int(np.sum(leg.decode(out) != leg.want))


def bench(device="cuda") -> dict:
    """The benchmark's record in AESFHE_BENCH_MODE."""
    from .core.engine import resolve_device
    mode = os.environ.get("AESFHE_BENCH_MODE", "flagship")
    device = resolve_device(device)
    if mode == "flagship":
        return run_flagship(device)
    if mode not in SETUPS:
        raise ValueError(f"unknown AESFHE_BENCH_MODE {mode!r}")
    logn = _env_int("AESFHE_BENCH_LOGN", 16)
    levels = _env_int("AESFHE_BENCH_LEVELS", 16)
    iters = _env_int("AESFHE_BENCH_ITERS", 5)
    bps, stats, out, leg = run_leg(mode, logn, levels, iters, device)
    bad = check_leg(leg, out)
    if bad:
        raise SystemExit(f"bench {mode}: {bad} of {len(leg.want)} bytes "
                         f"differ from the AES oracle")
    if os.environ.get("AESFHE_BENCH_CHILD"):
        return {"metric": "cpu_leg", "value": bps, "unit": "",
                "vs_baseline": 0.0}
    vs = 0.0
    if not os.environ.get("AESFHE_BENCH_SKIP_CPU"):
        cpu_bps = cpu_leg(mode, logn, levels)
        vs = bps / cpu_bps if cpu_bps else 0.0
    return leg_record(mode, leg.blocks, bps, stats, vs)


def main(device="cuda") -> int:
    """Print the record as one JSON line; a failed flagship exits 1."""
    try:
        rec = bench(device)
    except FlagshipFailed:
        return 1
    print(json.dumps(rec), flush=True)
    return 0
