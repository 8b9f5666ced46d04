"""Run one cell of `BENCHMARK.json` on the card and print its result.

    python3 -m fhebench.run --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

From the root of a checkout.  A run generates the CKKS keys from the seed
through the program's own key generation, draws and encrypts the mix's
batches, warms up with one request on a batch of its own, then serves
requests (whole ciphers) back to back for `--seconds` (the window closes when the last
request started before then completes), and checks every answer of the
window against the plain AES of `reference/` once the window has closed
and the program's state is freed.  It prints the compared numbers with
their limits as the last lines of standard error, and one JSON line as the
last line of standard output: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones,
each from its reader under `metrics/`), `device`, with `--trace 1`
`breakdown`, and `checks` last.

Exits non-zero and prints no result without enough CUDA cards, when the
program's parameter set is not the configuration's, or when `jax`, `flax`
or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the caches torch may fill (NVRTC-built kernels, Triton), at fixed paths
# inside the checkout; the program builds its own kernels into its package
_CACHE = ROOT / "fhebench" / ".cache"
os.environ["TORCH_KERNEL_CACHE_PATH"] = str(_CACHE / "torch_kernels")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import cell as cell_mod  # noqa: E402
from . import tracing, traffic  # noqa: E402
from .reference import check  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "aesfhe_tpu")
# finished answers checked at most (a sample drawn from the seed beyond)
MAX_ANSWERS = 64
# the configuration's sizes, by the program's parameter attribute names
SIZES = {"n": "n", "max_level": "max_level", "scale_bits": "scale_bits",
         "num_special_primes": "num_special", "alpha": "alpha",
         "dnum": "dnum", "secret_hamming": "secret_hamming",
         "error_std": "error_std"}


@dataclass
class Run:
    """What a metric reader reads of one run."""
    cell: str
    config: dict
    mix: dict
    seconds: float                  # the window, host clock
    setup_s: float
    requests: int
    rounds: int                     # AES rounds completed in the window
    block_rounds: int
    peak_bytes: int
    counters: dict                  # engine counters over the window
    launches: dict                  # kernels.launch_counts() over the window
    device_name: str
    refresh_s: list = field(default_factory=list)   # traced runs
    tally: dict = field(default_factory=dict)       # traced runs
    trace: tracing.Trace | None = None
    notes: list = field(default_factory=list)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def check_sizes(config: dict, params) -> None:
    """The program's parameter set has the configuration's sizes."""
    off = {k: (v, getattr(params, SIZES[k]))
           for k, v in config["params"].items()
           if getattr(params, SIZES[k]) != v}
    if off:
        raise SystemExit(f"fhebench: the program's {config['profile']} is "
                         f"not the configuration (configured, program): "
                         f"{off}")
    blocks = params.slot_count // 16
    if config["blocks_per_batch"] != blocks:
        raise SystemExit(f"fhebench: a batch holds {blocks} blocks, the "
                         f"configuration says {config['blocks_per_batch']}")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _timer(sink: list, system):
    def timed(fn):
        def wrapped(*args, **kwargs):
            system.sync()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            system.sync()
            sink.append(time.perf_counter() - t)
            return out
        return wrapped
    return timed


def _launch_counts() -> dict:
    from aesfhe_tpu_torch import kernels
    return kernels.launch_counts()


def run_cell(cell: cell_mod.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             log=sys.stderr) -> dict:
    """One run of `cell`; returns the result line's object."""
    t0 = T0 if t0 is None else t0
    cfg, mix = cell.config, cell.mix
    on_card = device == "cuda"
    tallies = None
    if trace:
        specs = [t for _, r in cell.per_layer for t in getattr(r, "TALLIES",
                                                               ())]
        owner = getattr(cell.pipeline, "GRAPH_OWNER", None)
        if owner is not None:
            owner = getattr(__import__(owner[0], fromlist=[owner[1]]),
                            owner[1])
        tallies = tracing.install(specs, owner)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_sys = time.perf_counter()
    system = cell.pipeline.System(cfg, mix, np.random.default_rng(
        [seed % 2 ** 63, 0]), device)
    check_sizes(cfg, system.params)
    system.sync()
    t_enc = time.perf_counter()
    key = bytes.fromhex(cfg["aes_key"])
    blocks = cfg["blocks_per_batch"]
    pts = {b: traffic.plaintexts(seed, b, blocks, cfg["fips_block0"])
           for b in range(-1, mix["batches"])}
    inputs = {b: system.encrypt(traffic.program_input(mix, pts[b], key))
              for b in pts}
    system.sync()
    t_warm = time.perf_counter()
    system.run(inputs.pop(-1))
    system.sync()
    setup_s = time.perf_counter() - t0
    print(f"setup {setup_s:.2f} s: imports {t_sys - t0:.2f} s, program and "
          f"keys {t_enc - t_sys:.2f} s, {len(pts)} batches encrypted "
          f"{t_warm - t_enc:.2f} s, warm-up {t0 + setup_s - t_warm:.2f} s",
          file=log, flush=True)

    refresh_s: list = []
    prof = tracing.Profiler(on_card) if trace else None
    if trace:
        system.time_refresh(_timer(refresh_s, system))
        tallies.reset()
    c0, l0 = system.counters(), _launch_counts()
    answers, n_req = [], 0
    pick = np.random.default_rng([seed % 2 ** 63, 1])
    if prof is not None:
        prof.start()
    span = (torch.autograd.profiler.record_function if trace
            else lambda name: contextlib.nullcontext())
    plan = traffic.requests(mix)
    with span(tracing.WINDOW):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            batch = next(plan)
            with span("fhebench.request"):
                out = system.run(inputs[batch])
                system.sync()
            # a sample of the answers drawn from the seed (reservoir),
            # every one while they are few
            if n_req < MAX_ANSWERS:
                answers.append((batch, out))
            else:
                j = int(pick.integers(n_req + 1))
                if j < MAX_ANSWERS:
                    answers[j] = (batch, out)
            n_req += 1
        t_end = time.perf_counter()
    out = None
    window = t_end - t_start
    rounds = n_req * mix["rounds_per_cipher"]
    c1, l1 = system.counters(), _launch_counts()
    counters = {k: c1[k] - c0.get(k, 0) for k in c1}
    launches = {k: l1[k] - l0.get(k, 0) for k in l1}
    print(f"window {window:.3f} s: {n_req} requests, {rounds} rounds, "
          f"{len(answers)} answers checked; engine "
          f"counters {counters}; launches {launches}", file=log, flush=True)
    tally = ({k: tuple(v) for k, v in tallies.totals.items()} if tallies
             else {})
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    events = None
    t_stop = time.perf_counter()
    if prof is not None:
        prof.stop()
        events = prof.events
    t_stop = time.perf_counter() - t_stop
    found = forbidden_modules()
    if found:
        raise SystemExit(f"fhebench: loaded once the window closed: {found}")

    got = []
    for batch, out in answers:
        try:
            got.append(check.Answer(batch, system.decrypt(out)))
        except Exception as e:        # an answer that cannot be read
            print(f"answer of batch {batch} does not decrypt: {e!r}",
                  file=log)
            got.append(check.Answer(batch, None))
    device_name = (torch.cuda.get_device_name(0) if on_card else "cpu")
    # the cards the run allocated memory on
    cards = (sum(torch.cuda.max_memory_allocated(d) > 0
                 for d in range(torch.cuda.device_count())) if on_card else 0)
    run = Run(cell.name, cfg, mix, window, setup_s, n_req, rounds,
              rounds * blocks, peak, counters, launches, device_name,
              refresh_s, tally)
    del system, inputs, answers
    if on_card:
        torch.cuda.empty_cache()
    if events is not None:
        t_read = time.perf_counter()
        run.trace = tracing.read_trace(events)
        print(f"trace: {len(events)} events, {len(run.trace.ops)} device "
              f"operations in the window; profiler stopped in {t_stop:.1f} "
              f"s, events read in {time.perf_counter() - t_read:.1f} s",
              file=log, flush=True)
        del events

    verdict = check.judge(got, pts, key, mix["direction"],
                          mix["rounds_per_cipher"])
    readers = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m, reader in readers:
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    for note in run.notes:
        print(f"note: {note}", file=log)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": device_name,
           "count": cards, "memory_peak_bytes": peak}
    result = {"correct": check.passes(verdict), "attempted": n_req,
              "failed": verdict["failed"], "metrics": metrics,
              "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": verdict[k], "limit": v}
                        for k, v in check.LIMITS.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cell_mod.load(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"fhebench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
