"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, named by the hash of its source so a
stale build is never loaded, under `build/` beside this file (listed in
.gitignore).  `build()` starts one `nvcc` per source, all at once, and
waits for them; `load()` builds on first use.  A failed build raises.
Nothing here runs at import: the CPU tests import every module.

Each wrapper counts its kernel's launches in a module-level integer;
`COUNTERS` names them, and `launch_counts`/`zero_launches`/`add_launches`
read, zero and add to all of them at once (`VARIANTS`, `variant_counts`:
the chunked conversions' share of ks_modup's and ks_moddown's, the 2^18
NTT's and the two-pass NTT's of ntt_fwd's and ntt_inv's).
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "build"
SOURCES = {"ks_inner": _PKG / "csrc" / "ks_inner.cu",
           "ntt": _PKG / "csrc" / "ntt.cu",
           "ks_legs": _PKG / "csrc" / "ks_legs.cu",
           "lut_sum": _PKG / "csrc" / "lut_sum.cu"}
# kernel name -> (wrapper module under core/, its launch counter)
COUNTERS = {"ks_inner": ("ks_inner", "launches"),
            "ntt_fwd": ("ntt", "launches_fwd"),
            "ntt_inv": ("ntt", "launches_inv"),
            "ks_modup": ("ks_legs", "launches_modup"),
            "ks_moddown": ("ks_legs", "launches_moddown"),
            "sub_scale": ("ks_legs", "launches_sub_scale"),
            "lut_sum": ("lut_sum", "launches_scalar"),
            "lut_sum_dense": ("lut_sum", "launches_dense")}
# of those launches, the instances that only some parameter sets reach (the
# chunked conversions: a digit or special set of more than 8 primes; the
# NTT on a cluster of 16: rings of 2^18, one launch a transform; the
# two-pass NTT: rings of 2^19 and up, two launches a transform); zeroed with
# the counters above, read by `variant_counts`
VARIANTS = {"ks_modup_chunks": ("ks_legs", "launches_modup_chunks"),
            "ks_moddown_chunks": ("ks_legs", "launches_moddown_chunks"),
            "ntt_cluster16": ("ntt", "launches_cluster16"),
            "ntt_two_pass": ("ntt", "launches_two_pass")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# ntt.cu's 64 kernels: nvcc optimizes its partitions in parallel (~30 s on
# the card's host, ~85 s in one thread; the same ptxas registers)
SPLIT = {"ntt": ["--split-compile=0"]}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else None


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, in
    parallel.  Returns {name: seconds}; raises with the compiler's output
    if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *SPLIT.get(n, ()), "-o", str(tmp),
               str(SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, library_path(n))
        (BUILD_DIR / f"{n}.ptxas.log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def _counter(name: str):
    mod, attr = COUNTERS[name] if name in COUNTERS else VARIANTS[name]
    return importlib.import_module(f"{__package__}.core.{mod}"), attr


def launch_counts() -> dict[str, int]:
    """Every kernel's launches so far, by kernel name."""
    return {n: getattr(*_counter(n)) for n in COUNTERS}


def variant_counts() -> dict[str, int]:
    """The launches of each instance in VARIANTS so far."""
    return {n: getattr(*_counter(n)) for n in VARIANTS}


def zero_launches() -> None:
    for n in (*COUNTERS, *VARIANTS):
        setattr(*_counter(n), 0)


def add_launches(counts: dict) -> None:
    """Add counts {kernel name: launches} (e.g. a graph replay's)."""
    for n, v in counts.items():
        mod, attr = _counter(n)
        setattr(mod, attr, getattr(mod, attr) + v)
