"""Side-by-side timing of the NTT kernels against variants of their source.

    python3 -m aesfhe_tpu_torch.ntt_variants [name ...]

Each variant is `csrc/ntt.cu` with a few textual edits (the designs tried
and dropped for the kernels as they stand): built with the package's nvcc
flags into `build/`, held torch.equal to the package's kernels, and timed
with CUDA events in turns (kernel, variant, variant, kernel) at the top
level's key-switch decomposition [7, 63, 2^16] (int32 in and out with the
Montgomery factors folded in, and int64 in and out) and a rescale's
[2, 55, 2^16] (int64).  Prints one line per case and variant with the
card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from . import kernels
from .core import ntt, ops_impl
from .core.params import get_params

# name -> (what it changes, [(old, new), ...] on csrc/ntt.cu)
VARIANTS = {
    "unroll1": ("one group at a time per thread", [
        ("#pragma unroll 2\n  for (int g = threadIdx.x;",
         "for (int g = threadIdx.x;")]),
    "unroll4": ("four groups at a time per thread", [
        ("#pragma unroll 2\n  for (int g = threadIdx.x;",
         "#pragma unroll 4\n  for (int g = threadIdx.x;")]),
    "word_check": ("the int64 canonical check per word, not per group", [
        ("  bool canonical = true;\n#pragma unroll\n"
         "  for (int j = 0; j < (1 << kR); ++j)\n"
         "    canonical &= static_cast<unsigned long long>(raw[j]) < q;\n"
         "  if (canonical) {",
         "  if (false) {")]),
    "compare_select": ("reductions by compare and select, not minimum", [
        ("  return min(s, s - q);", "  return s >= q ? s - q : s;"),
        ("  const uint32_t d = a - b;\n  return min(d, d + q);",
         "  return a >= b ? a - b : a + q - b;"),
        ("  return min(r, r - q);", "  return r >= q ? r - q : r;")]),
    "twiddle_pairs": ("w and its companion as one 8-byte load", [
        ("""struct GlobalTw {
  const uint32_t* __restrict__ w;
  const uint32_t* __restrict__ wsh;
  __device__ __forceinline__ void operator()(int ti, uint32_t& a,
                                             uint32_t& b) const {
    a = __ldg(w + ti);
    b = __ldg(wsh + ti);
  }
};

struct SmemTw {
  const uint32_t* w;
  const uint32_t* wsh;
  __device__ __forceinline__ void operator()(int ti, uint32_t& a,
                                             uint32_t& b) const {
    a = w[ti];
    b = wsh[ti];
  }
};""", """struct GlobalTw {
  const uint2* __restrict__ w;
  __device__ __forceinline__ void operator()(int ti, uint32_t& a,
                                             uint32_t& b) const {
    const uint2 t = __ldg(w + ti);
    a = t.x;
    b = t.y;
  }
};

struct SmemTw {
  const uint2* w;
  __device__ __forceinline__ void operator()(int ti, uint32_t& a,
                                             uint32_t& b) const {
    const uint2 t = w[ti];
    a = t.x;
    b = t.y;
  }
};"""),
        ("  uint32_t* const sw = smem + 2 * kWords;\n"
         "  uint32_t* const ssh = sw + (1 << kLs);",
         "  uint2* const sw = reinterpret_cast<uint2*>(smem + 2 * kWords);"),
        ("  const uint32_t* tw = w + (trow << kLogn);\n"
         "  const uint32_t* tsh = wsh + (trow << kLogn);",
         "  const uint2* tw = reinterpret_cast<const uint2*>(w) + "
         "(trow << kLogn);"),
        ("  for (int i = threadIdx.x; i < (1 << kLs); i += kThreads) {\n"
         "    sw[i] = __ldg(tw + i);\n    ssh[i] = __ldg(tsh + i);\n  }",
         "  for (int i = threadIdx.x; i < (1 << kLs); i += kThreads)\n"
         "    sw[i] = __ldg(tw + i);"),
        ("SmemTw{sw, ssh}", "SmemTw{sw}"),
        ("GlobalTw{tw, tsh}", "GlobalTw{tw}"),
        ("    return GlobalTw{w + t, wsh + t};",
         "    return GlobalTw{reinterpret_cast<const uint2*>(w) + t};"),
        # the two-pass kernels (N >= 2^18)
        ("  for (int i = threadIdx.x; i < (1 << la); i += kThreads) {\n"
         "    stw[i] = __ldg(w + toff + i);\n"
         "    stsh[i] = __ldg(wsh + toff + i);\n  }",
         "  for (int i = threadIdx.x; i < (1 << la); i += kThreads)\n"
         "    reinterpret_cast<uint2*>(stw)[i] =\n"
         "        __ldg(reinterpret_cast<const uint2*>(w) + toff + i);"),
        ("SmemTw{stw, stsh}", "SmemTw{reinterpret_cast<const uint2*>(stw)}"),
        ("GlobalTw{w + toff, wsh + toff}",
         "GlobalTw{reinterpret_cast<const uint2*>(w) + toff}")]),
}
PAIRED = {"twiddle_pairs"}      # takes (w, w_sh) interleaved in one table


def variant_source(name: str) -> str:
    src = kernels.SOURCES["ntt"].read_text()
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: edit not found once: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names) -> dict:
    """Compile the named variants in parallel; {name: ctypes library}."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in names:
        cu = kernels.BUILD_DIR / f"ntt_variant_{n}.cu"
        cu.write_text(variant_source(n))
        so = kernels.BUILD_DIR / f"libntt_variant_{n}.so"
        procs[n] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for n, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {n}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in (lib.ntt_fwd_launch, lib.ntt_inv_launch):
            fn.argtypes = ntt._library().ntt_fwd_launch.argtypes
            fn.restype = ctypes.c_int
        if lib.ntt_setup() != 0:
            raise RuntimeError(f"variant {n}: ntt_setup failed")
        libs[n] = lib
    return libs


_PAIRS: dict = {}


def launch(lib, paired: bool, fwd: bool, x, t, mont, out_dtype):
    """One launch of a variant's kernel, as core/ntt.py's _launch does; a
    paired variant's interleaved table is made once per table set."""
    L, n = x.shape[-2], x.shape[-1]
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    w, wsh = ((t.tabs.k_w, t.tabs.k_wsh) if fwd
              else (t.tabs.k_wi, t.tabs.k_wish))
    if paired:
        key = (id(t.tabs), fwd)
        if key not in _PAIRS:
            _PAIRS[key] = torch.stack([w, wsh], -1)
        w = _PAIRS[key]
    scratch = (torch.empty(x.shape, dtype=torch.int32, device=x.device)
               if n.bit_length() - 1 >= ntt.TWO_PASS_MIN_LOGN else None)
    fn = lib.ntt_fwd_launch if fwd else lib.ntt_inv_launch
    err = fn(x.data_ptr(), x.stride(0), x.stride(1), x.element_size(),
             y.data_ptr(), y.element_size(),
             None if scratch is None else scratch.data_ptr(), w.data_ptr(),
             wsh.data_ptr(),
             t.tabs.k_rowc.data_ptr(), t.rows_dev.data_ptr(), x.shape[0], L,
             n.bit_length() - 1, int(mont), 1,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return y


def cuda_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("ntt_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    libs = build(names)
    p = get_params("prod_boot")
    tabs = ops_impl.DeviceTables(p, "cuda")
    qa = np.asarray(p.all_primes, dtype=np.int64)
    rng = np.random.default_rng(0)
    top = ops_impl._rows(p, p.top_level, True)
    ttop, t55 = tabs.ntt.rows(top), tabs.ntt.rows(range(p.num_q))
    x7 = torch.as_tensor(rng.integers(0, 1 << 62, (7, len(top), p.n))
                         % qa[top].reshape(-1, 1), device="cuda")
    x55 = torch.as_tensor(rng.integers(0, 1 << 62, (2, p.num_q, p.n))
                          % qa[:p.num_q].reshape(-1, 1), device="cuda")
    i32, i64 = torch.int32, torch.int64
    cases = [("fwd [7, 63] int32 mont", True, x7.int(), ttop, True, i32),
             ("inv [7, 63] int32 mont", False, x7.int(), ttop, True, i32),
             ("fwd [7, 63] int64", True, x7, ttop, False, i64),
             ("inv [7, 63] int64", False, x7, ttop, False, i64),
             ("fwd [2, 55] int64 mont", True, x55, t55, True, i64)]
    for label, fwd, x, t, mont, od in cases:
        base = (lambda: ntt.ntt_fwd(x, t, mont, od)) if fwd else (
            lambda: ntt.ntt_inv(x, t, mont, od))
        want = base()
        for n, lib in libs.items():
            def var(lib=lib, n=n):
                return launch(lib, n in PAIRED, fwd, x, t, mont, od)
            if not torch.equal(var(), want):
                raise AssertionError(f"variant {n} disagrees at {label}")
            b0, v0, v1, b1 = (cuda_ms(f) for f in (base, var, var, base))
            print(f"{label}: kernel {min(b0, b1):.4f} ms, {n} "
                  f"{min(v0, v1):.4f} ms ({VARIANTS[n][0]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
