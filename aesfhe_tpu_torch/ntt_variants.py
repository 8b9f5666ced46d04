"""Side-by-side timing of the NTT kernels against variants of their source
and against an earlier source.

    python3 -m aesfhe_tpu_torch.ntt_variants [--large] [--old PATH
        [--passes]] [--clusters] [name ...]

Each variant is `csrc/ntt.cu` with a few textual edits (the designs tried
and dropped for the kernels as they stand; a diagnostic's edit breaks the
result on purpose and is timed, not compared); `--old PATH` adds an earlier
`csrc/ntt.cu` with the same C interface (e.g. `git show
<rev>:aesfhe_tpu_torch/csrc/ntt.cu` into `local/`).  Every build goes into
`build/` with the package's nvcc flags; its ptxas lines and, from
`cuobjdump -sass`, each NTT kernel's innermost loops that store (SASS
instructions, words stored to shared or global memory) are printed.  Each
build is held torch.equal to the package's kernels and timed as CUDA-graph
replays (`legs_variants.graph_ms`) in turns (kernel, other, other, kernel)
at the top level's key-switch decomposition [7, 63, 2^16] (int32 in and
out with the Montgomery factors folded in, and int64 in and out) and a
rescale's [2, 55, 2^16] (int64); with `--large` at the rings from 2^17 up:
bench LOGN=17's [10, 21, 2^17] (the 8-block cluster), bench LOGN=18's
decomposition [5, 21, 2^18] (int32 folded, int64), its rescale's
[2, 17, 2^18] (int64), one row outside [0, q) [2, 1, 2^18], a strided
[2, 2] view, and one row each of 2^19, 2^20 and 2^25.  `--passes` (with
`--old`, an earlier source whose two-pass launcher `launch_two_pass` runs
both launches at run-time splits, from 2^18) also builds
PATH twice with one of that launcher's two launches cut out and times each
launch alone at [5, 21, 2^18].  `--clusters` prints how many clusters of 8
and 16 blocks of a stub kernel the card holds at once
(cudaOccupancyMaxActiveClusters) at the cluster kernels' shared memory.
Prints the card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import bench, kernels
from .core import ntt, ops_impl, rns
from .core.params import get_params
from .legs_variants import graph_ms, sass_loops

# the 16-block kernel's threads, layouts and blocks an SM
_C16 = """constexpr int kC16Threads = 256;        // its threads a block,
constexpr int kC16Layouts = 1;          // layouts a block (1: one buffer),
constexpr int kC16BlocksPerSm = 3;      // and the blocks an SM it aims at"""


def _c16(threads: int, layouts: int, per_sm: int) -> str:
    return (_C16.replace("kC16Threads = 256", f"kC16Threads = {threads}")
            .replace("kC16Layouts = 1", f"kC16Layouts = {layouts}")
            .replace("kC16BlocksPerSm = 3", f"kC16BlocksPerSm = {per_sm}"))


# the int64 inputs' canonical test (residues, residues_r) up to the path
# that reduces each word
_KEEP = """#pragma unroll
    for (int j = 0; j < (1 << kR); ++j) v[j] = static_cast<uint32_t>(raw[j]);
  } else {
#pragma unroll
"""
_CHECK = """  bool canonical = true;
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j)
    canonical &= static_cast<unsigned long long>(raw[j]) < q;
  if (canonical) {
""" + _KEEP

# name -> (what it changes, [(old, new), ...] on csrc/ntt.cu)
VARIANTS = {
    "unroll1": ("one group at a time per thread (but the 2^18 kernel)", [
        ("int kNt = kThreads, int kU = 2,", "int kNt = kThreads, int kU = 1,"),
        ("kThreads, false, 2>(", "kThreads, false, 1>(")]),
    "unroll4": ("four groups at a time per thread (but the 2^18 kernel)", [
        ("int kNt = kThreads, int kU = 2,", "int kNt = kThreads, int kU = 4,"),
        ("kThreads, false, 2>(", "kThreads, false, 4>(")]),
    "word_check": ("the int64 canonical check per word, not per group", [
        (_CHECK + "    for (int j = 0; j < (1 << kR); ++j) v[j] = "
         "load_residue(raw[j], q);",
         "  if (false) {\n" + _KEEP + "    for (int j = 0; j < (1 << kR); "
         "++j) v[j] = load_residue(raw[j], q);"),
        (_CHECK + "    for (int j = 0; j < (1 << kR); ++j)\n"
         "      v[j] = load_residue_r(",
         "  if (false) {\n" + _KEEP + "    for (int j = 0; j < (1 << kR); "
         "++j)\n      v[j] = load_residue_r(")]),
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
        ("  uint32_t* const sw = smem + (kOne ? 1 : 2) * kWords;\n"
         "  uint32_t* const ssh = sw + (1 << kLs);",
         "  uint2* const sw = reinterpret_cast<uint2*>(smem + (kOne ? 1 : 2) "
         "* kWords);"),
        ("  const uint32_t* tw = w + (trow << kLogn);\n"
         "  const uint32_t* tsh = wsh + (trow << kLogn);",
         "  const uint2* tw = reinterpret_cast<const uint2*>(w) + "
         "(trow << kLogn);"),
        ("  for (int i = threadIdx.x; i < (1 << kLs); i += kNt) {\n"
         "    sw[i] = __ldg(tw + i);\n    ssh[i] = __ldg(tsh + i);\n  }",
         "  for (int i = threadIdx.x; i < (1 << kLs); i += kNt)\n"
         "    sw[i] = __ldg(tw + i);"),
        ("SmemTw{sw, ssh}", "SmemTw{sw}"),
        ("GlobalTw{tw, tsh}", "GlobalTw{tw}"),
        ("    return GlobalTw{w + t, wsh + t};",
         "    return GlobalTw{reinterpret_cast<const uint2*>(w) + t};"),
        # the two-pass kernels (N >= 2^18)
        ("  for (int i = threadIdx.x; i < (1 << kLa); i += kThreads) {\n"
         "    stw[i] = __ldg(w + toff + i);\n"
         "    stsh[i] = __ldg(wsh + toff + i);\n  }",
         "  for (int i = threadIdx.x; i < (1 << kLa); i += kThreads)\n"
         "    reinterpret_cast<uint2*>(stw)[i] =\n"
         "        __ldg(reinterpret_cast<const uint2*>(w) + toff + i);"),
        ("SmemTw{stw, stsh}", "SmemTw{reinterpret_cast<const uint2*>(stw)}"),
        ("GlobalTw{w + toff, wsh + toff}",
         "GlobalTw{reinterpret_cast<const uint2*>(w) + toff}"),
        # the 16-block cluster's staged exchange twiddles
        ("  uint32_t* const xw = ssh + (1 << kLs);",
         "  uint32_t* const xw =\n"
         "      reinterpret_cast<uint32_t*>(sw + (1 << kLs));"),
        ("      xw[e] = __ldg(tw + ti);\n"
         "      xw[kExTw + e] = __ldg(tsh + ti);",
         "      const uint2 t = __ldg(tw + ti);\n      xw[e] = t.x;\n"
         "      xw[kExTw + e] = t.y;")]),
    "c16_two_blocks": ("the 2^18 kernel at two blocks an SM (up to 128 "
                       "registers a thread), not three", [
        (_C16, _c16(256, 1, 2))]),
    "c16_512_one": ("the 2^18 kernel with 512 threads a block, one buffer, "
                    "two blocks an SM", [(_C16, _c16(512, 1, 2))]),
    "c16_512_two": ("the 2^18 kernel with 512 threads a block, two layouts "
                    "(one block an SM)", [(_C16, _c16(512, 2, 1))]),
    "c16_1024_two": ("the 2^18 kernel with 1024 threads a block, two "
                     "layouts (one block an SM)", [(_C16, _c16(1024, 2, 1))]),
    "c16_unroll4": ("the 2^18 kernel with four groups at a time a thread", [
        ("constexpr int kC16Unroll = 2;", "constexpr int kC16Unroll = 4;")]),
}
PAIRED = {"twiddle_pairs"}      # takes (w, w_sh) interleaved in one table
# diagnostics: edits that break the result on purpose to time what a part
# costs (timed, not compared): the cluster kernels' run half reading its
# twiddles from the staged first-half table (index mod 2^kLs) instead of
# through L2
DIAGNOSTICS = {"diag_smem_tw": (
    "the cluster kernels' run twiddles from shared memory (wrong result)", [
        ("  const RowCtx<GlobalTw> runc{q, GlobalTw{tw, tsh}, colc.f_};",
         "  struct MaskTw {\n    const uint32_t* w;\n"
         "    const uint32_t* wsh;\n"
         "    __device__ __forceinline__ void operator()(int ti, uint32_t& a,"
         "\n        uint32_t& b) const {\n"
         "      a = w[ti & ((1 << kLs) - 1)];\n"
         "      b = wsh[ti & ((1 << kLs) - 1)];\n    }\n  };\n"
         "  const RowCtx<MaskTw> runc{q, MaskTw{sw, ssh}, colc.f_};")])}
# the earlier two-pass launcher (launch_two_pass): the edits that cut out one
# of its two launches, so the other is timed alone (the output is not
# compared)
_RUNS_FWD = """    ntt_runs<true, int32_t, Tout><<<gr, kThreads, rb, st>>>(
        mid, rs * L, rs, y, w, wsh, rowc, rows, B, L, la, lb, 1);"""
_COLS_INV = """    ntt_cols<false, int32_t, Tout><<<gc, kThreads, cb, st>>>(
        mid, rs * L, rs, y, w, wsh, rowc, rows, B, L, la, lb, mont);"""
_COLS_FWD = """    ntt_cols<true, Tin, int32_t><<<gc, kThreads, cb, st>>>(
        x, x_bs, x_rs, mid, w, wsh, rowc, rows, B, L, la, lb, mont);"""
_RUNS_INV = """    ntt_runs<false, Tin, int32_t><<<gr, kThreads, rb, st>>>(
        x, x_bs, x_rs, mid, w, wsh, rowc, rows, B, L, la, lb, vec);"""
PASS_EDITS = {"old_cols_only": [(_RUNS_FWD, ""), (_COLS_INV, "")],
              "old_runs_only": [(_COLS_FWD, ""), (_RUNS_INV, "")]}
NTT_KINDS = ("ntt_cluster", "ntt_cols", "ntt_runs", "ntt_block")
CLUSTER_STUB = r"""
#include <cuda_runtime.h>
__global__ void stub(int* p) {
  extern __shared__ int s[];
  if (p != nullptr) p[threadIdx.x] = s[threadIdx.x];
}
// out: clusters of `size` blocks resident at once, blocks per SM
extern "C" int cluster_occupancy(int size, int threads, int smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      stub, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        stub, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size * 1024);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(&out[0], stub, &cfg);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], stub, threads,
                                                      smem);
  return static_cast<int>(e);
}
"""
# (cluster size, threads a block, dynamic shared memory bytes): the
# 8-block kernel at 2^16 and 2^17, and a 16-block one at 2^18 holding two
# layouts (as 2^17's) or one, with 256 or 512 threads
CLUSTER_SHAPES = [(8, 256, 69632), (8, 256, 139264), (16, 256, 139264),
                  (16, 512, 139264), (16, 256, 71680), (16, 512, 71680)]


def variant_source(name: str, src: str | None = None) -> str:
    """This tree's csrc/ntt.cu (or `src`) with variant `name`'s edits
    (VARIANTS, or PASS_EDITS for an earlier source)."""
    src = kernels.SOURCES["ntt"].read_text() if src is None else src
    edits = (PASS_EDITS[name] if name in PASS_EDITS else
             DIAGNOSTICS[name][1] if name in DIAGNOSTICS else
             VARIANTS[name][1])
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: edit not found once: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict) -> dict:
    """Compile {name: CUDA source text} in parallel into build/; returns
    {name: (ctypes library, its path, nvcc's output)}."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, text in sources.items():
        cu = kernels.BUILD_DIR / f"ntt_variant_{n}.cu"
        cu.write_text(text)
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
        if n != "stub":
            for fn in (lib.ntt_fwd_launch, lib.ntt_inv_launch):
                fn.argtypes = ntt._library().ntt_fwd_launch.argtypes
                fn.restype = ctypes.c_int
            if lib.ntt_setup() != 0:
                raise RuntimeError(f"variant {n}: ntt_setup failed")
        libs[n] = (lib, so, log)
    return libs


def print_build(name: str, so: Path, log: str):
    """Each NTT kernel's ptxas line and the SASS of its innermost loops
    that store."""
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and entry is not None:
            kind = next((k for k in NTT_KINDS if k in entry), None)
            if kind:
                print(f"ptxas {name} {entry}: "
                      f"{line.split(':', 1)[1].strip()}", flush=True)
    loops = sass_loops(so, NTT_KINDS, ("STS", "STG", "ST."), by_symbol=True)
    for sym, rows in sorted(loops.items()):
        for ins, words, _ in rows:
            print(f"sass {name} {sym}: innermost loop {ins} instructions, "
                  f"{words} words stored, {ins / words:.1f} instructions a "
                  f"word", flush=True)


def cluster_occupancy(lib) -> None:
    lib.cluster_occupancy.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    for size, threads, smem in CLUSTER_SHAPES:
        out = (ctypes.c_int * 2)()
        err = lib.cluster_occupancy(size, threads, smem, out)
        print(f"clusters of {size} blocks x {threads} threads, {smem} bytes "
              f"of shared memory a block: "
              + (f"{out[0]} resident at once ({out[0] * size} blocks), "
                 f"{out[1]} blocks an SM" if err == 0
                 else f"CUDA error {err}"), flush=True)


_PAIRS: dict = {}


def launch(lib, paired: bool, fwd: bool, x, t, mont, out_dtype):
    """One transform through a build's kernels, as core/ntt.py's _launch
    does (an int32 scratch from 2^18 up, which an earlier two-pass source
    needs); a paired variant's interleaved table is made once per table
    set."""
    L, n = x.shape[-2], x.shape[-1]
    xb = x.reshape(-1, L, n)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    w, wsh = ((t.tabs.k_w, t.tabs.k_wsh) if fwd
              else (t.tabs.k_wi, t.tabs.k_wish))
    if paired:
        key = (id(t.tabs), fwd)
        if key not in _PAIRS:
            _PAIRS[key] = torch.stack([w, wsh], -1)
        w = _PAIRS[key]
    scratch = (torch.empty(x.shape, dtype=torch.int32, device=x.device)
               if n >= 1 << 18 else None)
    vec = (xb.data_ptr() % 16 == 0 and xb.stride(0) % 4 == 0
           and xb.stride(1) % 4 == 0)
    fn = lib.ntt_fwd_launch if fwd else lib.ntt_inv_launch
    err = fn(xb.data_ptr(), xb.stride(0), xb.stride(1), xb.element_size(),
             y.data_ptr(), y.element_size(),
             None if scratch is None else scratch.data_ptr(), w.data_ptr(),
             wsh.data_ptr(), t.tabs.k_rowc.data_ptr(), t.rows_dev.data_ptr(),
             xb.shape[0], L, n.bit_length() - 1, int(mont), int(vec),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return y


def cases_16(rng) -> list:
    """(label, forward, x, rows, mont, out dtype) at N = 2^16."""
    p = get_params("prod_boot")
    tabs = ops_impl.DeviceTables(p, "cuda")
    qa = np.asarray(p.all_primes, dtype=np.int64)
    top = ops_impl._rows(p, p.top_level, True)
    ttop, t55 = tabs.ntt.rows(top), tabs.ntt.rows(range(p.num_q))
    x7 = torch.as_tensor(rng.integers(0, 1 << 62, (7, len(top), p.n))
                         % qa[top].reshape(-1, 1), device="cuda")
    x55 = torch.as_tensor(rng.integers(0, 1 << 62, (2, p.num_q, p.n))
                          % qa[:p.num_q].reshape(-1, 1), device="cuda")
    i32, i64 = torch.int32, torch.int64
    return [("fwd [7, 63] int32 mont", True, x7.int(), ttop, True, i32),
            ("inv [7, 63] int32 mont", False, x7.int(), ttop, True, i32),
            ("fwd [7, 63] int64", True, x7, ttop, False, i64),
            ("inv [7, 63] int64", False, x7, ttop, False, i64),
            ("fwd [2, 55] int64 mont", True, x55, t55, True, i64)]


def cases_large(rng) -> list:
    """The same at the rings from 2^17 up (the module docstring's list)."""
    i32, i64 = torch.int32, torch.int64
    out = []

    def res(p, rows, lead):
        qa = np.asarray(p.all_primes, dtype=np.int64)[rows].reshape(-1, 1)
        return torch.as_tensor(rng.integers(0, 1 << 62, lead + (len(rows),
                                                                p.n)) % qa,
                               device="cuda")

    p17 = bench.bench_params(17, 16)
    t17 = ops_impl.DeviceTables(p17, "cuda")
    rows = ops_impl._rows(p17, p17.top_level, True)
    x = res(p17, rows, (10,)).int()
    for fwd in (True, False):
        out.append((f"{'fwd' if fwd else 'inv'} [10, 21, 2^17] int32 mont",
                    fwd, x, t17.ntt.rows(rows), True, i32))
    del t17
    p = bench.bench_params(18, 16)
    tabs = ops_impl.DeviceTables(p, "cuda")
    rows = ops_impl._rows(p, p.top_level, True)
    tr = tabs.ntt.rows(rows)
    x = res(p, rows, (5,))
    full = list(range(p.num_q))
    xr = res(p, full, (2,))
    spread = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (2, 1, p.n)),
                             device="cuda")
    top = p.top_level
    for fwd in (True, False):
        d = "fwd" if fwd else "inv"
        out += [(f"{d} [5, 21, 2^18] int32 mont", fwd, x.int(), tr, True,
                 i32),
                (f"{d} [5, 21, 2^18] int64", fwd, x, tr, False, i64),
                (f"{d} [2, 17, 2^18] int64 mont", fwd, xr,
                 tabs.ntt.rows(full), True, i64),
                (f"{d} [2, 1, 2^18] outside [0, q) int64 mont", fwd, spread,
                 tabs.ntt.rows([top]), True, i64),
                (f"{d} [2, 2, 2^18] strided view int32->int64 mont", fwd,
                 xr.int()[:, -2:], tabs.ntt.rows([top - 1, top]), True,
                 i64)]
    for logn in (19, 20, ntt.MAX_LOGN):
        n = 1 << logn
        q = tuple(rns.find_ntt_primes(30, 2 * n, 1))
        t = ntt.NTTTables(n, q)
        one = ntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, "cuda").rows([0])
        xo = torch.as_tensor(rng.integers(0, q[0], (1, 1, n)), device="cuda")
        for fwd in (True, False):
            out.append((f"{'fwd' if fwd else 'inv'} [1, 1, 2^{logn}] int32 "
                        f"mont", fwd, xo.int(), one, True, i32))
    return out


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    flags = {f for f in ("--large", "--passes", "--clusters") if f in args}
    args = [a for a in args if a not in flags]
    old = None
    if "--old" in args:
        i = args.index("--old")
        old = Path(args[i + 1])
        del args[i:i + 2]
    names = args if args or old or flags else list(VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("ntt_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    sources = {n: variant_source(n) for n in names}
    if old is not None:
        sources["old"] = old.read_text()
        if "--passes" in flags:
            sources.update({n: variant_source(n, sources["old"])
                            for n in PASS_EDITS})
    if "--clusters" in flags:
        sources["stub"] = CLUSTER_STUB
    kernels.build(["ntt"])
    print(f"kernel at N=2^18: {ntt.occupancy(18)}", flush=True)
    libs = build(sources)
    print_build("kernel", kernels.library_path("ntt"),
                (kernels.BUILD_DIR / "ntt.ptxas.log").read_text())
    for n, (lib, so, log) in libs.items():
        if n == "stub":
            cluster_occupancy(lib)
            continue
        print_build(n, so, log)
        occ = (ctypes.c_int * 8)()
        lib.ntt_occupancy.argtypes = [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int)]
        if lib.ntt_occupancy(18, occ) == 0:
            print(f"{n} at N=2^18: {occ[0]} blocks an SM, {occ[1]} clusters "
                  f"at once, {occ[2]} bytes and {occ[3]} threads a block",
                  flush=True)
    rng = np.random.default_rng(0)
    cases = cases_large(rng) if "--large" in flags else cases_16(rng)
    for label, fwd, x, t, mont, od in cases:
        def base():
            return (ntt.ntt_fwd if fwd else ntt.ntt_inv)(x, t, mont, od)
        want = base()
        for n, (lib, _, _) in libs.items():
            if n == "stub":
                continue

            def var(lib=lib, n=n):
                return launch(lib, n in PAIRED, fwd, x, t, mont, od)
            if n in DIAGNOSTICS:
                var()
            elif n not in PASS_EDITS:
                if not torch.equal(var(), want):
                    raise AssertionError(f"{n} disagrees at {label}")
            elif "2^18" not in label or "21" not in label:
                continue
            b0, v0, v1, b1 = (graph_ms(f) for f in (base, var, var, base))
            what = VARIANTS[n][0] if n in VARIANTS else DIAGNOSTICS[n][0] \
                if n in DIAGNOSTICS else (
                "the earlier source" if n == "old" else
                f"the earlier source's {n.split('_')[1]} launch alone")
            print(f"{label}: kernel {(b0 + b1) / 2:.4f} ms, {n} "
                  f"{(v0 + v1) / 2:.4f} ms ({what})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
