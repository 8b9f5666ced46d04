"""Side-by-side timing of the key-switch legs' conversion kernels
(`csrc/ks_legs.cu`: ks_modup, ks_moddown and their chunked instances)
against an earlier source of that file and against variants of it.

    python3 -m aesfhe_tpu_torch.legs_variants [--old PATH] [name ... | all]

`--old PATH` names an earlier `csrc/ks_legs.cu` with this tree's table
layout (digit matrices in fragment order; its chunked launchers may lack
the fold-group argument); each named variant (`all`: every one in
VARIANTS) is this tree's `csrc/ks_legs.cu` with a few textual edits (the
designs tried beside the one kept).  Every build goes into `build/` under
its own name with the package's nvcc flags; for each conversion kernel
its ptxas registers and spills, its resident blocks per SM at the launch
it gets (`cuOccupancyMaxActiveBlocksPerMultiprocessor` on the build's
cubin), and from `cuobjdump -sass` its loops that store (no storing loop
inside): SASS instructions, words stored, tensor-core instructions,
instructions a stored word, and the instructions of an inner loop run
once a chunk.  At prod_boot's levels 54, 28 and 24, bench's level 15, and
(`SETS`) every set past 8 primes at its top and middle level and the
chain of primes below 2^16, all at 2^16 columns, both conversions of every
build are held torch.equal to their plain versions (random residues) and
timed as CUDA-graph replays in turns (kernel, other, other, kernel), beside
the byte bound and a same-bytes copy (`copy_floor`: one 16-byte word a
thread, as many bytes read and written as the shape's conversion, graph
replays in the same call).
Prints the card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import functools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import bench, kernels
from .core import ks_legs
from .core.params import CKKSParams, get_params

_COLS = "constexpr int kUpCols = 128, kDownCols = 256, kUnroll = 4;"
_UP = "__launch_bounds__(kBlock, 8)\nks_modup_kernel"
_DOWN = "__launch_bounds__(kBlock)\nks_moddown_kernel"
_CH = ("constexpr int kChUpCols = 128, kChDownCols = 256, kChUnroll = 4, "
       "kChWaves = 1;")
_VHAT = ("    for (int cl = threadIdx.x; cl < kCols; cl += blockDim.x)\n"
         "      s_vh[cl] = vhat_rows(buf + cl, kPitch, inv_p, K);\n"
         "    __syncthreads();\n")
_MMA = ("#pragma unroll\n"
        "          for (int e = 0; e < 4; ++e) mma_u8_acc(s[e], a[c][e], b0, "
        "b1);\n")
_CONVERT = ("    convert_tile<NCH, kCols, true>(buf, s_vh, w.a, w.af, w.chunk, "
            "w.f0,\n                                   w.f1, o, R, N, t * "
            "kCols, w.c0, w.width,\n                                   w.r0, "
            "nch, group);\n    __syncthreads();\n  }\n}")

# name -> (what it changes, [(old, new), ...] on csrc/ks_legs.cu)
VARIANTS = {
    "up_cols64": ("ks_modup: 64 columns a block",
                  [(_COLS, _COLS.replace("kUpCols = 128", "kUpCols = 64"))]),
    "up_cols256": ("ks_modup: 256 columns a block",
                   [(_COLS, _COLS.replace("kUpCols = 128",
                                          "kUpCols = 256"))]),
    "down_cols128": ("ks_moddown: 128 columns a block",
                     [(_COLS, _COLS.replace("kDownCols = 256",
                                            "kDownCols = 128"))]),
    "unroll1": ("one 8-column tile at a time per warp",
                [(_COLS, _COLS.replace("kUnroll = 4", "kUnroll = 1"))]),
    "unroll2": ("two 8-column tiles at a time per warp",
                [(_COLS, _COLS.replace("kUnroll = 4", "kUnroll = 2"))]),
    "up_uncapped": ("ks_modup: no register cap",
                    [(_UP, _UP.replace("(kBlock, 8)", "(kBlock)"))]),
    "down_capped": ("ks_moddown: at most 64 registers (8 blocks an SM)",
                    [(_DOWN, _DOWN.replace("(kBlock)", "(kBlock, 8)"))]),
    "ch_up_cols64": ("ks_modup_chunks: 64-column tiles",
                     [(_CH, _CH.replace("kChUpCols = 128",
                                        "kChUpCols = 64"))]),
    "ch_up_cols256": ("ks_modup_chunks: 256-column tiles",
                      [(_CH, _CH.replace("kChUpCols = 128",
                                         "kChUpCols = 256"))]),
    "ch_down_cols128": ("ks_moddown_chunks: 128-column tiles",
                        [(_CH, _CH.replace("kChDownCols = 256",
                                           "kChDownCols = 128"))]),
    "ch_down_cols512": ("ks_moddown_chunks: 512-column tiles",
                        [(_CH, _CH.replace("kChDownCols = 256",
                                           "kChDownCols = 512"))]),
    "ch_unroll1": ("chunked: one 8-column tile at a time per warp",
                   [(_CH, _CH.replace("kChUnroll = 4", "kChUnroll = 1"))]),
    "ch_unroll2": ("chunked: two 8-column tiles at a time per warp",
                   [(_CH, _CH.replace("kChUnroll = 4", "kChUnroll = 2"))]),
    "ch_waves2": ("chunked: a grid of two resident waves",
                  [(_CH, _CH.replace("kChWaves = 1", "kChWaves = 2"))]),
    "ch_warps8": ("chunked: blocks of 8 warps below 8 row tiles",
                  [("constexpr int kChWarps = 4;",
                    "constexpr int kChWarps = 8;")]),
    # diagnostics (results wrong, timed only): ks_moddown_chunks without a
    # phase
    "diag_down_no_vhat": ("ks_moddown_chunks without the v_hat pass",
                          [(_VHAT, "")]),
    "diag_down_no_mma": ("chunked conversions without the products",
                         [(_MMA, "")]),
    "diag_down_no_convert": ("ks_moddown_chunks without the conversion",
                             [(_CONVERT, "    __syncthreads();\n  }\n}")]),
}
LEVELS = (54, 28, 24)    # prod_boot's; and bench's widest switch, level 15
# Parameter sets past one k-step of the conversion kernels (8 primes): 9,
# 10, 16 and 20 special primes, and digits of 9 (alpha 9), 16 (alpha 16)
# and 21 limbs (K=20: three chunks each way); prod_boot's scale and secret
# weight on a 13-prime chain (21 for alpha 16 and K=20).  SETS_MIDDLE: a
# middle level that keeps a digit past 8 limbs (past 16 for K=20).
SETS = {"K=9": dict(num_special_primes=9),
        "K=10": dict(num_special_primes=10),
        "K=16": dict(num_special_primes=16),
        "alpha=9": dict(num_special_primes=10, alpha=9),
        "alpha=16": dict(max_level=20, num_special_primes=16, alpha=16),
        "K=20": dict(max_level=20, num_special_primes=20)}
SETS = {k: dict(dict(n=1 << 16, max_level=12, scale_bits=27,
                     secret_hamming=192), **v) for k, v in SETS.items()}
SETS_MIDDLE = {"K=9": 9, "K=10": 10, "K=16": 9, "alpha=9": 9,
               "alpha=16": 16, "K=20": 17}
# The chain of primes below 2^16 (30, 15, 14, 16, 16 bits; specials of
# 30): scale 2^14 needs primes 1 mod 2N near 2^14, which exist up to
# N=2^11, so its sets run at N=2^10 and its conversion tables are timed
# at 2^16 columns.
SMALL_PRIMES = dict(n=1 << 10, max_level=4, scale_bits=14)
COLS = 1 << 16           # columns of every SETS / SMALL_PRIMES case
P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_COPY_SRC = r"""
#include <cuda_runtime.h>
// Reads n_in and writes n_out 16-byte words, one a thread: the bytes of a
// conversion with nothing computed.  The store of a word past n_out fires
// only for a value no residue has, so every read stays.
__global__ void copy_floor_kernel(const uint4* __restrict__ in, long long n_in,
                                  uint4* __restrict__ out, long long n_out) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  const uint4 v = i < n_in ? in[i] : make_uint4(0, 0, 0, 0);
  if (i < n_out) out[i] = v;
  else if (v.x == 0xFFFFFFFFu) out[0] = v;
}
extern "C" int copy_floor_launch(const void* in, long long n_in, void* out,
                                 long long n_out, void* stream) {
  const long long n = n_in > n_out ? n_in : n_out;
  copy_floor_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>((const uint4*)in, n_in,
                                              (uint4*)out, n_out);
  return (int)cudaGetLastError();
}
"""


def variant_source(name: str) -> str:
    src = kernels.SOURCES["ks_legs"].read_text()
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: edit not found once: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def _takes_group(src: str) -> bool:
    """Whether the source's chunked launchers take the fold group (this
    tree's; the earlier ones, one fold a chunk, take only the chunk
    count)."""
    return "int nch, int group" in src


def build(sources: dict) -> dict:
    """Compile {name: CUDA source text} in parallel into build/; returns
    {name: (ctypes library, its path, nvcc's output, takes the fold
    group)}; the name "copy" is `_COPY_SRC`'s library."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, text in sources.items():
        cu = kernels.BUILD_DIR / f"ks_legs_{n}.cu"
        cu.write_text(text)
        so = kernels.BUILD_DIR / f"libks_legs_{n}.so"
        procs[n] = (so, text, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for n, (so, text, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ks_legs {n}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        if n == "copy":
            lib.copy_floor_launch.argtypes = [P, L, P, L, P]
            libs[n] = (lib, so, log, False)
            continue
        grp = _takes_group(text)
        lib.ks_modup_launch.argtypes = [P] * 8 + [I] * 5 + [P]
        lib.ks_moddown_launch.argtypes = [P] * 8 + [I] * 4 + [P]
        lib.ks_modup_chunks_launch.argtypes = [P] * 8 + [I] * (6 + grp) + [P]
        lib.ks_moddown_chunks_launch.argtypes = [P] * 8 + [I] * (5 + grp) + \
            [P]
        for fn in (lib.ks_modup_launch, lib.ks_moddown_launch,
                   lib.ks_modup_chunks_launch, lib.ks_moddown_chunks_launch):
            fn.restype = ctypes.c_int
        libs[n] = (lib, so, log, grp)
    return libs


_KINDS = ("ks_modup_chunks", "ks_moddown_chunks", "ks_modup", "ks_moddown",
          "sub_scale")


def short_name(symbol: str) -> str:
    """A kernel's name from its mangled symbol, with its template
    arguments: ks_modup_chunks_kernel<2> -> "ks_modup_chunks<2>"."""
    for k in _KINDS:
        m = re.search(rf"{k}_kernel(?:I((?:Li-?\d+E)+)E)?", symbol)
        if m:
            args = re.findall(r"Li(-?\d+)E", m.group(1) or "")
            return k + (f"<{', '.join(args)}>" if args else "")
    return symbol


def ptxas_lines(log: str) -> list[str]:
    """'kernel: registers ...; spills ...' for each kernel in nvcc -Xptxas
    -v output."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and entry is not None:
            out.append(f"{short_name(entry)}: "
                       f"{line.split(':', 1)[1].strip()}; {spill}")
    return out


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_BRA = re.compile(r"\bBRA\s+(?:!?U?P\w+,\s*)?(?:`\()?(0x[0-9a-f]+)")


def _sass(so: Path) -> str:
    cuobjdump = Path(kernels.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def sass_loops(so: Path, kinds=("ks_modup_kernel", "ks_moddown_kernel"),
               stores=("STG",), by_symbol: bool = False,
               through_loops: bool = False) -> dict:
    """{kernel: [(instructions, words stored, tensor-core instructions),
    ...]} over the innermost loops (a backward branch and its target, no
    other loop inside) that store (`stores`: global memory by default) of
    each kernel whose symbol holds one of `kinds` (the conversion kernels
    by default; the first match names it, or with `by_symbol` the whole
    symbol), from `cuobjdump -sass`.  `through_loops`: the loops that store
    with no storing loop inside, each row with a fourth number, the
    instructions of the loops inside it (run once an iteration of theirs:
    a chunk loop)."""
    funcs: dict = {}
    name = None
    for line in _sass(so).splitlines():
        if "Function :" in line:
            sym = line.split("Function :")[1].strip()
            name = next((k for k in kinds if k in sym), None)
            if name:
                name = sym if by_symbol else name.removesuffix("_kernel")
                funcs[name] = []
        elif name and (m := _INSN.search(line)):
            funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, insns in funcs.items():
        loops = sorted({(int(b.group(1), 16), a) for a, t in insns
                        if (b := _BRA.search(t)) and int(b.group(1), 16) <= a})

        def body(s, e):
            return [t for a, t in insns if s <= a <= e]

        def stored(ts):
            ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in ts]
            return ops, sum(4 if op.endswith(".128") else
                            2 if op.endswith(".64") else 1
                            for op in ops if op.startswith(stores))

        def inside(s, e):
            return [(s2, e2) for s2, e2 in loops
                    if (s2, e2) != (s, e) and s <= s2 and e2 <= e]
        rows = []
        for s, e in loops:
            ops, words = stored(body(s, e))
            inner = inside(s, e)
            if not words or (inner and not through_loops) or any(
                    stored(body(*lp))[1] for lp in inner):
                continue
            row = (len(ops), words, sum(op.startswith("IMMA") for op in ops))
            if through_loops:
                row += (len({a for lp in inner for a, _ in insns
                             if lp[0] <= a <= lp[1]}),)
            rows.append(row)
        out[name] = rows
    return out


@functools.lru_cache(maxsize=None)
def _cubin(so: Path) -> tuple[Path, tuple[str, ...]]:
    """The library's sm_90a cubin (extracted beside it) and its kernels'
    symbols."""
    cuobjdump = Path(kernels.nvcc_path()).with_name("cuobjdump")
    tmp = so.parent / f"{so.stem}_cubin"
    tmp.mkdir(exist_ok=True)
    subprocess.run([str(cuobjdump), "-xelf", "all", str(so.resolve())],
                   cwd=tmp, capture_output=True, check=True, timeout=120)
    return (sorted(tmp.glob("*.cubin"))[-1],
            tuple(re.findall(r"Function : (\S+)", _sass(so))))


def occupancy(so: Path, launches: dict) -> dict:
    """{short_name: resident blocks per SM} for the kernels of `so` named
    in launches {short_name: (threads, dynamic shared bytes)}, from
    cuOccupancyMaxActiveBlocksPerMultiprocessor on the library's cubin
    (the primary context current, as torch leaves it)."""
    torch.zeros(1, device="cuda")
    cubin, syms = _cubin(so)
    cu = ctypes.CDLL("libcuda.so.1")
    mod = ctypes.c_void_p()
    if cu.cuModuleLoad(ctypes.byref(mod), str(cubin).encode()):
        raise RuntimeError(f"cuModuleLoad failed on {cubin}")
    out = {}
    try:
        for sym in syms:
            shape = launches.get(short_name(sym))
            if shape is None:
                continue
            threads, smem = shape
            fn = ctypes.c_void_p()
            n = ctypes.c_int()
            err = cu.cuModuleGetFunction(ctypes.byref(fn), mod, sym.encode())
            if not err and smem > 48 * 1024:
                # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
                err = cu.cuFuncSetAttribute(fn, 8, smem)
            err = err or cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                ctypes.byref(n), fn, threads, ctypes.c_size_t(smem))
            if err:
                raise RuntimeError(f"occupancy of {sym}: CUDA error {err}")
            out[short_name(sym)] = n.value
    finally:
        cu.cuModuleUnload(mod)
    return out


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def modup_call(lib, grp: bool, c, tab):
    """Every digit of tab's level through lib's ks_modup launcher (the
    chunked one past 8 limbs; `grp`: it takes the fold group)."""
    out = torch.empty((tab.J, tab.M, c.shape[1]), dtype=torch.int32,
                      device=c.device)
    args = [c.data_ptr(), tab.dig.data_ptr(), tab.dq.data_ptr(),
            tab.dinv.data_ptr(), tab.dinvsh.data_ptr(), tab.afrag.data_ptr(),
            tab.bfold.data_ptr(), out.data_ptr(), 0, tab.J, tab.J, tab.M,
            c.shape[1]]
    if tab.nch == 1:
        err = lib.ks_modup_launch(*args, _stream())
    else:
        err = lib.ks_modup_chunks_launch(
            *args, tab.nch, *([tab.group] if grp else []), _stream())
    _check(err, "ks_modup")
    return out


def moddown_call(lib, grp: bool, d, tab):
    """d [B, K, N] through lib's ks_moddown launcher (the chunked one past
    8 special primes)."""
    out = torch.empty((d.shape[0], tab.R, d.shape[-1]), dtype=torch.int32,
                      device=d.device)
    args = [d.data_ptr(), tab.sp.data_ptr(), tab.sinv.data_ptr(),
            tab.sinvsh.data_ptr(), tab.inv_p.data_ptr(), tab.afrag.data_ptr(),
            tab.fold.data_ptr(), out.data_ptr(), d.shape[0], tab.K, tab.R,
            d.shape[-1]]
    if tab.nch == 1:
        err = lib.ks_moddown_launch(*args, _stream())
    else:
        err = lib.ks_moddown_chunks_launch(
            *args, tab.nch, *([tab.group] if grp else []), _stream())
    _check(err, "ks_moddown")
    return out


def copy_call(lib, src, dst, n_in: int, n_out: int):
    """copy_floor over n_in input and n_out output 16-byte words."""
    _check(lib.copy_floor_launch(src.data_ptr(), n_in, dst.data_ptr(), n_out,
                                 _stream()), "copy_floor")


def graph_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call of `reps` calls captured in one CUDA graph
    and replayed three times (CUDA events): the kernels' time without the
    host's enqueue cost, which exceeds a short kernel's."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def _old_chunk_launch(kind: str, nch: int) -> tuple[int, int]:
    """(threads, dynamic shared bytes) of the earlier chunked kernels (one
    fold a chunk)."""
    if kind == "ks_modup_chunks":
        return 128, 4 * nch * 8 * (128 + 8)
    return 128, 4 * (256 + nch * 8 * (256 + 8))


def chunk_launch(lib, grp: bool, kind: str, nch: int,
                 M: int) -> tuple[int, int]:
    """(threads, dynamic shared bytes) of a chunked launch: from the
    library's own `ks_chunks_shape` where it has one (this tree's)."""
    if not grp:
        return _old_chunk_launch(kind, nch)
    out = (ctypes.c_int * 2)()
    lib.ks_chunks_shape.argtypes = [I] * 3 + [ctypes.POINTER(ctypes.c_int)]
    _check(lib.ks_chunks_shape(int(kind == "ks_moddown_chunks"), nch, M, out),
           "ks_chunks_shape")
    return out[0], out[1]


def cases(dev, rng) -> list:
    """(tag, up tables, down tables, c, d) at LEVELS and bench's level 15
    (prod_boot's widths), then every SETS entry at its top and middle
    level and SMALL_PRIMES' top level, at COLS columns."""
    def residues(params, rows, lead, n):
        qa = np.asarray(params.all_primes, dtype=np.int64)
        x = rng.integers(0, 1 << 62, tuple(lead) + (len(rows), n))
        return torch.as_tensor(x % qa[list(rows)].reshape(-1, 1),
                               device=dev).int()

    p = get_params("prod_boot")
    bp = bench.bench_params(16, 16)
    todo = [(f"level {lv}", p, lv) for lv in LEVELS]
    todo.append(("bench level 15", bp, 15))
    for name, kw in SETS.items():
        sp = CKKSParams(**kw)
        todo += [(f"{name} level {lv}", sp, lv)
                 for lv in (sp.top_level, SETS_MIDDLE[name])]
    sp = CKKSParams(**SMALL_PRIMES)
    todo.append((f"scale 2^14 level {sp.top_level}", sp, sp.top_level))
    out = []
    for tag, params, level in todo:
        n = params.n if params.n >= COLS else COLS
        out.append((tag, ks_legs.ModupTables(params, level, dev),
                    ks_legs.ModdownTables(params, level, dev),
                    residues(params, range(level + 1), (), n),
                    residues(params, range(params.num_q, params.L_tot), (2,),
                             n)))
    return out


def compare(old: Path | None, names=()) -> list[dict]:
    """Build the package's ks_legs.cu, `old` (if given) and the named
    variants; print their ptxas lines, occupancy and SASS loop counts; at
    every `cases` shape hold every build's conversions equal to the plain
    versions, time this tree's kernel (graph replays), the same-bytes copy
    and the byte bound, and each other build beside the kernel in turns
    (kernel, other, other, kernel).  Returns one record per (shape,
    kernel): ms of the kernel and of each other build (the mean of its two
    turns), copy_ms, bound_ms."""
    sources = {"kernel": kernels.SOURCES["ks_legs"].read_text(),
               "copy": _COPY_SRC}
    if old is not None:
        sources["old"] = Path(old).read_text()
    sources.update({n: variant_source(n) for n in names})
    libs = build(sources)
    copy_lib = libs.pop("copy")[0]
    for n, (_, so, log, _) in libs.items():
        for line in ptxas_lines(log):
            print(f"ptxas ks_legs {n} {line}", flush=True)
        kinds = ("ks_modup_kernel", "ks_moddown_kernel",
                 "ks_modup_chunks_kernel", "ks_moddown_chunks_kernel")
        for k, rows in sass_loops(so, kinds, by_symbol=True,
                                  through_loops=True).items():
            for ins, words, imma, inner in rows:
                print(f"sass ks_legs {n} {short_name(k)}: loop {ins} "
                      f"instructions ({inner} in an inner loop run once a "
                      f"chunk), {words} words stored, {imma} IMMA: "
                      f"{ins / words:.1f} instructions a word", flush=True)
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    records = []
    shown = set()
    for tag, up, down, c, d in cases(dev, rng):
        N = c.shape[-1]
        want = {"ks_modup": ks_legs.ks_modup_plain(c, up, 0, up.J),
                "ks_moddown": ks_legs.ks_moddown_plain(d, down)}
        calls = {"ks_modup": lambda lb, g: modup_call(lb, g, c, up),
                 "ks_moddown": lambda lb, g: moddown_call(lb, g, d, down)}
        works = {"ks_modup": ks_legs.modup_work(c.shape[0], up.J, up.M, N),
                 "ks_moddown": ks_legs.moddown_work(2, down.K, down.R, N)}
        for kname, tab in (("ks_modup", up), ("ks_moddown", down)):
            chunked = tab.nch > 1
            inst = kname + ("_chunks" if chunked else "")
            if chunked:
                M = up.M if kname == "ks_modup" else down.R
                held = ks_legs.chunk_instance(tab.nch, tab.group)
                for n, (lib, so, _, grp) in libs.items():
                    if (n, inst, tab.nch, tab.group, M) in shown:
                        continue
                    shown.add((n, inst, tab.nch, tab.group, M))
                    launch = chunk_launch(lib, grp, inst, tab.nch, M)
                    occ = occupancy(so, {inst + (f"<{held}>" if grp else ""):
                                         launch})
                    print(f"occupancy ks_legs {n} {inst} nch={tab.nch} "
                          f"M={M}: {launch[0]} threads, {launch[1]} bytes "
                          f"of shared memory: {occ} blocks an SM",
                          flush=True)
            nbytes = works[kname][0]
            src = c if kname == "ks_modup" else d
            n_in = src.numel() // 4
            n_out = nbytes // 16 - n_in
            dst = torch.empty(n_out * 4, dtype=torch.int32, device=dev)
            copy_ms = graph_ms(lambda: copy_call(copy_lib, src, dst, n_in,
                                                 n_out))
            bound_ms = nbytes / 3.35e12 * 1e3
            base = (lambda: calls[kname](libs["kernel"][0],
                                         libs["kernel"][3]))
            if not torch.equal(base(), want[kname]):
                raise AssertionError(f"{inst} (kernel) disagrees with its "
                                     f"plain version at {tag}")
            rec = dict(shape=tag, kernel=inst, bound_ms=bound_ms,
                       copy_ms=copy_ms)
            if len(libs) == 1:
                rec["kernel_ms"] = graph_ms(base)
            for n, (lib, _, _, grp) in libs.items():
                if n == "kernel":
                    continue
                mine = (lambda lb=lib, g=grp: calls[kname](lb, g))
                if not n.startswith("diag_") and \
                        not torch.equal(mine(), want[kname]):
                    raise AssertionError(f"{inst} ({n}) disagrees with its "
                                         f"plain version at {tag}")
                b0, v0, v1, b1 = (graph_ms(f) for f in (base, mine, mine,
                                                       base))
                rec["kernel_ms"] = (b0 + b1) / 2
                rec[f"{n}_ms"] = (v0 + v1) / 2
            records.append(rec)
            others = ", ".join(
                f"{n} {rec[f'{n}_ms']:.4f}" for n in libs if n != "kernel")
            print(f"{inst} {tag} nch={tab.nch}: kernel "
                  f"{rec['kernel_ms']:.4f} ms"
                  + (f" [{others}]" if others else "")
                  + f", copy of the same bytes {copy_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms by bytes ({bound_ms / rec['kernel_ms']:.0%}"
                  f" of bound; copy {bound_ms / copy_ms:.0%}); equal to the "
                  f"plain version", flush=True)
        del want, c, d
    return records


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    old = None
    if "--old" in args:
        i = args.index("--old")
        old = Path(args[i + 1])
        del args[i:i + 2]
    if args == ["all"]:
        args = list(VARIANTS)
    if not torch.cuda.is_available():
        raise SystemExit("legs_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    compare(old, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
