"""Side-by-side timing of the key-switch legs' conversion kernels
(`csrc/ks_legs.cu`: ks_modup, ks_moddown) against an earlier source of that
file and against variants of it.

    python3 -m aesfhe_tpu_torch.legs_variants [--old PATH] [name ...]

`--old PATH` names an earlier `csrc/ks_legs.cu` whose conversions are
64-bit multiply-adds with one Barrett reduction a word (launchers that take
conv_w [J, 8, M] and floor(2^64 / q)); each variant is this tree's
`csrc/ks_legs.cu` with a few textual edits (the designs tried beside the
one kept).  Every build goes into `build/` under its own name with the
package's nvcc flags; its ptxas registers and spills are printed, and from
`cuobjdump -sass` each conversion kernel's innermost loops that store: SASS
instructions, words stored, tensor-core instructions and instructions per
stored word.  At prod_boot's levels 54, 28 and 24 and bench's level 15
both conversions of every build are held torch.equal to their plain
versions (random residues) and timed as CUDA-graph replays in turns
(other, kernel, kernel, other).
Prints the card's name and power limit first.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import bench, kernels
from .core import ks_legs
from .core.params import get_params

_COLS = "constexpr int kUpCols = 128, kDownCols = 256, kUnroll = 4;"
_UP = "__launch_bounds__(kBlock, 8)\nks_modup_kernel"
_DOWN = "__launch_bounds__(kBlock)\nks_moddown_kernel"

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
}
LEVELS = (54, 28, 24)    # prod_boot's; and bench's widest switch, level 15
P, I = ctypes.c_void_p, ctypes.c_int


def variant_source(name: str) -> str:
    src = kernels.SOURCES["ks_legs"].read_text()
    for old, new in VARIANTS[name][1]:
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
        cu = kernels.BUILD_DIR / f"ks_legs_{n}.cu"
        cu.write_text(text)
        so = kernels.BUILD_DIR / f"libks_legs_{n}.so"
        procs[n] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for n, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"ks_legs {n}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        old = n == "old"
        lib.ks_modup_launch.argtypes = [P] * (9 if old else 8) + [I] * 5 + [P]
        lib.ks_moddown_launch.argtypes = [P] * (11 if old else 8) + \
            [I] * 4 + [P]
        for fn in (lib.ks_modup_launch, lib.ks_moddown_launch):
            fn.restype = ctypes.c_int
        libs[n] = (lib, so, log)
    return libs


def ptxas_lines(log: str) -> list[str]:
    """'kernel: registers ...; spills ...' for each conversion kernel in
    nvcc -Xptxas -v output."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and entry is not None:
            name = next((k for k in ("ks_modup", "ks_moddown", "sub_scale")
                         if f"{k}_kernel" in entry), entry)
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_BRA = re.compile(r"\bBRA\s+(?:!?U?P\w+,\s*)?(?:`\()?(0x[0-9a-f]+)")


def sass_loops(so: Path) -> dict:
    """{kernel: [(instructions, words stored, tensor-core instructions),
    ...]} over each conversion kernel's innermost loops (a backward branch
    and its target, no other loop inside) that store to global memory,
    from `cuobjdump -sass`."""
    cuobjdump = Path(kernels.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    funcs: dict = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            sym = line.split("Function :")[1].strip()
            name = next((k for k in ("ks_modup", "ks_moddown")
                         if f"{k}_kernel" in sym), None)
            if name:
                funcs[name] = []
        elif name and (m := _INSN.search(line)):
            funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    out = {}
    for name, insns in funcs.items():
        loops = [(int(b.group(1), 16), a) for a, t in insns
                 if (b := _BRA.search(t)) and int(b.group(1), 16) <= a]
        inner = [(s, e) for s, e in loops
                 if not any((s, e) != (s2, e2) and s <= s2 and e2 <= e
                            for s2, e2 in loops)]
        rows = []
        for s, e in sorted(set(inner)):
            body = [t for a, t in insns if s <= a <= e]
            ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in body]
            words = sum(4 if op.endswith(".128") else
                        2 if op.endswith(".64") else 1
                        for op in ops if op.startswith("STG"))
            if words:
                rows.append((len(body), words,
                             sum(op.startswith("IMMA") for op in ops)))
        out[name] = rows
    return out


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def modup_call(lib, old: bool, c, tab, bmu):
    """Every digit of tab's level through lib's ks_modup launcher."""
    out = torch.empty((tab.J, tab.M, c.shape[1]), dtype=torch.int32,
                      device=c.device)
    mid = ([tab.conv, tab.bq, bmu] if old else [tab.afrag, tab.bfold])
    _check(lib.ks_modup_launch(
        c.data_ptr(), tab.dig.data_ptr(), tab.dq.data_ptr(),
        tab.dinv.data_ptr(), tab.dinvsh.data_ptr(),
        *(t.data_ptr() for t in mid), out.data_ptr(), 0, tab.J, tab.J,
        tab.M, c.shape[1], _stream()), "ks_modup")
    return out


def moddown_call(lib, old: bool, d, tab, extra):
    """d [B, K, N] through lib's ks_moddown launcher; extra: the earlier
    source's floor(2^64 / q) and P mod q's Shoup companions."""
    out = torch.empty((d.shape[0], tab.R, d.shape[-1]), dtype=torch.int32,
                      device=d.device)
    mid = ([tab.conv, tab.q, extra[0], tab.pmod, extra[1]] if old
           else [tab.afrag, tab.fold])
    _check(lib.ks_moddown_launch(
        d.data_ptr(), tab.sp.data_ptr(), tab.sinv.data_ptr(),
        tab.sinvsh.data_ptr(), tab.inv_p.data_ptr(),
        *(t.data_ptr() for t in mid), out.data_ptr(), d.shape[0], tab.K,
        tab.R, d.shape[-1], _stream()), "ks_moddown")
    return out


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


def compare(old: Path | None, names=()) -> list[dict]:
    """Build the package's ks_legs.cu, `old` (if given) and the named
    variants; print their ptxas and SASS loop counts; hold every build's
    conversions equal to the plain versions at LEVELS and time each beside
    the package's kernel in turns (other, kernel, kernel, other).  Returns
    one record per (build, kernel, level): ms of the build and of the
    kernel (each the mean of its two turns)."""
    sources = {"kernel": kernels.SOURCES["ks_legs"].read_text()}
    if old is not None:
        sources["old"] = Path(old).read_text()
    sources.update({n: variant_source(n) for n in names})
    libs = build(sources)
    for n, (_, so, log) in libs.items():
        for line in ptxas_lines(log):
            print(f"ptxas ks_legs {n} {line}", flush=True)
        for k, rows in sass_loops(so).items():
            for ins, words, imma in rows:
                print(f"sass ks_legs {n} {k}: innermost loop {ins} "
                      f"instructions, {words} words stored, {imma} IMMA: "
                      f"{ins / words:.1f} instructions a word", flush=True)
    p = get_params("prod_boot")
    bp = bench.bench_params(16, 16)
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")

    def residues(params, rows, lead):
        qa = np.asarray(params.all_primes, dtype=np.int64)
        x = rng.integers(0, 1 << 62, tuple(lead) + (len(rows), params.n))
        return torch.as_tensor(x % qa[list(rows)].reshape(-1, 1),
                               device=dev).int()

    def u32(a):
        return torch.as_tensor(ks_legs._bits32(a), device=dev)

    def mu_of(q):
        return torch.as_tensor([(1 << 64) // v for v in q],
                               dtype=torch.int64, device=dev)

    records = []
    base_lib = libs["kernel"][0]
    for params, level in [(p, lv) for lv in LEVELS] + [(bp, 15)]:
        tag = f"level {level}" + (" (bench)" if params is bp else "")
        up = ks_legs.ModupTables(params, level, dev)
        down = ks_legs.ModdownTables(params, level, dev)
        c = residues(params, range(level + 1), ())
        d = residues(params, range(params.num_q, params.L_tot), (2,))
        qs = [int(v) for v in params.q_primes[:level + 1]]
        pmod = params.md_tables(level)["pmod_w"]
        bmu = mu_of(params.ks_tables(level)["basis"].tolist())
        extra = (mu_of(qs), u32(ks_legs._shoup(pmod, qs)))
        want_up = ks_legs.ks_modup_plain(c, up, 0, up.J)
        want_down = ks_legs.ks_moddown_plain(d, down)
        for n, (lib, _, _) in libs.items():
            if n == "kernel":
                continue
            for kname, call, want in (
                    ("ks_modup", lambda lb, o: modup_call(lb, o, c, up, bmu),
                     want_up),
                    ("ks_moddown",
                     lambda lb, o: moddown_call(lb, o, d, down, extra),
                     want_down)):
                mine = (lambda lb=lib, o=(n == "old"): call(lb, o))
                base = (lambda: call(base_lib, False))
                for f, who in ((mine, n), (base, "kernel")):
                    if not torch.equal(f(), want):
                        raise AssertionError(f"{kname} ({who}) disagrees "
                                             f"with its plain version at "
                                             f"{tag}")
                v0, b0, b1, v1 = (graph_ms(f) for f in (mine, base, base,
                                                       mine))
                rec = dict(build=n, kernel=kname, level=level,
                           bench=params is bp, ms=(v0 + v1) / 2,
                           kernel_ms=(b0 + b1) / 2)
                records.append(rec)
                what = "the earlier source" if n == "old" else VARIANTS[n][0]
                print(f"{kname} {tag}: kernel {rec['kernel_ms']:.4f} ms "
                      f"({b0:.4f}, {b1:.4f}), {n} {rec['ms']:.4f} ms "
                      f"({v0:.4f}, {v1:.4f}; {what}); equal to the plain "
                      f"version", flush=True)
    return records


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    old = None
    if "--old" in args:
        i = args.index("--old")
        old = Path(args[i + 1])
        del args[i:i + 2]
    if not torch.cuda.is_available():
        raise SystemExit("legs_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    compare(old, args or list(VARIANTS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
