"""Smoke run of the PyTorch/CUDA port (aesfhe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--mesh-only] [--legs-baseline PATH]

Phases, each announced on its own line; any failure exits non-zero
(`--mesh-only`: phases 1-3 and 9, e.g. on a machine with several cards;
`--legs-baseline PATH`: the kernel phase also builds PATH, an earlier
csrc/ks_legs.cu, and times its conversions beside this tree's in turns,
`legs_variants.compare`):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and which of nvcc, ninja and triton exist;
  2. build every CUDA kernel of the port from csrc/ (one nvcc per source,
     all started together);
  3. kernel phase: each kernel against its plain torch version on random
     residues at the shapes the main path gives it, exact equality
     required; kernel time (CUDA events), plain time and the bound; the
     NTT kernels (ntt_fwd, ntt_inv; their ptxas registers and launch
     occupancy) in every variant of their contract (int32/int64 in and
     out, Montgomery factors folded in) at a key-switch decomposition's J
     digits over q|specials (the top level; level 29's gapped rows), a
     rescale's 2 x 55 rows, one row with inputs outside [0, q), a strided
     view, DistNTT's [128, 55, 256], one row of 2^17, and the round
     trips; the NTT above 2^17 alike (2^18: ntt_cluster16, one launch on a
     cluster of 16 blocks; from 2^19 the two-pass NTT, two launches a
     transform) at bench LOGN=18's decomposition [5, 21, 2^18], a
     rescale's [2, 17, 2^18], one row outside [0, q), a strided view, one
     row each of 2^19, 2^20 and 2^25 (the kernels' largest ring), and the
     round trips; the key-switch legs (ks_modup, ks_moddown, sub_scale; their
     ptxas registers and spills) at levels 54, 28 and 24 and bench's
     widest switch, ks_modup over the mesh's digit ranges (a padded last
     digit, a range of padding only), both conversions on byte-extreme
     inputs (K = 8 and 4), ks_moddown on inputs at float32 half-integers
     of v_hat's sum (K = 8 and 4), sub_scale on strided views; then both
     conversions past one k-step (WIDE_SETS at N=2^16: 9, 10, 16 and 20
     special primes, digits of 9, 16 and 21 limbs: two and three chunks;
     the chunked instances, their ptxas lines and resident blocks an SM)
     and over the chain of primes below 2^16 (SMALL_PRIMES' tables, 2^16
     columns), at the top and a middle level, on random, byte-extreme and
     (mod-down) half-integer inputs; the LUT sums (lut_sum, lut_sum_dense)
     at EvalMod's K = 7 terms of [2, 42, 2^16], the rounds' K = 16 of
     [2, 16] and CoeffToSlot's first group, K = 8 of [2, 55];
  3b. key-switch phase: one relinearization (of a product, rescaled) and
     one rotation at each of WIDE_SETS (N=2^16) and SMALL_PRIMES (N=2^10,
     the largest ring its primes exist for), from seeded keys, decrypted
     against the encoded values with the decode error stated; every
     key-switch kernel launched, the chunked instances exactly where a
     digit or the special set passes 8 primes;
  4. slice phase: keygen at prod_boot (N=2^16, 55 q-primes, 8 special
     primes, dnum 7) from a seeded generator, then two bit-sliced AES-128
     rounds on 2048 random blocks from the uniform work level 2*14+1 = 29,
     decrypted and held block by block against a plain AES oracle; the
     kernel's launch count over the run must equal the engine's key-switch
     count;
  5. flagship phase: the flagship's keygen (the bootstrap's Galois keys
     shared into the round's set), 2048 random blocks (block 0 FIPS-197
     C.1's plaintext) encrypted and dropped to the work level 15, then
     FLAGSHIP_ROUNDS rounds with a pair-packed refresh (4 bootstraps)
     before every round after the first (run_full_aes), each bootstrap a
     replay of the fused bootstrap's CUDA graph (captured at the first
     refresh, as the reference's flagship runs its fused bootstrap), every
     block held against the AES oracle, block 0 against FIPS-197 C.1 after
     10 rounds; launches (the replays' included) must equal key-switches
     here too;
  6. fused bootstrap phase: at the flagship's keys, one graph captured
     anew from the last refresh's first input, replayed on that refresh's
     4 inputs, each replay equal bit for bit to the eager bootstrap of the
     same input; capture, eager and replay seconds, the graph pool;
  7. the kernel against its plain version at the widest SlotToCoeff level
     the flagship's bootstraps reached (read from their diagonal cache);
  8. zeta phase: the nibble-pair pipeline (AESFHE128) at prod_boot: keygen
     (relin, conj, the bootstrap key, and direct Galois keys for the merged
     ShiftRows+MixColumns steps of both directions, so its rotations are
     hoisted), then 2048 random blocks as one pair of zeta16 nibble
     ciphertexts, encrypted fresh at level 54: the forward leg (ARK(rk0)
     and round 1, no refresh) held against aes128_partial(block, key, 1),
     the inverse leg (decrypt_rounds on a fresh encryption of that result,
     segment-refresh schedule with the bootstrap) held against the
     plaintext, and the ten-round leg (encrypt_rounds(rounds=10) in the
     segment-refresh schedule with the eager bootstrap, post_boot_cleanses
     2; block 0 FIPS-197 C.1's plaintext) held against
     aes128_partial(block, key, 10) and block 0 against FIPS-197 C.1;
     launches must equal key-switches in each leg;
  9. mesh phase: the multi-device path (parallel.MeshEngine) at prod_boot
     on D ranks, each a spawned process: D = the card count over NCCL with
     two cards or more, else D = 2 ranks sharing the one card over gloo
     (CUDA tensors if this gloo takes them, else staged through pinned host
     buffers; printed).  Every rank generates the flagship's keys from one
     seed (relin, conj, the bootstrap's Galois keys, the round's rotation
     keys) and keeps its digit shard on a MeshEngine (EngineContext.on_mesh);
     2048 random blocks at the work level 15 go through one bit-sliced
     round and then the pair-packed refresh's first bootstrap (it fills
     the diagonal cache; with --mesh-only also the second, which runs warm;
     eager: a CUDA graph cannot capture the collectives) with every
     key-switch sharded
     (one all-reduce each).  Rank 0 runs the same inputs through the
     single-device Engine with the same full keys: every output ciphertext
     must be torch.equal, every block equal to the AES oracle and the
     bootstrap decode to the round's bits; on every rank all-reduces =
     key-switches = ks_inner launches, and the ledger's bytes = the
     predicted 2*M*N*8 per key-switch at its level.  The kernel phase also
     times ks_inner at the ranks' shapes (J = pad/D digits, the last rank's
     padded digits zero) and on an all-zero shard;
 10. bench phase (after the slice): `python -m aesfhe_tpu_torch bench`'s
     bitplane and zeta legs in process at N=2^16, 16 levels, 3 iterations,
     no CPU leg, each printing its JSON line, its output decrypted and held
     against the AES oracle (one round under round key 1; ARK + S-box),
     launches equal to key-switches; the kernel phase also times ks_inner
     at that profile's widest switch.  The flagship phase prints the bench
     flagship line mapped from its own result;
 10b. large-ring phase (after the bench phase): the bitplane leg at
     AESFHE_BENCH_LOGN=18 (8192 blocks, every one exact), the zeta leg at
     17 (exact) and at 18 (its wrong bytes printed, not failed: the
     reference's noise at that ring decides), the zeta step's largest
     phase error at 16, 17 and 18, peak device memory; then the 3b check
     at N=2^20 on LARGE_HP (decoded within 5%) and LARGE_KS (its decode
     error printed, the reference's at that set; the card's residues held
     against the host's plain versions); the 16-block NTT launched on the
     legs at 2^18, the two-pass NTT on the key-switches at 2^20, each on no
     other path.
Every main path (slice, bench legs, flagship with its graph replays, each
fused replay, zeta legs, every mesh rank) zeroes the launch counts just
before it and prints every kernel's launches, which must all be > 0 (the
key-switch checks of phases 3b and 10b run no LUT sum), with
one ks_moddown launch per ks_inner launch (one mod-down per key-switch),
and none of an instance of kernels.VARIANTS off its own paths (prod_boot's
digits and special set have 8 primes, its ring 2^16).  The line before the
last is a JSON object with one entry per kernel (ks_inner, ntt_fwd,
ntt_inv, ks_modup, ks_moddown, sub_scale, lut_sum, lut_sum_dense;
launches summed over the slice,
the bench legs, the large-ring legs, the flagship, the zeta legs and every
rank of the mesh phase) and per instance (ks_modup_chunks,
ks_moddown_chunks: launches of the key-switch phase 3b; ntt_cluster16,
ntt_two_pass: of the large-ring phase 10b, the paths that reach them); the
last line is
{"ok": true, "device": {...}}.  Needs one CUDA card; imports nothing of
JAX or of the reference package.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from aesfhe_tpu_torch import (bench, bootstrap, kernels, legs_variants,
                              run_full_aes, zeta_trace)
from aesfhe_tpu_torch.aes_tables import aes128_partial
from aesfhe_tpu_torch.core import (ks_inner, ks_legs, lut_sum, ntt, ops_impl,
                                   rns)
from aesfhe_tpu_torch.core.ciphertext import Ciphertext
from aesfhe_tpu_torch.core.engine import Engine
from aesfhe_tpu_torch.core.params import CKKSParams, get_params
from aesfhe_tpu_torch.legs_variants import graph_ms
from aesfhe_tpu_torch.ops.bitplane import BitState
from aesfhe_tpu_torch.ops.xor_service import EngineWrapper, XORConfig
from aesfhe_tpu_torch.ops.zeta import phase_error, split_nibbles
from aesfhe_tpu_torch.parallel import comm_ledger, launch
from aesfhe_tpu_torch.parallel.comm_ledger import allreduce_wire_bytes
from aesfhe_tpu_torch.parallel.dist_ntt import local_tables
from aesfhe_tpu_torch.parallel.mesh import (digit_pad, make_mesh,
                                            mesh_device, replicated)
from aesfhe_tpu_torch.pipeline import AESFHE128, AESFHE128Bitsliced

PROFILE = "prod_boot"
# Rounds run from the uniform work level ROUND_DEPTH * ROUNDS + 1, as the
# flagship script (scripts/run_full_aes.py) drops its state to one work
# level.  Above level ~29 the prod_boot rescale primes stray up to 25% from
# Delta, the round's exact scale tracking compounds that through the
# MixColumns product tree, and the cleanse's coefficient scale rounds to
# nothing: a third round (from level 43) does not decrypt.  The reference
# fails there alike: tests/test_torch_drift.py runs that round on
# prod_boot's primes through both packages, residue for residue.
ROUNDS = 2
# The flagship runs all 10 rounds (36 bootstraps): on an H100 a steady
# bootstrap takes ~2.8 s, so keygen and the 10 rounds need ~3 minutes and
# the whole script stays well inside its 1200 s limit (PERF.md).
FLAGSHIP_ROUNDS = 10
SEED = 0
KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")   # FIPS-197 C.1
HBM_BYTES_PER_S = 3.35e12        # H100 SXM published memory rate
# 32-bit integer multiplies (IMAD, IMAD.HI) per second: 64 per SM per clock
# on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs at the 1.98 GHz boost clock behind the
# published 67 TFLOP/s float32 rate (128 lanes per SM)
INT32_MULS_PER_S = 132 * 64 * 1.98e9
MESH_SEED = SEED + 4
# bench's bitplane and zeta legs: the root bench.py's default profile; the
# large-ring phase runs them at AESFHE_BENCH_LOGN=18 (the 16-block NTT) and
# the zeta leg at 2^17 for its phase error's trend
BENCH_LOGN, BENCH_LEVELS, BENCH_ITERS = 16, 16, 3
LARGE_LOGN = 18
# one relinearization, rotation and rescale at N=2^20 on each of two sets
# the reference builds: LARGE_KS (scale 2^29, K = 2, a dense secret), whose
# noise passes its scale there, as the reference's does
# (tests/test_torch_large_ring.py), and LARGE_HP, prod_hp's scale 2^52 and
# K = 6 cut to 6 levels, which decodes; the NTT kernels' largest ring,
# 2^ntt.MAX_LOGN, in the kernel phase
LARGE_KS = dict(n=1 << 20, max_level=6, scale_bits=29, num_special_primes=2)
LARGE_HP = dict(n=1 << 20, max_level=6, scale_bits=52, num_special_primes=6)
ZETA_ROUNDS = 10
# Parameter sets past one k-step of the conversion kernels (8 primes) and
# the chain of primes below 2^16: legs_variants.SETS (9, 10, 16 and 20
# special primes, digits of 9, 16 and 21 limbs; two and three chunks), its
# (top, middle) levels, and SMALL_PRIMES at N=2^10 (its tables held at
# 2^16 columns in the kernel phase).
WIDE_SETS = legs_variants.SETS
WIDE_MIDDLE = legs_variants.SETS_MIDDLE
SMALL_PRIMES = legs_variants.SMALL_PRIMES


T0 = time.perf_counter()


def phase(name: str):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
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


zero_launches = kernels.zero_launches      # just before a main path runs
read_launches = kernels.launch_counts


# the LUT sums, which a path of key-switches alone does not run
NO_LUT_SUMS = ("lut_sum", "lut_sum_dense")


def check_launches(where: str, counts: dict, instances=(), variants=None,
                   absent=()):
    """Print a main path's kernel launches: every kernel must have run but
    those the path need not reach (`absent`: NO_LUT_SUMS), and
    the mod-down once per key-switch, as the inner product; the instances
    of kernels.VARIANTS (`variants`, read with `counts`; by default this
    process's counts now: the chunked conversions, the 16-block and the
    two-pass NTT) not at all, unless named in `instances`."""
    if variants is None:
        variants = kernels.variant_counts()
    print(f"{where}: kernel launches {counts}, instances {variants}",
          flush=True)
    if any(v <= 0 for k, v in counts.items() if k not in absent) or \
            set(counts) != set(kernels.COUNTERS):
        raise AssertionError(f"{where}: not every kernel was launched: "
                             f"{counts}")
    if counts["ks_moddown"] != counts["ks_inner"]:
        raise AssertionError(f"{where}: {counts['ks_moddown']} mod-downs "
                             f"for {counts['ks_inner']} inner products")
    if any(v for k, v in variants.items() if k not in instances):
        raise AssertionError(f"{where}: an instance ran that this path "
                             f"does not reach: {variants}")


def add_launches(total: dict, counts: dict):
    for k in total:
        total[k] += counts[k]


I32, I64 = torch.int32, torch.int64
# (input dtype, output dtype, Montgomery conversions folded in)
NTT_VARIANTS = [(i, o, m) for i in (I32, I64) for o in (I32, I64)
                for m in (False, True)]


def _dt(d) -> str:
    return "int32" if d == I32 else "int64"


def ntt_case(label: str, rows: ntt.NTTRows, make, timed,
             canonical: bool = True) -> list:
    """Both NTT kernels against their plain versions on the card
    (torch.equal) in every variant of the contract: make(dtype) gives the
    input (int64 values; int32 only when canonical residues), every
    (input dtype, output dtype, to_mont/from_mont) combination is held
    equal, and each variant in `timed` is timed with CUDA events beside
    its plain version and its bound: the larger of the bytes in and out
    (4 a word int32, 8 int64) over the memory rate and of the 32-bit
    multiplies (the to_mont product included) over their rate."""
    x = make(I64)
    *lead, L, N = x.shape
    B = int(np.prod(lead)) if lead else 1
    out = []
    for name, fn, plain in (
            ("ntt_fwd", ntt.ntt_fwd,
             lambda xi, m, o: ntt.ntt_fwd_plain(
                 xi, rows.w(), rows.q, rows.r if m else None, o)),
            ("ntt_inv", ntt.ntt_inv,
             lambda xi, m, o: ntt.ntt_inv_plain(
                 xi, rows.wi(), rows.q, rows.ninv, rows.rinv if m else None,
                 o))):
        err = 0
        for ind, outd, mont in NTT_VARIANTS:
            if ind == I32 and not canonical:
                continue
            xi = make(ind)
            got = fn(xi, rows, mont, outd)
            want = plain(xi, mont, outd)
            torch.cuda.synchronize()
            e = int((got.long() - want.long()).abs().max())
            err = max(err, e)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{name} disagrees with its plain version at {label}, "
                    f"{_dt(ind)} -> {_dt(outd)}, mont={mont}: max |err| {e}")
        for ind, outd, mont in timed:
            xi = make(ind)
            ms = cuda_ms(lambda: fn(xi, rows, mont, outd))
            plain_ms = cuda_ms(lambda: plain(xi, mont, outd), reps=3)
            by_bytes = ntt.bytes_moved(B, L, N, xi.element_size(),
                                       4 if outd == I32 else 8) \
                / HBM_BYTES_PER_S * 1e3
            by_ops = ntt.int_mults(B, L, N, name == "ntt_inv", mont) \
                / INT32_MULS_PER_S * 1e3
            bound_ms = max(by_bytes, by_ops)
            bound_by = "bytes" if by_bytes >= by_ops else "operations"
            dtype = f"{_dt(ind)}->{_dt(outd)}"
            print(f"{name} {label} [{B}, {L}, {N}] {dtype}"
                  f"{' mont' if mont else ''}: equal, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                  f"{bound_by} ({bound_ms / ms:.0%} of bound)", flush=True)
            out.append(dict(name=name, shape=label, B=B, L=L, N=N,
                            dtype=dtype, mont=mont, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by))
    return out


def ntt_build_info():
    """The NTT kernels' registers (nvcc -Xptxas -v, build/ntt.ptxas.log)
    and their launch: dynamic shared memory, blocks per SM, clusters."""
    log = kernels.BUILD_DIR / "ntt.ptxas.log"
    entry = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and entry is not None:
            kind = next(k for k in ("ntt_cluster16", "ntt_cluster",
                                    "ntt_cols", "ntt_runs", "ntt_block")
                        if k in entry)
            print(f"ptxas {kind} {entry}: {line.split(':', 1)[1].strip()}",
                  flush=True)
    for logn in (8, 15, 16, 17, 18, 19, 20, ntt.MAX_LOGN):
        print(f"NTT launch at N=2^{logn}: {ntt.occupancy(logn)}", flush=True)


def ntt_cases(params, rng, dev) -> list:
    """The NTT kernels at the main path's shapes (prod_boot, N=2^16), each
    in every variant of the contract and timed in the main path's: a
    key-switch decomposition (J digits over q_0..q_level | specials) at the
    top level and, over a non-contiguous row set, at the slice's first
    level, int32 in and out with the Montgomery factors folded in (and the
    top level also int64 in and out, the earlier contract); a rescale's two
    components over 55 rows, int64; one row (a rescale's dropped limb),
    with int64 inputs outside [0, q) that the kernels reduce on load; the
    pair rescale's two dropped limbs as a strided int32 view; the DistNTT's
    size-256 transforms [R, L, 256] of a D = 2 mesh, int64; one row of
    2^17; and the fused round trips ntt_inv(ntt_fwd(x))."""
    ntt_build_info()
    tabs = ops_impl.DeviceTables(params, dev)
    qa = np.asarray(params.all_primes, dtype=np.int64)
    N = params.n
    fused = [(I32, I32, True)]

    def residues(shape, rows):
        x = rng.integers(0, 1 << 62, shape) % qa[rows].reshape(-1, 1)
        return torch.as_tensor(x, device=dev)

    def as_is(x):
        return lambda d: x.to(d)

    cases = []
    for level in (params.top_level, AESFHE128Bitsliced.ROUND_DEPTH * ROUNDS
                  + 1):
        rows = ops_impl._rows(params, level, True)
        J = len(params.ks_tables(level)["groups"])
        gaps = "contiguous" if np.all(np.diff(rows) == 1) else "gapped"
        cases += ntt_case(
            f"decompose level {level} J={J} ({gaps} rows)",
            tabs.ntt.rows(rows), as_is(residues((J, len(rows), N), rows)),
            fused + ([(I64, I64, False)] if level == params.top_level
                     else []))
    full = np.arange(params.num_q)
    x55 = residues((2, params.num_q, N), full)
    cases += ntt_case("rescale/ModRaise 2 x 55 rows", tabs.ntt.rows(full),
                      as_is(x55), [(I64, I64, True)])
    last = [params.top_level]
    spread = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (2, 1, N)),
                             device=dev)
    cases += ntt_case("one row, inputs outside [0, q)", tabs.ntt.rows(last),
                      as_is(spread), [(I64, I64, True)], canonical=False)
    pair = [params.top_level - 1, params.top_level]
    cases += ntt_case("pair rescale's limbs (strided view)",
                      tabs.ntt.rows(pair), lambda d: x55.to(d)[:, -2:],
                      [(I32, I64, True)])
    A = 1 << ((N.bit_length() - 1) // 2)
    small = ntt.DeviceNTT(*local_tables(params, A, params.num_q),
                          params.q_primes, dev).rows(full)
    xd = residues((A // 2, params.num_q, A), full)
    cases += ntt_case(f"DistNTT size {A} (D=2)", small, as_is(xd),
                      [(I64, I64, False)])
    n17 = 2 * N
    p17 = tuple(rns.find_ntt_primes(30, 2 * n17, 2))
    t17 = ntt.NTTTables(n17, p17)
    big = ntt.DeviceNTT(t17.w, t17.wi, t17.ninv, t17.q, dev).rows([1])
    x17 = torch.as_tensor(rng.integers(0, p17[1], (2, 1, n17)), device=dev)
    cases += ntt_case("one row of 2^17", big, as_is(x17), fused)
    for rows, x in ((tabs.ntt.rows(full), x55), (small, xd), (big, x17)):
        back = ntt.ntt_inv(ntt.ntt_fwd(x.int(), rows, True, I32), rows,
                           True, I32)
        back64 = ntt.ntt_inv(ntt.ntt_fwd(x, rows), rows)
        if not (torch.equal(back, x.int()) and torch.equal(back64, x)):
            raise AssertionError(f"ntt_inv(ntt_fwd(x)) != x at "
                                 f"{tuple(x.shape)}")
    print("round trips ntt_inv(ntt_fwd(x)) = x (int32 with the Montgomery "
          "factors folded in, and int64) at [2, 55, 65536], "
          "[128, 55, 256] and [2, 1, 131072]", flush=True)
    return cases


def large_ntt_cases(rng, dev) -> list:
    """The NTT above 2^17 (2^18: ntt_cluster16, one launch on 16 blocks a
    row; from 2^19 the two-pass NTT, two launches a transform) in every
    variant of the contract, timed in the main path's: bench LOGN=18's
    key-switch decomposition (J digits over q_0..q_top | specials) int32 in
    and out with the Montgomery factors folded in, and int64 in and out; a
    rescale's two components over its 17 q-rows, int64; one row with int64
    inputs outside [0, q); a pair of limbs as a strided view; one row each
    of 2^19, 2^20 and 2^MAX_LOGN (the kernels' largest ring); the round
    trips ntt_inv(ntt_fwd(x)) = x at each ring."""
    bp = bench.bench_params(LARGE_LOGN, BENCH_LEVELS)
    tabs = ops_impl.DeviceTables(bp, dev)
    qa = np.asarray(bp.all_primes, dtype=np.int64)
    N, top = bp.n, bp.top_level
    fused = [(I32, I32, True)]

    def residues(shape, rows):
        x = rng.integers(0, 1 << 62, shape) % qa[rows].reshape(-1, 1)
        return torch.as_tensor(x, device=dev)

    def as_is(x):
        return lambda d: x.to(d)

    rows = ops_impl._rows(bp, top, True)
    J = len(bp.ks_tables(top)["groups"])
    cases = ntt_case(f"bench 2^18 decompose level {top} J={J}",
                     tabs.ntt.rows(rows),
                     as_is(residues((J, len(rows), N), rows)),
                     fused + [(I64, I64, False)])
    full = np.arange(bp.num_q)
    xr = residues((2, bp.num_q, N), full)
    cases += ntt_case(f"bench 2^18 rescale 2 x {bp.num_q} rows",
                      tabs.ntt.rows(full), as_is(xr), [(I64, I64, True)])
    spread = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (2, 1, N)),
                             device=dev)
    cases += ntt_case("2^18 one row, inputs outside [0, q)",
                      tabs.ntt.rows([top]), as_is(spread), [(I64, I64, True)],
                      canonical=False)
    cases += ntt_case("2^18 pair of limbs (strided view)",
                      tabs.ntt.rows([top - 1, top]),
                      lambda d: xr.to(d)[:, -2:], [(I32, I64, True)])
    trips = [(tabs.ntt.rows(full), xr)]
    for logn in (19, 20, ntt.MAX_LOGN):
        n = 1 << logn
        p = tuple(rns.find_ntt_primes(30, 2 * n, 1))
        t = ntt.NTTTables(n, p)
        big = ntt.DeviceNTT(t.w, t.wi, t.ninv, t.q, dev).rows([0])
        x = torch.as_tensor(rng.integers(0, p[0], (1, 1, n)), device=dev)
        cases += ntt_case(f"one row of 2^{logn}", big, as_is(x), fused)
        trips.append((big, x))
    for rows, x in trips:
        back = ntt.ntt_inv(ntt.ntt_fwd(x.int(), rows, True, I32), rows,
                           True, I32)
        back64 = ntt.ntt_inv(ntt.ntt_fwd(x, rows), rows)
        if not (torch.equal(back, x.int()) and torch.equal(back64, x)):
            raise AssertionError(f"ntt_inv(ntt_fwd(x)) != x at "
                                 f"{tuple(x.shape)}")
    print(f"round trips ntt_inv(ntt_fwd(x)) = x (int32 with the Montgomery "
          f"factors folded in, and int64) at "
          f"{[tuple(x.shape) for _, x in trips]}", flush=True)
    del trips, tabs
    torch.cuda.empty_cache()
    return cases


def ks_inner_case(params, level: int, key_cap, rng, dev):
    """Kernel vs plain version for one key-switch shape of the slice:
    digits active at `level` against a key stored full (key_cap=None) or
    capped at key_cap, with more digits than the switch uses when capped."""
    rows = ops_impl._key_rows(params, level, key_cap)
    J = len(params.ks_tables(level)["groups"])
    if key_cap is None:
        dnum, Mk = params.dnum, params.L_tot
    else:
        dnum = len(params.ks_tables(key_cap)["groups"])
        Mk = key_cap + 1 + params.num_special
    basis = ops_impl._rows(params, level, True)
    qs = np.asarray(params.all_primes, dtype=np.int64)[basis]
    qk = np.ones(Mk, dtype=np.int64)
    qk[rows] = qs
    qk[qk == 1] = params.q_primes[0]          # rows this switch does not read
    N = params.n
    d = rng.integers(0, 1 << 62, (J, len(rows), N)) % qs[:, None]
    kb, ka = (rng.integers(0, 1 << 62, (dnum, Mk, N)) % qk[:, None]
              for _ in range(2))
    qinv = [rns.montgomery_consts(int(q))[0] for q in qs]

    def dev_u32(a):
        return rns.narrow(torch.as_tensor(np.asarray(a, dtype=np.int64),
                                          device=dev))

    t = [dev_u32(a) for a in (d, kb, ka, qs, qinv)]
    args = (t[0], t[1], t[2], rows, t[3], t[4])
    got = ks_inner.ks_inner(*args)
    want = ks_inner.ks_inner_plain(*args)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"ks_inner disagrees with its plain version at "
                             f"level {level}, cap {key_cap}: max |err| {err}")
    ms = cuda_ms(lambda: ks_inner.ks_inner(*args))
    plain_ms = cuda_ms(lambda: ks_inner.ks_inner_plain(*args), reps=5)
    bound_ms = ks_inner.bytes_moved(J, len(rows), N) / HBM_BYTES_PER_S * 1e3
    print(f"ks_inner level={level} cap={key_cap} J={J} M={len(rows)} "
          f"Mk={Mk} N={N}: equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_ms / ms:.0%} of bound)",
          flush=True)
    return dict(level=level, J=J, M=len(rows), cap=key_cap, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


def ks_inner_shard_case(params, level: int, d: int, rank: int, rng, dev):
    """Kernel vs plain version at one mesh rank's shape: the J = pad/D
    digits [rank*J, (rank+1)*J) of a switch at `level`, against the rank's
    key shard (full layout); digits past the level's active ones are zero
    in both, as ks_decompose and key_shard pad them."""
    pad = digit_pad(params.dnum, d)
    J = pad // d
    j0 = rank * J
    live = len(params.ks_tables(level)["groups"])
    rows = ops_impl._key_rows(params, level, None)
    basis = ops_impl._rows(params, level, True)
    qs = np.asarray(params.all_primes, dtype=np.int64)[basis]
    qk = np.asarray(params.all_primes, dtype=np.int64)
    N = params.n
    dig = rng.integers(0, 1 << 62, (J, len(rows), N)) % qs[:, None]
    kb, ka = (rng.integers(0, 1 << 62, (J, params.L_tot, N)) % qk[:, None]
              for _ in range(2))
    zero = [j for j in range(J) if j0 + j >= live]
    for a in (dig, kb, ka):
        a[zero] = 0
    qinv = [rns.montgomery_consts(int(q))[0] for q in qs]
    t = [rns.narrow(torch.as_tensor(np.asarray(a, dtype=np.int64),
                                    device=dev))
         for a in (dig, kb, ka, qs, qinv)]
    args = (t[0], t[1], t[2], rows, t[3], t[4])
    got = ks_inner.ks_inner(*args)
    want = ks_inner.ks_inner_plain(*args)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"ks_inner disagrees with its plain version on "
                             f"rank {rank} of {d} at level {level}: max "
                             f"|err| {err}")
    if len(zero) == J and bool(got.any()):
        raise AssertionError("ks_inner on an all-zero shard is not zero")
    ms = cuda_ms(lambda: ks_inner.ks_inner(*args))
    plain_ms = cuda_ms(lambda: ks_inner.ks_inner_plain(*args), reps=5)
    bound_ms = ks_inner.bytes_moved(J, len(rows), N) / HBM_BYTES_PER_S * 1e3
    print(f"ks_inner mesh shard D={d} rank={rank} level={level} J={J} "
          f"(zero digits {len(zero)}) M={len(rows)} N={N}: equal, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_ms / ms:.0%} of bound)", flush=True)
    return dict(level=level, J=J, M=len(rows), mesh=f"rank {rank} of {d}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


def legs_case(name: str, label: str, run, plain, work) -> dict:
    """One of ks_legs' kernels against its plain version on the card
    (torch.equal), timed beside the plain version and the bound: the larger
    of work's bytes over the memory rate and its 32-bit multiplies over
    their rate.  The kernel is timed as graph replays (graph_ms, "ms"; its
    eager calls, host enqueue included, as "eager_ms")."""
    got = run()
    want = plain()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{label}: max |err| {err}")
    ms = graph_ms(run)
    eager_ms = cuda_ms(run)
    plain_ms = cuda_ms(plain, reps=3)
    nbytes, mults = work
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = mults / INT32_MULS_PER_S * 1e3
    bound_ms = max(by_bytes, by_ops)
    bound_by = "bytes" if by_bytes >= by_ops else "operations"
    print(f"{name} {label} {tuple(got.shape)}: equal, kernel {ms:.4f} ms "
          f"(eager calls {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / ms:.0%} of bound)",
          flush=True)
    return dict(name=name, shape=label, max_abs_err=err, ms=ms,
                eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


_RESIDENCY: set = set()


def chunk_residency(name: str, nch: int, group: int, M: int):
    """Print, once a shape, a chunked launch's threads, dynamic shared
    memory and resident blocks an SM (legs_variants.occupancy)."""
    if (name, nch, group, M) in _RESIDENCY:
        return
    _RESIDENCY.add((name, nch, group, M))
    lib = ks_legs._library()
    threads, smem = legs_variants.chunk_launch(lib, True, name, nch, M)
    inst = f"{name}<{ks_legs.chunk_instance(nch, group)}>"
    per_sm = legs_variants.occupancy(kernels.library_path("ks_legs"),
                                     {inst: (threads, smem)})[inst]
    print(f"{inst} nch={nch} group={group} M={M}: {threads} threads, {smem} "
          f"bytes of shared memory, {per_sm} blocks an SM", flush=True)


def half_integer_specials(params, level: int, B: int, rng, dev,
                          n: int | None = None):
    """The special rows d [B, K, n] (plain, canonical; n = N by default) of
    a mod-down input whose float32 sums sum_i y_i/p_i lie within a few
    1e-8 of a half-integer, where the summation order decides v_hat's
    rounding
    (tests/test_torch_core.py::test_mod_down_vhat_at_half_integers)."""
    K, n = params.num_special, n or params.n
    ps = np.asarray(params.special_primes, dtype=np.int64)
    y = rng.integers(0, 1 << 62, (B, K, n)) % ps[:, None]
    rest = (y[:, 1:] / ps[1:, None]).sum(1)
    y0 = np.round((np.ceil(rest - 0.5) + 0.5 - rest) * ps[0]).astype(np.int64)
    y[:, 0] = np.clip(y0 + rng.integers(-40, 41, (B, n)), 0, ps[0] - 1)
    inv_w = np.asarray(params.md_tables(level)["inv_w"], dtype=np.int64)
    w = np.array([pow(int(a), -1, int(p)) for a, p in zip(inv_w, ps)])
    return torch.as_tensor((y * w[:, None]) % ps[:, None], device=dev).int()


def ks_legs_cases(params, rng, dev) -> list:
    """ks_modup, ks_moddown and sub_scale (csrc/ks_legs.cu; their ptxas
    registers and spills) against their plain versions at the main path's
    shapes: the top level (J = 7 digits over M = 63 rows, two components),
    levels 28 and 24 (J = 4), bench's widest switch (level 15, K = 4);
    ks_modup over the mesh's digit ranges at the top level for D = 2 and 4
    (the last digit padding) and over a range of padding only; both
    conversions on byte-extreme inputs (every y = the largest residue with
    three 0xFF bytes, and a per-word mix of that, q - 1 and 0) at the top
    level and bench's; ks_moddown on inputs at float32 half-integers of
    v_hat's sum for K = 8 and K = 4; sub_scale on strided views (a
    mod-down's q rows of [2, M, N], a rescale's first l rows of
    [2, l+1, N]).  Then the conversions past one k-step and over primes
    below 2^16 (`wide_params`) at their top and middle levels, on random,
    byte-extreme and half-integer inputs, each named by the instance it
    launches (ks_modup_chunks, ks_moddown_chunks past 8 primes)."""
    log = kernels.BUILD_DIR / "ks_legs.ptxas.log"
    entry = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif ("registers" in line or "spill" in line) and entry is not None:
            print(f"ptxas {entry}: {line.split(':', 1)[-1].strip()}",
                  flush=True)
    bp = bench.bench_params(BENCH_LOGN, BENCH_LEVELS)
    cases = []

    def residues(p, rows, lead, n=None):
        qs = np.asarray(p.all_primes, dtype=np.int64)[np.asarray(rows)]
        x = rng.integers(0, 1 << 62, tuple(lead) + (len(rows), n or p.n))
        return torch.as_tensor(x % qs[:, None], device=dev).int()

    def picks(rows, n, mixed):
        return rng.integers(0, 3, (rows, n)) if mixed else \
            np.full((rows, n), 2)

    def modup(p, level, tag, j0=0, j1=None, c=None, n=None):
        tab = ks_legs.ModupTables(p, level, dev)
        j1 = tab.J if j1 is None else j1
        if c is None:
            c = residues(p, ops_impl._rows(p, level, False), (), n)
        live = max(0, min(j1, tab.J) - j0)
        work = ks_legs.modup_work(sum(tab.dig[j0:j0 + live, 1].tolist()),
                                  j1 - j0, tab.M, c.shape[-1])
        name = "ks_modup_chunks" if tab.nch > 1 else "ks_modup"
        if tab.nch > 1:
            chunk_residency(name, tab.nch, tab.group, tab.M)
        out = legs_case(name, f"{tag} digits [{j0}, {j1}) of {tab.J}",
                        lambda: ks_legs.ks_modup(c, tab, j0, j1),
                        lambda: ks_legs.ks_modup_plain(c, tab, j0, j1), work)
        if live < j1 - j0 and bool(ks_legs.ks_modup(c, tab, j0, j1)
                                   [live:].any()):
            raise AssertionError("ks_modup: a padded digit is not zero")
        return out

    def modup_extreme(p, level, mixed, tag="", n=None):
        inv = [0] * (level + 1)
        for g in p.ks_tables(level)["groups"]:
            for i, w in zip(g["limbs"], g["inv_w"]):
                inv[i] = w
        c = ks_legs.byte_extremes(p.q_primes[:level + 1], inv,
                                  picks(level + 1, n or p.n, mixed))
        return modup(p, level, f"{tag}level {level} byte-extreme "
                     f"{'mix' if mixed else '0xFF'}",
                     c=torch.as_tensor(c, device=dev).int())

    def moddown(p, level, tag, d=None, n=None):
        tab = ks_legs.ModdownTables(p, level, dev)
        if d is None:
            d = residues(p, range(p.num_q, p.L_tot), (2,), n)
        work = ks_legs.moddown_work(d.shape[0], tab.K, tab.R, d.shape[-1])
        name = "ks_moddown_chunks" if tab.nch > 1 else "ks_moddown"
        if tab.nch > 1:
            chunk_residency(name, tab.nch, tab.group, tab.R)
        return legs_case(name, f"{tag} K={tab.K}",
                         lambda: ks_legs.ks_moddown(d, tab),
                         lambda: ks_legs.ks_moddown_plain(d, tab), work)

    def moddown_extreme(p, level, mixed, tag="", n=None):
        K = p.num_special
        d = np.stack([ks_legs.byte_extremes(
            p.special_primes, p.md_tables(level)["inv_w"],
            picks(K, n or p.n, mixed)) for _ in range(2)])
        return moddown(p, level, f"{tag}level {level} byte-extreme "
                       f"{'mix' if mixed else '0xFF'}",
                       torch.as_tensor(d, device=dev).int())

    def sub_scale(p, level, tag, rows, n=None):
        wide = residues(p, range(rows), (2,), n)
        x = wide[:, :level + 1]
        y = residues(p, range(level + 1), (2,), n)
        tab = ks_legs.ModdownTables(p, level, dev).pinv
        return legs_case("sub_scale", f"{tag}, x a [2, {level + 1}] view of "
                         f"[2, {rows}]", lambda: ks_legs.sub_scale(x, y, tab),
                         lambda: ks_legs.sub_scale_plain(x, y, tab),
                         ks_legs.sub_scale_work(2, level + 1, x.shape[-1]))

    top = params.top_level
    K = params.num_special
    for level in (top, 28, 24):
        cases.append(modup(params, level, f"level {level}"))
    cases.append(modup(bp, BENCH_LEVELS - 1,
                       f"bench level {BENCH_LEVELS - 1}"))
    for d in (2, 4):
        pad = digit_pad(params.dnum, d)
        cases.append(modup(params, top, f"level {top} mesh D={d} last rank",
                           pad - pad // d, pad))
    cases.append(modup(params, 15, "level 15 mesh D=2 rank 1 (padding only)",
                       digit_pad(params.dnum, 2) // 2,
                       digit_pad(params.dnum, 2)))
    for level in (top, 28, 24):
        cases.append(moddown(params, level, f"level {level}"))
    cases.append(moddown(bp, BENCH_LEVELS - 1,
                         f"bench level {BENCH_LEVELS - 1}"))
    cases.append(moddown(params, top, f"level {top} half-integer v_hat sums",
                         half_integer_specials(params, top, 2, rng, dev)))
    cases.append(moddown(bp, BENCH_LEVELS - 1,
                         f"bench level {BENCH_LEVELS - 1} half-integer v_hat "
                         f"sums", half_integer_specials(
                             bp, BENCH_LEVELS - 1, 2, rng, dev)))
    for p, level in ((params, top), (bp, BENCH_LEVELS - 1)):
        for mixed in (False, True):
            cases.append(modup_extreme(p, level, mixed))
            cases.append(moddown_extreme(p, level, mixed))
    for level in (top, 28, 24):
        cases.append(sub_scale(params, level, f"mod-down level {level}",
                               level + 1 + K))
    cases.append(sub_scale(params, top - 1, f"rescale level {top}", top + 1))
    cases.append(sub_scale(bp, BENCH_LEVELS - 1,
                           f"bench mod-down level {BENCH_LEVELS - 1}",
                           BENCH_LEVELS + bp.num_special))
    n = 1 << 16
    for name in (*WIDE_SETS, "scale 2^14"):
        p = wide_params(name)
        middle = WIDE_MIDDLE.get(name, p.top_level // 2)
        for level in (p.top_level, middle):
            tag = f"{name} "
            cases.append(modup(p, level, f"{tag}level {level}", n=n))
            cases.append(moddown(p, level, f"{tag}level {level}", n=n))
            cases.append(moddown(p, level, f"{tag}level {level} half-integer "
                                 f"v_hat sums", half_integer_specials(
                                     p, level, 2, rng, dev, n)))
            for mixed in (False, True):
                cases.append(modup_extreme(p, level, mixed, tag, n))
                cases.append(moddown_extreme(p, level, mixed, tag, n))
        if name == "scale 2^14":
            cases.append(sub_scale(p, p.top_level, f"{tag}mod-down level "
                                   f"{p.top_level}", p.L_tot, n))
    return cases


_WIDE: dict = {}


def lut_sum_cases(params, rng, dev) -> list:
    """Both LUT-sum kernels (csrc/lut_sum.cu) against their plain versions
    at the main path's shapes, timed as legs_case times the legs: the
    scalar sum at EvalMod's Paterson-Stockmeyer leaves (K = 7 terms of
    [2, 42, 2^16]) and at the flagship rounds' work level (K = 16, [2, 16]),
    the dense sum at CoeffToSlot's first group (K = 8 at the top level,
    [2, 55], its plaintext stack [8, 55]).  A term costs 3 32-bit multiplies
    a word (Shoup) or 4 (REDC)."""
    tabs = ops_impl.DeviceTables(params, dev)
    N = params.n
    out = []
    for name, K, D, L in (("lut_sum", 7, 2, 42), ("lut_sum", 16, 2, 16),
                          ("lut_sum_dense", 8, 2, params.top_level + 1)):
        tr = tabs.rows(range(L))
        qs = np.asarray(params.q_primes[:L], dtype=np.int64)[:, None]

        def residues(lead):
            return rns.narrow(torch.as_tensor(
                rng.integers(0, 1 << 62, (*lead, L, N)) % qs, device=dev))

        x = residues((K, D))
        dense = name == "lut_sum_dense"
        if dense:
            pts = residues((K,))
            run = lambda: lut_sum.lut_sum_dense(x, pts, tr)
            plain = lambda: lut_sum.lut_sum_dense_plain(x, pts, tr.q,
                                                        tr.rinv)
        else:
            w = rng.integers(0, 1 << 62, (K, L, 2)) % qs
            sh = np.vectorize(rns.shoup_precompute)(w, qs[None])
            consts = rns.narrow(torch.as_tensor(np.stack(
                [w[..., 0], sh[..., 0], w[..., 1], sh[..., 1]], -1),
                device=dev))
            run = lambda: lut_sum.lut_sum(x, consts, tabs.xhalf_sign_neg, tr)
            plain = lambda: lut_sum.lut_sum_plain(x, consts,
                                                  tabs.xhalf_sign_neg, tr.q)
        out.append(legs_case(
            name, f"K={K} [{D}, {L}, 2^{N.bit_length() - 1}]", run, plain,
            (lut_sum.bytes_moved(K, D, L, N, dense),
             K * D * L * N * (4 if dense else 3))))
    torch.cuda.empty_cache()
    return out


def wide_params(name: str) -> CKKSParams:
    """WIDE_SETS[name] or ("scale 2^14") SMALL_PRIMES, built once."""
    if name not in _WIDE:
        _WIDE[name] = CKKSParams(**WIDE_SETS.get(name, SMALL_PRIMES))
    return _WIDE[name]


def keyswitch_check(name: str, p: CKKSParams, decodes: bool = True):
    """One relinearization (of a product, which the multiplication
    rescales first) and one rotation by one slot at p on the card, from
    seeded keys: every key-switch kernel launched (one mod-down per inner
    product), the chunked conversions exactly where a digit at that level
    or the special set has more than 8 primes, the 16-block NTT exactly
    where N = 2^18 and the two-pass NTT where N >= 2^19, and the results
    decrypted against the encoded values
    (x uniform in [-1, 1], in [-256, 256] at scale 2^14, whose fresh noise
    is ~1), each decode error within 5% of the largest value when
    `decodes` (else printed only: the set's noise passes its scale; then
    the same three operations at level 2 are held residue for residue
    against the plain versions on the host, plain_keyswitch).  Returns the
    instances' launches (kernels.VARIANTS) and the decode errors."""
    t0 = time.perf_counter()
    eng = Engine(p, device="cuda", rng=np.random.default_rng(SEED))
    sk = eng.create_secret_key()
    pk = eng.create_public_key(sk)
    rlk = eng.create_relinearization_key(sk)
    rot = eng.create_fixed_rotation_key(sk, [1])
    amp = 1.0 if p.scale_bits > 20 else 256.0
    x = np.random.default_rng(SEED + 2).uniform(-amp, amp, p.slot_count)
    ct = eng.encrypt(x, pk)
    sq = eng.multiply(ct, ct)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    sq = eng.relinearize(sq, rlk)
    r = eng.rotate(ct, rot, 1)
    torch.cuda.synchronize()
    ks_s = time.perf_counter() - t0
    counts = read_launches()
    chunked = kernels.variant_counts()
    check_launches(f"key-switch {name}", counts, tuple(kernels.VARIANTS),
                   chunked, absent=NO_LUT_SUMS)
    want = {"ks_modup_chunks": sum(
                ks_legs.ModupTables(p, lvl, "cpu").nch > 1
                for lvl in (sq.level, ct.level)),
            "ks_moddown_chunks": 2 * (p.num_special > ks_legs.CHUNK)}
    logn = p.n.bit_length() - 1
    if {k: chunked[k] for k in want} != want or \
            (chunked["ntt_two_pass"] > 0) != (logn >= ntt.TWO_PASS_MIN_LOGN) \
            or (chunked["ntt_cluster16"] > 0) != (logn == ntt.CLUSTER16_LOGN):
        raise AssertionError(f"key-switch {name}: instance launches "
                             f"{chunked}, expected {want}, the two-pass "
                             f"NTT exactly from 2^{ntt.TWO_PASS_MIN_LOGN} "
                             f"and the 16-block one exactly at "
                             f"2^{ntt.CLUSTER16_LOGN}")
    errs = {"relin": float(np.abs(eng.decrypt(sq, sk) - x * x).max()
                           / amp ** 2),
            "rotate": float(np.abs(eng.decrypt(r, sk) - np.roll(x, 1))
                            .max() / amp)}
    print(f"key-switch {name}: N={p.n}, {p.num_q} q primes "
          f"({min(q.bit_length() for q in p.q_primes)}-"
          f"{max(q.bit_length() for q in p.q_primes)} bits), K="
          f"{p.num_special}, digits {[len(g) for g in p.groups]}; "
          f"keygen and product {keygen_s:.2f} s, relinearize + rotate "
          f"{ks_s * 1e3:.1f} ms; decode error / max value: relinearized "
          f"square {errs['relin']:.3e}, rotation {errs['rotate']:.3e}",
          flush=True)
    if not all(np.isfinite(v) and (v < 0.05 or not decodes)
               for v in errs.values()):
        raise AssertionError(f"key-switch {name}: decode errors {errs}")
    if not decodes:
        plain_keyswitch(name, eng, ct, rlk, rot)
    del eng, sk, pk, rlk, rot, ct, sq, r
    torch.cuda.empty_cache()
    return chunked, errs


def plain_keyswitch(name: str, eng: Engine, ct, rlk, rot, level: int = 2):
    """ct dropped to `level`: its product (rescaled), the product
    relinearized and ct rotated by one slot, on the card and through the
    plain versions on the host (an Engine on the CPU, the same keys copied
    there), torch.equal step by step."""
    def cpu_key(k):
        return type(k)(k.b.cpu(), k.a.cpu(), k.cap)

    ceng = Engine(eng.params, device="cpu")
    keys = {"cuda": (rlk, rot),
            "cpu": (cpu_key(rlk), type(rot)({g: cpu_key(k) for g, k in
                                             rot.keys.items()}))}
    low = eng._drop(ct, level)
    outs = {}
    t0 = time.perf_counter()
    for dev, e, x in (("cuda", eng, low),
                      ("cpu", ceng, Ciphertext(low.data.cpu(), low.scale))):
        k_rl, k_rot = keys[dev]
        sq = e.multiply(x, x)
        outs[dev] = (sq, e.relinearize(sq, k_rl), e.rotate(x, k_rot, 1))
    for what, a, b in zip(("product", "relinearization", "rotation"),
                          outs["cuda"], outs["cpu"]):
        if not torch.equal(a.data.cpu(), b.data) or a.scale != b.scale:
            raise AssertionError(f"key-switch {name}: the {what} at level "
                                 f"{level} differs from the plain versions")
    print(f"key-switch {name}: at level {level} the product (rescaled), its "
          f"relinearization and the rotation equal the plain versions' on "
          f"the host residue for residue ({time.perf_counter() - t0:.1f} "
          f"s)", flush=True)


def keyswitch_phase() -> dict:
    """keyswitch_check at each of WIDE_SETS and SMALL_PRIMES; returns the
    instances' launches summed."""
    total = dict.fromkeys(kernels.VARIANTS, 0)
    for name in (*WIDE_SETS, "scale 2^14"):
        add_launches(total, keyswitch_check(name, wide_params(name))[0])
    return total


def mesh_rank(rank: int, world: int, profile: str, device_type: str,
              boots: int) -> dict:
    """One rank of the mesh phase (the module docstring, phase 9)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = make_mesh(1, world, device_type)
    dev = mesh_device(mesh)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    wrap = EngineWrapper(XORConfig(profile=profile, rotation_steps=(),
                                   device=dev, use_bootstrap=True),
                         rng=np.random.default_rng(MESH_SEED))
    wrap.rot_key.keys.update(wrap.boot_key.rot.keys)
    aes = AESFHE128Bitsliced(wrap, KEY)
    mctx = wrap.ctx.on_mesh(mesh)
    mwrap = EngineWrapper(ctx=mctx)
    maes = AESFHE128Bitsliced(mwrap, KEY)
    meng = mwrap.engine
    sync()
    keygen_s = time.perf_counter() - t0
    params = meng.params
    sc = meng.slot_count
    state = run_full_aes.make_state(sc, SEED + 5)
    work = maes.ROUND_DEPTH + 1
    st = [meng._drop(b, work) for b in maes.encrypt_state(state).bits]
    st = BitState([Ciphertext(replicated(mesh, b.data.contiguous()), b.scale)
                   for b in st])
    if rank != 0:
        del aes, wrap                  # keep only the digit shards
        if cuda:
            torch.cuda.empty_cache()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    meng.reset_counters()
    meng.dks.levels.clear()
    zero_launches()
    with comm_ledger.recording() as led:
        t0 = time.perf_counter()
        out = run_full_aes.run_round(maes, st, 1, 1)
        sync()
        round_s = time.perf_counter() - t0
        zs, boot_s = _refresh_pairs(mwrap, out, sync, boots)
    counts = read_launches()
    launches = counts["ks_inner"]
    counters = dict(meng.counters)
    levels = dict(meng.dks.levels)
    K, N = params.num_special, params.n
    predicted = sum(c * 2 * (lvl + 1 + K) * N * 8 for lvl, c in levels.items())
    res = dict(rank=rank, keygen_s=keygen_s, round_s=round_s,
               boot_s=boot_s, launches=launches, counts=counts,
               keyswitches=counters["keyswitch"],
               bootstraps=counters["bootstrap"], levels=levels,
               allreduces=led.counts.get("psum", 0),
               allreduce_bytes=led.bytes_in.get("psum", 0),
               allreduce_s=led.seconds_of("psum"),
               predicted_bytes=predicted, other=dict(led.counts),
               digits=meng.dks.digits, pad=meng.dks.pad,
               mode=meng.dks.comm.mode,
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if cuda else 0.0))
    # (on a CPU rehearsal the plain version runs: no launches)
    if not (counters["keyswitch"] == sum(levels.values())
            == res["allreduces"] > 0) or set(led.counts) != {"psum"} or \
            (cuda and (launches != counters["keyswitch"]
                       or counts["ntt_fwd"] <= 0 or counts["ntt_inv"] <= 0)):
        raise AssertionError(f"rank {rank}: launches {counts}, "
                             f"{counters['keyswitch']} key-switches, "
                             f"collectives {led.counts}, levels {levels}")
    if res["allreduce_bytes"] != predicted:
        raise AssertionError(f"rank {rank}: ledger {res['allreduce_bytes']} "
                             f"bytes, predicted {predicted}")
    if rank == 0:
        sync()
        t0 = time.perf_counter()
        out1 = run_full_aes.run_round(aes, st, 1, 1)
        sync()
        res["single_round_s"] = time.perf_counter() - t0
        zs1, res["single_boot_s"] = _refresh_pairs(wrap, out1, sync, boots)
        for k, (a, b) in enumerate(zip(out.bits + zs, out1.bits + zs1)):
            if not torch.equal(a.data, b.data) or a.scale != b.scale:
                what = f"round plane {k}" if k < 8 else f"bootstrap {k - 8}"
                raise AssertionError(f"{what}: the mesh differs from the "
                                     f"single-device Engine")
        want = np.concatenate([aes128_partial(state[b:b + 16], KEY, 1)
                               for b in range(0, sc, 16)])
        got = maes.decrypt_state(out)
        if int(np.sum(got != want)):
            raise AssertionError(f"{int(np.sum(got != want))} of {sc} bytes "
                                 f"differ from AES-128 after one round")
        err = 0.0
        for i, z in enumerate(zs):
            v = mwrap.decrypt(z)
            if v.shape != (sc,) or not np.all(np.isfinite(v)):
                raise AssertionError("bootstrap output is not finite or "
                                     "mis-shaped")
            bits = ((np.real(v) < 0).astype(np.uint8)
                    | ((np.imag(v) < 0).astype(np.uint8) << 1))
            if not np.array_equal(bits, (want >> 2 * i) & 3):
                raise AssertionError(f"refreshed pair {i} does not decode "
                                     f"to the round's bits")
            err = max(err, float(np.max(np.abs(np.abs(v.real) - 1))),
                      float(np.max(np.abs(np.abs(v.imag) - 1))))
        res.update(exit_level=zs[0].level, blocks=sc // 16, slot_err=err)
    return res


def _refresh_pairs(wrap: EngineWrapper, st: BitState, sync, n: int):
    """The first n (1 or 2) bootstraps of the pair-packed refresh (planes
    0+i*1, then 2+i*3) through the wrapper's eager bootstrap: the first
    fills the bootstrap key's diagonal cache, the second runs warm.
    Returns the outputs and their seconds."""
    eng = wrap.engine
    outs, secs = [], []
    for p in (0, 2)[:n]:
        sync()
        t0 = time.perf_counter()
        packed = eng.add(st.bits[p], eng.multiply_i(st.bits[p + 1]))
        outs.append(wrap.bootstrap(packed))
        sync()
        secs.append(time.perf_counter() - t0)
    return outs, secs


def _share(r: dict) -> str:
    """The all-reduces' time (host wall over gloo, stream time between CUDA
    events over NCCL) and its share of the mesh's round + bootstraps."""
    wall = r["round_s"] + sum(r["boot_s"])
    return f"{r['allreduce_s']:.3f} s ({r['allreduce_s'] / wall:.0%})"


def mesh_phase(boots: int) -> dict:
    """The mesh phase in spawned ranks with `boots` refresh bootstraps;
    returns rank 0's record and each kernel's launches summed over the
    ranks."""
    cards = torch.cuda.device_count()
    world, backend = (cards, "nccl") if cards >= 2 else (2, "gloo")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = launch.spawn(mesh_rank, world, PROFILE, "cuda", boots,
                       backend=backend, timeout_s=900)
    r0 = res[0]
    print(f"D={world} ranks over {backend} ({r0['mode']}), pad {r0['pad']} "
          f"digits: {[r['digits'] for r in res]}; spawn to end "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for r in res:
        print(f"rank {r['rank']}: keygen {r['keygen_s']:.2f} s, round "
              f"{r['round_s']:.3f} s, bootstraps "
              f"{[round(b, 3) for b in r['boot_s']]} s (the first fills "
              f"the diagonal cache); "
              f"{r['keyswitches']} key-switches = {r['launches']} ks_inner "
              f"launches = {r['allreduces']} all-reduces of "
              f"{r['allreduce_bytes']} operand bytes (predicted "
              f"{r['predicted_bytes']}; ring wire bytes per rank "
              f"{allreduce_wire_bytes(r['allreduce_bytes'], world):.0f}); "
              f"all-reduces take "
              f"{_share(r)}; peak device memory {r['peak_gib']:.2f} GiB",
              flush=True)
        check_launches(f"mesh rank {r['rank']}", r["counts"])
    lv = sorted(r0["levels"].items(), reverse=True)
    print(f"key-switches per level: {lv}", flush=True)
    sb = r0["single_boot_s"]
    warm = (f", warm bootstrap {r0['boot_s'][1] / sb[1]:.2f}x"
            if len(sb) > 1 else "")
    print(f"single-device Engine, same call (rank 0, after the mesh; the "
          f"diagonal cache is shared, so its bootstraps run warm): "
          f"round {r0['single_round_s']:.3f} s, bootstraps "
          f"{[round(b, 3) for b in sb]} s; mesh / single: round "
          f"{r0['round_s'] / r0['single_round_s']:.2f}x{warm}", flush=True)
    print(f"every output ciphertext equals the single-device Engine's; all "
          f"{r0['blocks']} blocks equal aes128_partial(block, key, 1); the "
          f"bootstraps (exit level {r0['exit_level']}, max | |slot| - 1 | "
          f"{r0['slot_err']:.3e}) decode to the round's bits 0-3", flush=True)
    total = dict.fromkeys(kernels.COUNTERS, 0)
    for r in res:
        add_launches(total, r["counts"])
    return dict(rank0=r0, launches=total, world=world, backend=backend)


def fused_phase(wrap: EngineWrapper, inputs: list) -> dict:
    """The fused bootstrap at the flagship's keys and refresh signature:
    capture one graph from inputs[0] (an eager warm-up first), replay it on
    every input and hold each replay against the eager bootstrap of the same
    input, bit for bit; then two back-to-back replays must not overwrite
    each other's output.  CUDA-event seconds of a warm eager bootstrap and
    of a replay, the capture's seconds, the graph pool and the launches per
    replay (= the key-switches a bootstrap counts)."""
    eng = wrap.engine
    fb = bootstrap.FusedBootstrap(eng, wrap.relin_key, wrap.conj_key,
                                  wrap.boot_key, inputs[0])
    per = fb.deltas
    print(f"captured one graph at input level {fb.in_level}, scale/Delta "
          f"{fb.in_scale / eng.params.scale:.9f} in {fb.capture_s:.3f} s "
          f"(after the eager warm-up); graph pool {fb.pool_bytes / 2**30:.3f}"
          f" GiB; per replay {per}", flush=True)
    if per.get("ks_inner_launches", 0) <= 0 or \
            per["ks_inner_launches"] != per.get("keyswitch") or \
            per.get("bootstrap") != 1 or \
            any(per.get(f"{k}_launches", 0) <= 0 for k in kernels.COUNTERS):
        raise AssertionError(f"a replay would count {per}")

    def timed(fn):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        return out, ev0.elapsed_time(ev1) / 1e3

    eager_s, replay_s = [], []
    for i, ct in enumerate(inputs):
        want, se = timed(lambda: eng.bootstrap(ct, wrap.relin_key,
                                               wrap.conj_key, wrap.boot_key))
        l0 = read_launches()
        k0 = eng.counters["keyswitch"]
        got, sr = timed(lambda: fb(ct))
        eager_s.append(se)
        replay_s.append(sr)
        l1 = read_launches()
        if any(l1[k] - l0[k] != per[f"{k}_launches"] for k in l0) or \
                eng.counters["keyswitch"] - k0 != per["keyswitch"]:
            raise AssertionError("a replay did not count its launches")
        if not torch.equal(got.data, want.data) or got.scale != want.scale:
            bad = int((got.data != want.data).sum())
            raise AssertionError(f"replay {i} differs from the eager "
                                 f"bootstrap in {bad} residues")
    first = fb(inputs[1])
    second = fb(inputs[2])
    for ct, out in ((inputs[1], first), (inputs[2], second)):
        want = eng.bootstrap(ct, wrap.relin_key, wrap.conj_key, wrap.boot_key)
        if not torch.equal(out.data, want.data):
            raise AssertionError("back-to-back replays share their output")
    print(f"{len(inputs)} inputs: every replay equals the eager bootstrap bit "
          f"for bit (and two back-to-back replays stay independent); warm "
          f"eager {[round(x, 4) for x in eager_s]} s, replay "
          f"{[round(x, 4) for x in replay_s]} s (CUDA events)", flush=True)
    check_launches("fused bootstrap, per replay",
                   {k: per[f"{k}_launches"] for k in kernels.COUNTERS})
    return dict(capture_s=fb.capture_s, pool_gib=fb.pool_bytes / 2 ** 30,
                eager_s=float(np.median(eager_s)),
                replay_s=float(np.median(replay_s)),
                launches_per_replay=per["ks_inner_launches"])


def zeta_leg(aes: AESFHE128, name: str, start: np.ndarray, run,
             want: np.ndarray) -> dict:
    """One timed leg of the zeta phase from a fresh encryption of `start`:
    CUDA-event time of `run(pair)`, counters and launches over it, every
    byte against `want`, and the largest phase error of the two nibbles
    (in zeta16 steps; a slot decodes right below 0.5)."""
    wrap = aes.eng
    eng = wrap.engine
    blocks = len(start) // 16
    pair = aes.encrypt_state(start)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.reset_counters()
    zero_launches()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    out = run(pair)
    ev1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    launches = counts["ks_inner"]
    counters = dict(eng.counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = aes.decrypt_state(out)
    hi, lo = split_nibbles(want)
    vals = [wrap.decrypt(out.hi), wrap.decrypt(out.lo)]
    for v in vals:
        if v.shape != (len(start),) or not np.all(np.isfinite(v)):
            raise AssertionError(f"zeta {name}: decrypted nibbles are not "
                                 f"finite or mis-shaped")
    err = max(phase_error(vals[0], hi), phase_error(vals[1], lo))
    bad = int(np.sum(got != want))
    s = ev0.elapsed_time(ev1) / 1e3
    print(f"zeta {name}: {blocks} blocks in {s:.3f} s (CUDA events; host "
          f"{wall:.3f} s) = {blocks / s:.1f} blocks/s; exit level "
          f"{out.hi.level}, scale/Delta {out.hi.scale / eng.params.scale:.6f};"
          f" max phase error {err:.3e} zeta16 steps; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"zeta {name}: engine counters {counters}; ks_inner launches "
          f"{launches}; {counters['bootstrap']} bootstraps", flush=True)
    if bad:
        raise AssertionError(f"zeta {name}: {bad} of {len(start)} bytes "
                             f"wrong")
    if launches <= 0 or launches != counters["keyswitch"]:
        raise AssertionError(f"zeta {name}: ks_inner launched {launches} "
                             f"times for {counters['keyswitch']} "
                             f"key-switches")
    check_launches(f"zeta {name}", counts)
    return dict(seconds=s, launches=counts, err=err, got=got,
                bootstraps=counters["bootstrap"])


def zeta_phase() -> list[dict]:
    """Keygen and the zeta legs at PROFILE; returns the legs' records."""
    torch.cuda.reset_peak_memory_stats()
    zwrap, (xs, tf, sr), keygen_s = zeta_trace.setup(PROFILE, SEED + 2,
                                                     "cuda", bootstrap=True)
    # forward: one round from the fresh state, no refresh; inverse: the
    # prod-shaped segment-refresh schedule (refresh between LUT stages):
    # without a refresh the inverse MixColumns and S-box LUTs amplify the
    # N=2^16 noise past the decode margin (PERF.md)
    zfwd = AESFHE128(zwrap, xs, tf, sr, KEY)
    zinv = AESFHE128(zwrap, xs, tf, sr, KEY, refresh=zwrap.bootstrap)
    zinv.segment_refresh = True
    zinv.post_boot_cleanses = 2
    steps = sorted(set(tf.rotation_steps()) |
                   set(tf.rotation_steps(inverse=True)))
    print(f"keygen {keygen_s:.2f} s: relin + conj + bootstrap key + "
          f"{len(zwrap.rot_key.keys)} rotation keys "
          f"({run_full_aes.key_gib(zwrap.rot_key.keys.values()):.2f} GiB; "
          f"direct keys for the shift-mix steps {steps}); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    sc = zwrap.engine.slot_count
    state = np.random.default_rng(SEED + 3).integers(0, 256, sc,
                                                     dtype=np.uint8)
    fwd_want = np.concatenate([aes128_partial(state[b:b + 16], KEY, 1)
                               for b in range(0, sc, 16)])
    fwd = zeta_leg(zfwd, "forward", state,
                   lambda p: zfwd.encrypt_rounds(p, rounds=1), fwd_want)
    print(f"all {sc // 16} blocks equal aes128_partial(block, key, 1)",
          flush=True)
    inv = zeta_leg(zinv, "inverse", fwd_want,
                   lambda p: zinv.decrypt_rounds(p, rounds=1), state)
    print(f"all {sc // 16} blocks decrypt back to their plaintext",
          flush=True)
    # ten rounds in the segment-refresh schedule (the eager bootstrap, the
    # inverse leg's cipher): the zeta counterpart of the flagship
    state = run_full_aes.make_state(sc, SEED + 6)
    want = np.concatenate([aes128_partial(state[b:b + 16], KEY, ZETA_ROUNDS)
                           for b in range(0, sc, 16)])
    # time every bootstrap: the segment refreshes and the XOR service's own
    # (it calls the wrapper's bootstrap for inputs below its BOOT_LEVEL)
    boot, boots = zwrap.bootstrap, []

    def timed_boot(ct):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = boot(ct)
        torch.cuda.synchronize()
        boots.append((time.perf_counter() - t0, ct.scale))
        return out

    zinv.refresh = zwrap.bootstrap = timed_boot
    try:
        ten = zeta_leg(zinv, f"{ZETA_ROUNDS} rounds", state,
                       lambda p: zinv.encrypt_rounds(p, rounds=ZETA_ROUNDS),
                       want)
    finally:
        zinv.refresh = boot
        del zwrap.bootstrap
    secs = [b[0] for b in boots]
    scales = [b[1] for b in boots]
    # the fused path's bucket of each input (EngineWrapper._bootstrap_fused)
    buckets = {round(float(np.log2(x)) * 1e4) for x in scales}
    delta = zwrap.engine.params.scale
    print(f"zeta {ZETA_ROUNDS} rounds: {len(secs)} bootstraps in "
          f"{sum(secs):.1f} s ({sum(secs) / ten['seconds']:.0%} of the leg; "
          f"first {secs[0]:.2f} s, median {np.median(secs):.3f} s, max "
          f"{max(secs):.2f} s); {len(buckets)} input-scale buckets, "
          f"scale/Delta {sorted({round(x / delta, 5) for x in scales})}",
          flush=True)
    print(f"zeta {ZETA_ROUNDS} rounds: {ten['bootstraps'] / ZETA_ROUNDS:.1f} "
          f"bootstraps per round; all {sc // 16} blocks equal "
          f"aes128_partial(block, key, {ZETA_ROUNDS})", flush=True)
    if ZETA_ROUNDS == 10:
        if bytes(ten["got"][:16]) != run_full_aes.FIPS_CT:
            raise AssertionError("zeta: block 0 is not FIPS-197 C.1's "
                                 "ciphertext")
        print("zeta: block 0 equals FIPS-197 C.1: "
              f"{run_full_aes.FIPS_CT.hex()}", flush=True)
    return [fwd, inv, ten]


def bench_leg(mode: str, logn: int, iters: int, exact: bool = True):
    """bench's `mode` leg at N=2^logn (BENCH_LEVELS levels) in process, no
    CPU leg: its line printed, its output held against the AES oracle
    (wrong bytes fail the phase when `exact`; else they are printed),
    launches equal to key-switches over the warm-up and the timed
    iterations, every kernel launched, the 16-block NTT exactly at 2^18
    and the two-pass NTT exactly from 2^19.
    Returns (each kernel's launches, the instances', a record: blocks/s,
    wrong bytes, the zeta step's largest phase error, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    leg = bench.SETUPS[mode](logn, BENCH_LEVELS, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng = leg.wrap.engine
    eng.reset_counters()
    zero_launches()
    bps, stats, out, leg = bench.run_leg(mode, logn, BENCH_LEVELS, iters,
                                         "cuda", leg=leg)
    counts = read_launches()
    variants = kernels.variant_counts()
    launches = counts["ks_inner"]
    counters = dict(eng.counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = bench.check_leg(leg, out)
    err, say = None, ""
    if mode == "zeta":
        hi, lo = split_nibbles(leg.want)
        vals = [leg.wrap.decrypt(out.hi), leg.wrap.decrypt(out.lo)]
        if not all(v.shape == (len(leg.want),) and np.all(np.isfinite(v))
                   for v in vals):
            raise AssertionError(f"bench zeta 2^{logn}: decrypted nibbles "
                                 f"are not finite or mis-shaped")
        err = max(phase_error(vals[0], hi), phase_error(vals[1], lo))
        say = f", max phase error {err:.3e} zeta16 steps"
    print(json.dumps(bench.leg_record(mode, leg.blocks, bps, stats, 0.0)),
          flush=True)
    print(f"bench {mode} at N=2^{logn}: keygen and encryption {setup_s:.2f} "
          f"s; {iters + 1} steps (warm-up included): engine counters "
          f"{counters}, ks_inner launches {launches}; {bad} of "
          f"{len(leg.want)} bytes wrong{say}; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    if bad and exact:
        raise AssertionError(f"bench {mode}: {bad} of {len(leg.want)} "
                             f"bytes differ from the AES oracle")
    if launches <= 0 or launches != counters["keyswitch"]:
        raise AssertionError(f"bench {mode}: ks_inner launched "
                             f"{launches} times for "
                             f"{counters['keyswitch']} key-switches")
    large = ("ntt_two_pass" if logn >= ntt.TWO_PASS_MIN_LOGN else
             "ntt_cluster16" if logn == ntt.CLUSTER16_LOGN else None)
    check_launches(f"bench {mode} at N=2^{logn}", counts,
                   (large,) if large else (), variants)
    if large and variants[large] <= 0:
        raise AssertionError(f"bench {mode} at N=2^{logn}: {large} did not "
                             f"run")
    del leg, out, eng
    torch.cuda.empty_cache()
    return counts, variants, dict(bps=bps, bad=bad, err=err, peak=peak)


def bench_phase():
    """bench's bitplane and zeta legs at BENCH_LOGN (bench_leg, every byte
    exact).  Returns each kernel's launches and the zeta step's largest
    phase error."""
    total = dict.fromkeys(kernels.COUNTERS, 0)
    for mode in ("bitplane", "zeta"):
        counts, _, rec = bench_leg(mode, BENCH_LOGN, BENCH_ITERS)
        add_launches(total, counts)
    return total, rec["err"]


def large_ring_phase(zeta16_err: float):
    """The rings above 2^17 on the main path: bench's bitplane leg
    at LOGN=18 (every block exact) and its zeta leg at 18 (wrong bytes and
    phase error printed; the leg at 17 too, for the phase error's trend
    beside 16's), then keyswitch_check at N=2^20 on LARGE_HP (decoded) and
    LARGE_KS (held residue for residue against the host's plain versions).
    Returns each kernel's launches and the instances' (the 16-block and
    the two-pass NTT's)."""
    total = dict.fromkeys(kernels.COUNTERS, 0)
    inst = dict.fromkeys(kernels.VARIANTS, 0)
    trend = {BENCH_LOGN: (zeta16_err, 0)}
    for mode, logn, exact in (("bitplane", LARGE_LOGN, True),
                              ("zeta", LARGE_LOGN - 1, True),
                              ("zeta", LARGE_LOGN, False)):
        counts, variants, rec = bench_leg(mode, logn, BENCH_ITERS, exact)
        add_launches(total, counts)
        add_launches(inst, variants)
        if mode == "zeta":
            trend[logn] = (rec["err"], rec["bad"])
    print("zeta step's largest phase error (zeta16 steps; 0.5 decodes "
          "wrong) and wrong bytes by ring: " + ", ".join(
              f"2^{k} {e:.3e} ({b} wrong)" for k, (e, b) in
              sorted(trend.items())), flush=True)
    for name, kw, decodes in (("LARGE_HP", LARGE_HP, True),
                              ("LARGE_KS", LARGE_KS, False)):
        chunked, _ = keyswitch_check(name, CKKSParams(**kw), decodes)
        add_launches(inst, chunked)
    print("LARGE_KS: its decode errors are the reference's (the same set at "
          "N=2^16 through both packages, "
          "tests/test_torch_large_ring.py::"
          "test_large_ks_decode_error_is_the_references)", flush=True)
    print(f"16-block NTT launches over this phase: {inst['ntt_cluster16']}, "
          f"two-pass NTT launches: {inst['ntt_two_pass']} (0 of each on "
          f"every earlier phase)", flush=True)
    return total, inst


def finish(card: str, cases: list, top: dict, ntt_shapes: list,
           legs: list, launches: dict, instances: dict) -> int:
    """The closing lines: the kernels line (each kernel's `launches` summed
    over the main paths run, the instances' (kernels.VARIANTS) over the
    phases that reach them: the chunked conversions' the key-switch phase,
    the 16-block and the two-pass NTT's the large-ring phase; ms, plain_ms
    and bound_ms of
    its widest shape, and every shape timed under "shapes"), the card, the
    contract's last line."""
    print(f"chip_smoke: all phases passed in {time.perf_counter() - T0:.1f} s",
          flush=True)
    entries = [dict(
        name="ks_inner", route="cuda",
        source="aesfhe_tpu_torch/csrc/ks_inner.cu",
        replaces="aesfhe_tpu/core/pallas_ks.py:38",
        launches=launches["ks_inner"],
        max_abs_err=max(c["max_abs_err"] for c in cases), ms=top["ms"],
        plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
        bound_by="bytes", library_ms=None, shapes=cases)]
    for name, line in (("ntt_fwd", 239), ("ntt_inv", 261)):
        mine = [c for c in ntt_shapes if c["name"] == name]
        widest = mine[0]            # the top level's decomposition
        entries.append(dict(
            name=name, route="cuda", source="aesfhe_tpu_torch/csrc/ntt.cu",
            replaces=f"aesfhe_tpu/core/mxu_ntt.py:{line}",
            launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=widest["ms"], plain_ms=widest["plain_ms"],
            bound_ms=widest["bound_ms"], bound_by=widest["bound_by"],
            library_ms=None, shapes=mine))
    # the instances of both above 2^17: the 16-block kernel (N = 2^18), its
    # widest shape bench LOGN=18's decomposition, forward; the two-pass one
    # (N >= 2^19), its widest a row of 2^25, forward
    for name, mine in (
            ("ntt_cluster16", [c for c in ntt_shapes
                               if c["N"] == 1 << ntt.CLUSTER16_LOGN]),
            ("ntt_two_pass", [c for c in ntt_shapes
                              if c["N"] >= 1 << ntt.TWO_PASS_MIN_LOGN])):
        widest = max(mine, key=lambda c: c["bound_ms"])
        entries.append(dict(
            name=name, route="cuda", source="aesfhe_tpu_torch/csrc/ntt.cu",
            replaces="aesfhe_tpu/core/mxu_ntt.py:239",
            launches=instances[name],
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=widest["ms"], plain_ms=widest["plain_ms"],
            bound_ms=widest["bound_ms"], bound_by=widest["bound_by"],
            library_ms=None, shapes=mine))
    # ks_legs.cu's kernels; no single PyTorch call computes any of them
    for name, line_no in (("ks_modup", 497), ("ks_moddown", 697),
                          ("sub_scale", 760), ("ks_modup_chunks", 497),
                          ("ks_moddown_chunks", 697)):
        mine = [c for c in legs if c["name"] == name]
        # the top level (the chunked instances': the case of the largest
        # bound)
        widest = mine[0] if name in launches else max(
            mine, key=lambda c: c["bound_ms"])
        entries.append(dict(
            name=name, route="cuda",
            source="aesfhe_tpu_torch/csrc/ks_legs.cu",
            replaces=f"aesfhe_tpu/core/ops_impl.py:{line_no}",
            launches=launches[name] if name in launches else
            instances[name],
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=widest["ms"], plain_ms=widest["plain_ms"],
            bound_ms=widest["bound_ms"], bound_by=widest["bound_by"],
            library_ms=None, shapes=mine))
    # lut_sum.cu's two instances, the first shape EvalMod's
    for name, line_no in (("lut_sum", 201), ("lut_sum_dense", 229)):
        mine = [c for c in legs if c["name"] == name]
        entries.append(dict(
            name=name, route="cuda",
            source="aesfhe_tpu_torch/csrc/lut_sum.cu",
            replaces=f"aesfhe_tpu/core/ops_impl.py:{line_no}",
            launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=mine[0]["ms"], plain_ms=mine[0]["plain_ms"],
            bound_ms=mine[0]["bound_ms"], bound_by=mine[0]["bound_by"],
            library_ms=None, shapes=mine))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    mesh_only = "--mesh-only" in args
    baseline = (args[args.index("--legs-baseline") + 1]
                if "--legs-baseline" in args else None)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    phase("card")
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"tools: nvcc={kernels.nvcc_path()} ninja={shutil.which('ninja')} "
          f"triton={importlib.util.find_spec('triton') is not None}",
          flush=True)

    phase("build")
    t0 = time.perf_counter()
    built = kernels.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    phase("kernels")
    params = get_params(PROFILE)
    rng = np.random.default_rng(SEED)
    # the slice's first (and widest) key-switch level, a middle and a late
    # one, against full-layout keys as the slice stores them, and one
    # level-capped key layout
    work_level = AESFHE128Bitsliced.ROUND_DEPTH * ROUNDS + 1
    cases = [ks_inner_case(params, lvl, None, rng, dev)
             for lvl in (work_level - 1, 14, 3)]
    cases.append(ks_inner_case(params, 14, 17, rng, dev))
    # the bootstrap's widest switch: CoeffToSlot's first group at the top
    # of the chain (J = dnum digits, every q-prime and special prime)
    top = ks_inner_case(params, params.top_level, None, rng, dev)
    cases.append(top)
    # the mesh phase's shapes: the last rank's J = pad/D digits at the top
    # level (its last digit is padding), D = 2 and 4, and a rank whose whole
    # shard is padding (level 15, D = 2)
    cases += [ks_inner_shard_case(params, params.top_level, d, d - 1, rng,
                                  dev) for d in (2, 4)]
    cases.append(ks_inner_shard_case(params, 15, 2, 1, rng, dev))
    # bench's legs: their widest switch, one level below the top of
    # BENCH_LEVELS (the first product rescales before it relinearizes)
    cases.append(ks_inner_case(bench.bench_params(BENCH_LOGN, BENCH_LEVELS),
                               BENCH_LEVELS - 1, None, rng, dev))
    ntt_shapes = ntt_cases(params, rng, dev) + large_ntt_cases(rng, dev)
    legs = ks_legs_cases(params, rng, dev) + lut_sum_cases(params, rng, dev)
    if baseline is not None:
        legs_variants.compare(baseline)
    torch.cuda.empty_cache()
    if mesh_only:
        phase("mesh")
        return finish(card, cases, top, ntt_shapes, legs,
                      mesh_phase(2)["launches"],
                      dict.fromkeys(kernels.VARIANTS, 0))

    phase("key-switch past 8 primes and below 2^16")
    chunk_launches = keyswitch_phase()

    phase("slice")
    t0 = time.perf_counter()
    wrap = EngineWrapper(XORConfig(profile=PROFILE, rotation_steps=(),
                                   device="cuda"),
                         rng=np.random.default_rng(SEED))
    aes = AESFHE128Bitsliced(wrap, KEY, refresh=None)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    eng = wrap.engine
    print(f"keygen {keygen_s:.2f} s: relin + conj + "
          f"{len(wrap.rot_key.keys)} rotation keys, dnum={params.dnum}, "
          f"L_tot={params.L_tot}, N={params.n}", flush=True)

    sc = eng.slot_count
    state = np.random.default_rng(SEED + 1).integers(0, 256, sc,
                                                     dtype=np.uint8)
    torch.cuda.reset_peak_memory_stats()
    eng.reset_counters()
    zero_launches()
    t0 = time.perf_counter()
    st = aes.encrypt_state(state)
    st = BitState([eng._drop(b, work_level) for b in st.bits])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st = aes.encrypt_rounds(st, rounds=ROUNDS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got = aes.decrypt_state(st)
    t3 = time.perf_counter()
    counts = read_launches()
    launches = counts["ks_inner"]
    counters = dict(eng.counters)

    want = np.concatenate([aes128_partial(state[b:b + 16], KEY, ROUNDS)
                           for b in range(0, sc, 16)])
    bad = int(np.sum(got != want))
    worst = 0.0
    for ct in st.bits:
        v = np.real(wrap.decrypt(ct))
        if v.shape != (sc,) or not np.all(np.isfinite(v)):
            raise AssertionError("decrypted plane is not finite or mis-shaped")
        worst = max(worst, float(np.max(np.abs(np.abs(v) - 1.0))))
    print(f"{sc // 16} blocks, {ROUNDS} rounds from level {work_level}: "
          f"encrypt_state "
          f"{t1 - t0:.2f} s, rounds {t2 - t1:.2f} s "
          f"({(t2 - t1) / ROUNDS:.2f} s per round incl. the closing "
          f"AddRoundKey), decrypt_state {t3 - t2:.2f} s; exit level "
          f"{st.level}; max | |slot| - 1 | = {worst:.3e}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"engine counters {counters}; ks_inner launches {launches}")
    if bad:
        raise AssertionError(f"{bad} of {sc} bytes differ from AES-128 "
                             f"after {ROUNDS} rounds")
    print(f"all {sc // 16} blocks equal aes128_partial(block, key, {ROUNDS})")
    if launches <= 0 or launches != counters["keyswitch"]:
        raise AssertionError(f"ks_inner launched {launches} times for "
                             f"{counters['keyswitch']} key-switches")
    check_launches("slice", counts)
    total = dict(counts)
    del wrap, aes, eng, st
    torch.cuda.empty_cache()

    phase("bench")
    counts, zeta16_err = bench_phase()
    add_launches(total, counts)

    phase("large ring (the NTT above 2^17)")
    counts, large_inst = large_ring_phase(zeta16_err)
    add_launches(total, counts)

    phase("flagship")
    torch.cuda.reset_peak_memory_stats()
    aes, keygen_s = run_full_aes.setup(PROFILE, SEED, device="cuda")
    wrap = aes.eng
    bk = wrap.boot_key
    print(f"keygen {keygen_s:.2f} s: relin + conj + "
          f"{len(bk.rot.keys)} bootstrap Galois keys "
          f"({run_full_aes.key_gib(bk.rot.keys.values()):.2f} GiB), "
          f"{len(wrap.rot_key.keys)} rotation keys in the round's set after "
          f"sharing; K={bk.K:.2f}, Chebyshev degree {bk.cheb_deg}, "
          f"{bk.double_angles} double angle(s), hi_prec={bk.hi_prec}; "
          f"CoeffToSlot groups {len(bk.cts_plan)}, SlotToCoeff groups "
          f"{len(bk.stc_plan)}", flush=True)
    state = run_full_aes.make_state(wrap.engine.slot_count, SEED + 1)
    # keep the last refresh's 4 inputs (level 0) for the fused phase
    inputs: list = []
    refresh = aes.refresh

    def recording_refresh(ct):
        inputs.append(wrap.engine._drop(ct, 0))
        del inputs[:-4]
        return refresh(ct)

    aes.refresh = recording_refresh
    try:
        res = run_full_aes.run_flagship(aes, state, FLAGSHIP_ROUNDS)
    finally:
        aes.refresh = refresh
    flag_counts = res["launches"]
    flag_launches = flag_counts["ks_inner"]
    boot_s = res["bootstrap_s"]
    print(f"{res['blocks']} blocks, {FLAGSHIP_ROUNDS} rounds from level "
          f"{res['work_level']}: encrypt_state {res['encrypt_s']:.2f} s, "
          f"rounds {res['wall_s']:.2f} s ({res['s_per_round']:.2f} s per "
          f"round, {res['blocks_per_s']:.3f} blocks/s), round seconds "
          f"{[round(x, 2) for x in res['round_s']]}", flush=True)
    print(f"{len(boot_s)} bootstraps: first {res['first_bootstrap_s']:.2f} s "
          f"(diagonal cache filled), steady median "
          f"{res['steady_bootstrap_s']:.2f} s, all "
          f"{[round(x, 2) for x in boot_s]}; diagonal stacks "
          f"{res['diag_stacks']} ({res['diag_gib']:.2f} GiB), cache hits "
          f"{res['diag_hits']}, misses {res['diag_misses']}", flush=True)
    for g in res["graphs"]:
        print(f"fused bootstrap graph: input level {g['in_level']}, scale/"
              f"Delta {g['in_scale'] / wrap.engine.params.scale:.9f}, "
              f"captured in {g['capture_s']:.3f} s, pool "
              f"{g['pool_gib']:.3f} GiB, per replay {g['per_replay']}",
              flush=True)
    print(f"engine counters {res['counters']}; ks_inner launches "
          f"{flag_launches}; max | |slot| - 1 | = {res['max_slot_err']:.3e}; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if not res["fused_boot"] or not res["graphs"]:
        raise AssertionError("the flagship did not run the fused bootstrap")
    if not res["exact"]:
        raise AssertionError(f"{res['bad_bytes']} of {wrap.engine.slot_count}"
                             f" bytes differ from AES-128 after "
                             f"{FLAGSHIP_ROUNDS} rounds")
    print(f"all {res['blocks']} blocks equal aes128_partial(block, key, "
          f"{FLAGSHIP_ROUNDS})")
    if FLAGSHIP_ROUNDS == 10:
        if not res["fips_block0"]:
            raise AssertionError("block 0 is not FIPS-197 C.1's ciphertext")
        print("block 0 equals FIPS-197 C.1: 69c4e0d86a7b0430d8cdb78070b4c55a")
    if res["bootstraps"] != 4 * (FLAGSHIP_ROUNDS - 1):
        raise AssertionError(f"{res['bootstraps']} bootstraps for "
                             f"{FLAGSHIP_ROUNDS} rounds")
    if flag_launches <= 0 or flag_launches != res["keyswitches"]:
        raise AssertionError(f"ks_inner launched {flag_launches} times for "
                             f"{res['keyswitches']} key-switches")
    check_launches("flagship (the graph replays included)", flag_counts)
    if any(g["per_replay"].get(f"{k}_launches", 0) <= 0
           for g in res["graphs"] for k in kernels.COUNTERS):
        raise AssertionError("a bootstrap graph does not replay every "
                             "kernel")
    add_launches(total, flag_counts)
    # bench's flagship line, mapped from this phase's own run
    print(json.dumps(bench.flagship_record(dict(res, profile=PROFILE))),
          flush=True)

    phase("fused bootstrap")
    if len(inputs) != 4:
        raise AssertionError(f"recorded {len(inputs)} refresh inputs, not 4")
    fused_phase(wrap, inputs)
    del inputs

    phase("kernel at the bootstrap's levels")
    levels = {}
    for tag, _, lvl, _ in bk.diags:
        side = "stc" if tag.startswith("fstc") else "cts"
        levels[side] = max(levels.get(side, -1), lvl)
    print(f"widest group entry levels: CoeffToSlot {levels['cts']}, "
          f"SlotToCoeff {levels['stc']}", flush=True)
    if levels["cts"] != params.top_level:
        raise AssertionError(f"CoeffToSlot entered at {levels['cts']}, not "
                             f"{params.top_level}")
    cases.append(ks_inner_case(params, levels["stc"], None, rng, dev))

    del aes, wrap, bk
    torch.cuda.empty_cache()

    phase("zeta")
    for leg in zeta_phase():
        add_launches(total, leg["launches"])

    # one refresh bootstrap on the mesh here (two with --mesh-only): the
    # ten zeta rounds need the time
    phase("mesh")
    add_launches(total, mesh_phase(1)["launches"])
    add_launches(chunk_launches, large_inst)
    return finish(card, cases, top, ntt_shapes, legs, total, chunk_launches)


if __name__ == "__main__":
    sys.exit(main())
