// Negacyclic NTT over RNS rows, forward and inverse, hand-written for
// Hopper (sm_90a).
//
// Replaces the reference's accelerator NTT, aesfhe_tpu/core/mxu_ntt.py:
// ntt_fwd_mxu (l.239) and ntt_inv_mxu (l.261), which every forward and
// inverse transform reaches on the TPU through aesfhe_tpu/core/ops_impl.py:
// 89-97 (the butterfly network aesfhe_tpu/core/ntt.py:172-183 on other
// backends).  The TPU form is a 4-step transform of int8 digit matmuls for
// its matrix unit; the H100 has no such constraint, so this is the butterfly
// network itself, with the same layout and the same residues:
//   forward: Cooley-Tukey with the psi-twist merged into the twiddles,
//     natural coefficient order in, bit-reversed evaluation order out;
//   inverse: Gentleman-Sande on bit-reversed input, N^-1 folded into the
//     last stage (both of its outputs take one Shoup product: (u+v)*N^-1
//     and (u-v)*(wi[1]*N^-1)).
// Stage s (m = 2^s groups, half-span t = N >> (s+1)) pairs element idx
// (bit t clear) with idx + t under the twiddle w[m + (idx >> (logN - s))],
// which is w[l, m + i] as core/ntt.py:NTTTables lays it out.
//
// Arithmetic: 32-bit residues (every prime is below 2^30), Shoup products
// with the host's companions w_sh = floor(w * 2^32 / q); every butterfly
// keeps its outputs canonical, so any schedule of the network gives the
// plain int64 version's residues exactly.
//
// Contract (core/ntt.py's wrappers): input int32 (canonical residues, read
// as they are) or int64 (any value, reduced on load: floor mod); output
// int32 or int64, contiguous [B, L, N]; `mont` folds the Montgomery
// conversions in: the forward multiplies each input by R = 2^32 mod q on
// load (one Shoup product), the inverse uses N^-1*R^-1 and
// wi[1]*N^-1*R^-1 in its last stage (no extra product).  rowc [L_tot, 11]
// per table row: q, N^-1, its companion, wi[1]*N^-1, its companion, R, its
// companion, N^-1*R^-1, its companion, wi[1]*N^-1*R^-1, its companion.
//
// Bound: memory.  Each input word read once and each output word written
// once: 8 bytes per element int32 in and out (16 int64), against 3 32-bit
// multiplies per butterfly (24 per element at N = 2^16: ~1.4 ps at the
// card's multiply rate against ~2.4 ps for 8 bytes at 3.35 TB/s).  The
// design, one launch per transform and no global scratch up to N = 2^18:
//   - radix in registers: a thread holds the 2^r residues (r = 2, 3 or 4)
//     of one group of a pass, runs r stages on them, and writes them back;
//     a pass is one shared-memory round trip and one barrier;
//   - shared memory padded one word per 32 (position p at p + p/32): a
//     pass whose lowest bit is >= 5 puts the lanes of a warp on positions
//     0..31 (consecutive words), one below 5 on the positions just above
//     the pass (a 32-word stride): either way 32 distinct banks;
//   - N = 2^16, 2^17 (kClusterMinLog): a cluster of kCluster = 8 blocks
//     holds one row (2 x 33 KB of residues a block at 2^16).  The first
//     logN - 8 stages run as sub-transforms of the columns {c + 256 k}
//     (block r holds the 32 columns from 32 r, read straight from global
//     memory into the first pass, 32 consecutive words a warp); after a
//     cluster barrier each block reads its 2^(logN-11) contiguous runs of
//     256 from the other blocks' shared memory (distributed shared memory,
//     map_shared_rank) into its first run pass, and writes the last pass
//     straight to global memory (4 consecutive words a thread, one vector
//     store).  The inverse runs the two halves in the other order.  The
//     first half's twiddles (indices below 2^(logN-8)) are staged in
//     shared memory; the second half's come through L2, and the grid puts
//     the batch on its fastest axis, so the B clusters of one row run
//     together and fetch its tables once;
//   - N = 2^18 (kCluster16Log): the same scheme on a cluster of 16 blocks
//     (ntt_cluster16): 32 columns of 2^9 a block (column passes 3+3+3 k
//     bits), runs of 2^9 (run passes over c bits [5, 9), the exchange, one
//     bit a block, then [2, 5) and [0, 2)), 2^14 positions a block.  The
//     row crosses device memory once (the two-pass path from 2^19 moves it
//     twice).  Two layouts a block (139 KB, one block an SM) let the card
//     hold 7 such clusters at once (112 SMs; cudaOccupancyMaxActive-
//     Clusters, PERF.md §6), and 2^17's kernel, one block an SM, runs at
//     2/3 of 2^16's rate; so each block keeps both layouts in one buffer (74
//     KB with the staged twiddles: three blocks an SM, 21 clusters).  The
//     exchange then has a rule it must keep: every block reads all it needs
//     of another block's buffer before that block writes its new layout
//     there.  pass_held loads every group of the exchange from the other
//     blocks (64 residues a thread), runs its stages in registers, waits at
//     a cluster barrier, then stores; that barrier also keeps every block
//     alive (its shared memory mapped) until the others have read it.  What
//     the 16-block kernel does beside the 8-block one, each measured on the
//     card (PERF.md §6): it reads the other blocks through 32-bit
//     shared::cluster addresses (mapa, ld.shared::cluster; through
//     cooperative_groups nvcc kept the ranks in local memory); its radix-16
//     pass runs compile-time loops (radix_static: nvcc left the loop nest
//     partly rolled, the group in local memory); the exchange's run stages
//     read twiddles the block staged (ExTw: 480 pairs, its runs only); an
//     int64 input outside [0, q) takes a 32-bit floor mod (load_residue_r),
//     not the called 64-bit remainder.  16 is a non-portable cluster size:
//     ntt_setup allows it (cudaFuncAttributeNonPortableClusterSizeAllowed)
//     once, never inside a graph capture, and the launch gives the cluster
//     dimension as a launch attribute (cudaLaunchKernelEx); a cluster the
//     card cannot place returns its error to the wrapper, which raises;
//   - N >= 2^19 (kTwoPassMinLog): a row fits no cluster, so the transform
//     is two launches with the row in global memory between them, split at
//     a stage boundary, logN = a + b with b = max(10, logN - 10): ntt_cols
//     runs the first a stages as sub-transforms of the columns {c + 2^b k}
//     (a block holds 32 adjacent columns, the cluster kernel's column half
//     with ColIn/ColOut at a column stride of 2^b, its 2^a twiddles staged
//     in shared memory), ntt_runs the last b stages on contiguous runs of
//     2^b (the cluster kernel's run half: RunIn/RunOut, twiddles through
//     L2, the last store 16 bytes a thread; at least 2^13 positions a
//     block).  Each is compiled per split (ntt_cols<a>, ntt_runs<b>: the
//     pass table is a constant, the passes unroll, no stack; ntt_runs's
//     launch bounds give it the registers of the blocks its shared memory
//     allows), and only the dtype pairs the launcher uses exist (int32
//     between the passes), with load_residue_r's floor mod.  The
//     inverse runs ntt_runs first, then ntt_cols, whose stage 0 takes the
//     folded N^-1 (and R^-1).  Between the passes the residues are int32
//     (4 bytes an element each way, also for an int64 output) in a scratch
//     of the wrapper's, never x or y: each launch reads its input through
//     ld.global.nc (__ldg) under __restrict__, which holds only for a
//     buffer that nothing writes while the kernel runs, so neither launch
//     works in place.  It moves the row through device memory twice, so it
//     cannot pass half the byte bound; both halves fit one block's shared
//     memory up to a = 10 (32 x 2^10 positions and 2^10 twiddles, 143 KB)
//     and b = 15 (135 KB): kMaxLog = 25;
//   - N <= 2^15: one block holds a whole row (several rows for N < 2^11,
//     kTileLog), loaded and stored in a coalesced pass of its own;
//   - the kernels read x through its batch and row strides, and a row
//     vector maps each data row to its table row, so one upload of the
//     [L_tot, N] tables serves every row selection.
// What holds them is instruction issue and latency, not bytes (PERF.md):
// so a thread takes two groups at a time (their loads overlap), addresses
// a group's words at one base and a constant stride, checks a group's int64
// words for canonical values once (the floor mod only off that path) and
// reduces with one unsigned minimum.  Loads are plain coalesced loads (no
// TMA or cp.async): each residue is read once, straight into the registers
// of its first pass, and the padded layouts (a word every 32) leave no
// 16-byte-aligned rows for a bulk copy.  Dynamic shared memory above 48 KB
// is allowed once, in ntt_setup, when the library loads (never inside a
// CUDA graph capture).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kClusterMinLog = 16;      // from here a cluster holds a row
constexpr int kCluster16Log = 18;       // the ring of the 16-block cluster
constexpr int kTwoPassMinLog = 19;      // from here two launches a transform
constexpr int kColMaxLog = 10;          // two-pass: columns of <= 2^10 points
constexpr int kRunMinLog = 10;          // two-pass: runs of >= 2^10
constexpr int kRunMaxLog = kClusterMinLog - 1;   // and <= 2^15 (one block)
constexpr int kRunsTileLog = 13;        // two-pass runs: >= 2^13 a block
constexpr int kMaxLog = kColMaxLog + kRunMaxLog;
constexpr int kClusterLog = 3;
constexpr int kCluster = 1 << kClusterLog;
constexpr int kRunLog = 8;              // cluster path: runs of 2^8
constexpr int kColLog = kRunLog - kClusterLog;   // 32 columns a block
constexpr int kC16Log = 4;              // 2^18: 16 blocks a row,
constexpr int kC16Ls = 9;               // columns of 2^9, runs of 2^9
constexpr int kC16Threads = 256;        // its threads a block,
constexpr int kC16Layouts = 1;          // layouts a block (1: one buffer),
constexpr int kC16BlocksPerSm = 3;      // and the blocks an SM it aims at
constexpr int kC16Unroll = 2;           // groups in flight a thread
constexpr int kTileLog = 11;            // one-block path: >= 2^11 a block
constexpr int kBlocksPerSm = 3;         // cluster path at N = 2^16
constexpr int kRowConsts = 11;
constexpr int kFoldPlain = 1;           // rowc offsets of the fold constants
constexpr int kFoldMont = 7;
constexpr int kMontR = 5;

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

// The reductions take the unsigned minimum of x and x - q (or x + q): the
// wrapped candidate is the larger one, so one instruction picks the
// canonical residue.
__device__ __forceinline__ uint32_t add_q(uint32_t a, uint32_t b,
                                          uint32_t q) {
  const uint32_t s = a + b;
  return min(s, s - q);
}

__device__ __forceinline__ uint32_t sub_q(uint32_t a, uint32_t b,
                                          uint32_t q) {
  const uint32_t d = a - b;
  return min(d, d + q);
}

// a * w mod q for a < 2^32, w < q < 2^31, wsh = floor(w * 2^32 / q): the
// unreduced value lies in [0, 2q).
__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w,
                                          uint32_t wsh, uint32_t q) {
  const uint32_t r = a * w - __umulhi(a, wsh) * q;
  return min(r, r - q);
}

__device__ __forceinline__ uint32_t load_residue(long long x, uint32_t q) {
  if (static_cast<unsigned long long>(x) < q) return static_cast<uint32_t>(x);
  const long long r = x % static_cast<long long>(q);
  return static_cast<uint32_t>(r < 0 ? r + q : r);
}

__device__ __forceinline__ uint32_t load_residue(int32_t x, uint32_t) {
  return static_cast<uint32_t>(x);
}

// The residues of a group's 2^kR input words, all loaded before this (so
// the loads issue together): int64 words take the floor mod on a path of
// their own, entered once for the group when any word lies outside [0, q).
template <int kR>
__device__ __forceinline__ void residues(const int32_t (&raw)[1 << kR],
                                         uint32_t (&v)[1 << kR], uint32_t) {
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j) v[j] = static_cast<uint32_t>(raw[j]);
}

template <int kR>
__device__ __forceinline__ void residues(const long long (&raw)[1 << kR],
                                         uint32_t (&v)[1 << kR], uint32_t q) {
  bool canonical = true;
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j)
    canonical &= static_cast<unsigned long long>(raw[j]) < q;
  if (canonical) {
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j) v[j] = static_cast<uint32_t>(raw[j]);
  } else {
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j) v[j] = load_residue(raw[j], q);
  }
}

// residues() with the floor mod in 32-bit arithmetic (the kernels of rings
// from 2^18): x = hi * 2^32 + lo, x mod q = (hi mod q) * R + lo mod q, R =
// 2^32 mod q and its companion from the row constants (one Shoup product);
// the 64-bit remainder it replaces is a called routine.
__device__ __forceinline__ uint32_t load_residue_r(long long x, uint32_t q,
                                                   uint32_t r, uint32_t rsh) {
  int hm = static_cast<int>(x >> 32) % static_cast<int>(q);
  hm += hm < 0 ? static_cast<int>(q) : 0;
  return add_q(shoup(static_cast<uint32_t>(hm), r, rsh, q),
               static_cast<uint32_t>(x) % q, q);
}

template <int kR>
__device__ __forceinline__ void residues_r(const int32_t (&raw)[1 << kR],
                                           uint32_t (&v)[1 << kR], uint32_t q,
                                           uint32_t, uint32_t) {
  residues<kR>(raw, v, q);
}

template <int kR>
__device__ __forceinline__ void residues_r(const long long (&raw)[1 << kR],
                                           uint32_t (&v)[1 << kR], uint32_t q,
                                           uint32_t r, uint32_t rsh) {
  bool canonical = true;
#pragma unroll
  for (int j = 0; j < (1 << kR); ++j)
    canonical &= static_cast<unsigned long long>(raw[j]) < q;
  if (canonical) {
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j) v[j] = static_cast<uint32_t>(raw[j]);
  } else {
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j)
      v[j] = load_residue_r(raw[j], q, r, rsh);
  }
}

// Four consecutive input words at p (16-byte aligned).
__device__ __forceinline__ void load4(const int32_t* p, int32_t* v) {
  const int4 t = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const long long* p, long long* v) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void put(int32_t* p, uint32_t v) {
  *p = static_cast<int32_t>(v);
}

__device__ __forceinline__ void put(long long* p, uint32_t v) { *p = v; }

__device__ __forceinline__ void put4(int32_t* p, const uint32_t* v) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void put4(long long* p, const uint32_t* v) {
  auto* o = reinterpret_cast<longlong2*>(p);
  o[0] = make_longlong2(v[0], v[1]);
  o[1] = make_longlong2(v[2], v[3]);
}

// ---------------------------------------------------------------------------
// One radix pass
// ---------------------------------------------------------------------------

// f(std::integral_constant<int, i>) for each i of the sequence, in order.
template <class F, int... kI>
__device__ __forceinline__ void static_for(std::integer_sequence<int, kI...>,
                                           F&& f) {
  (f(std::integral_constant<int, kI>{}), ...);
}

template <bool kFwd, int kR, class Tw>
__device__ __forceinline__ void radix_static(uint32_t (&v)[1 << kR], int s0,
                                             int gb, uint32_t q, const Tw& tw,
                                             const uint32_t* f);

// The 2^kR residues v[j] of one group (positions base + (j << pb0)) run the
// kR stages s0 .. s0+kR-1 (forward upward, inverse downward).  Stage s0+i
// pairs j with j + 2^(kR-1-i) under the twiddle index
// 2^(s0+i) + (gb << i) + (j >> (kR-i)), gb the row index's bits above the
// pass; the inverse's stage 0 takes the folded constants f[0..3] instead.
// Radix 16 takes radix_static (nvcc leaves this loop nest partly rolled
// there, and the group in local memory).
template <int kR, bool kFwd, class Tw>
__device__ __forceinline__ void radix(uint32_t (&v)[1 << kR], int s0, int gb,
                                      uint32_t q, const Tw& tw,
                                      const uint32_t* f) {
  if constexpr (kR == 4) {
    radix_static<kFwd, kR>(v, s0, gb, q, tw, f);
    return;
  }
  constexpr int R = 1 << kR;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int i = kFwd ? k : kR - 1 - k;
    const int half = R >> (i + 1);
#pragma unroll
    for (int tg = 0; tg < (1 << i); ++tg) {
      const int j0 = tg * (R >> i);
      if (!kFwd && s0 + i == 0) {
#pragma unroll
        for (int jj = 0; jj < half; ++jj) {
          const uint32_t u = v[j0 + jj], x = v[j0 + jj + half];
          v[j0 + jj] = shoup(add_q(u, x, q), f[0], f[1], q);
          v[j0 + jj + half] = shoup(sub_q(u, x, q), f[2], f[3], q);
        }
        continue;
      }
      uint32_t w, wsh;
      tw((1 << (s0 + i)) + (gb << i) + tg, w, wsh);
#pragma unroll
      for (int jj = 0; jj < half; ++jj) {
        const uint32_t u = v[j0 + jj], x = v[j0 + jj + half];
        if (kFwd) {
          const uint32_t t = shoup(x, w, wsh, q);
          v[j0 + jj] = add_q(u, t, q);
          v[j0 + jj + half] = sub_q(u, t, q);
        } else {
          v[j0 + jj] = add_q(u, x, q);
          v[j0 + jj + half] = shoup(sub_q(u, x, q), w, wsh, q);
        }
      }
    }
  }
}

// radix() with every loop a compile-time sequence.
template <bool kFwd, int kR, class Tw>
__device__ __forceinline__ void radix_static(uint32_t (&v)[1 << kR], int s0,
                                             int gb, uint32_t q, const Tw& tw,
                                             const uint32_t* f) {
  constexpr int R = 1 << kR;
  static_for(std::make_integer_sequence<int, kR>{}, [&](auto kk) {
    constexpr int k = decltype(kk)::value;
    constexpr int i = kFwd ? k : kR - 1 - k;
    constexpr int half = R >> (i + 1);
    static_for(std::make_integer_sequence<int, (1 << i)>{}, [&](auto tt) {
      constexpr int j0 = decltype(tt)::value * (R >> i);
      if (!kFwd && s0 + i == 0) {
        static_for(std::make_integer_sequence<int, half>{}, [&](auto jq) {
          constexpr int a = j0 + decltype(jq)::value;
          const uint32_t u = v[a], x = v[a + half];
          v[a] = shoup(add_q(u, x, q), f[0], f[1], q);
          v[a + half] = shoup(sub_q(u, x, q), f[2], f[3], q);
        });
        return;
      }
      uint32_t w, wsh;
      tw((1 << (s0 + i)) + (gb << i) + decltype(tt)::value, w, wsh);
      static_for(std::make_integer_sequence<int, half>{}, [&](auto jq) {
        constexpr int a = j0 + decltype(jq)::value;
        const uint32_t u = v[a], x = v[a + half];
        if (kFwd) {
          const uint32_t t = shoup(x, w, wsh, q);
          v[a] = add_q(u, t, q);
          v[a + half] = sub_q(u, t, q);
        } else {
          v[a] = add_q(u, x, q);
          v[a + half] = shoup(sub_q(u, x, q), w, wsh, q);
        }
      });
    });
  });
}

// A pass over a buffer of 2^nbits positions: group g (2^(nbits-kR) of
// them) takes the positions base + (j << pb0), j < 2^kR.  Lanes take the
// low position bits when pb0 >= 5, else the bits from pb0 + kR up.
// ctx(base) gives the group's q, twiddle source and fold constants; boff
// is added to the group's index bits above the pass (the block's first run
// on the cluster path).
template <int kR, bool kFwd, int kNt = kThreads, int kU = 2, class Src,
          class Dst, class Ctx>
__device__ __forceinline__ void pass(int nbits, int pb0, int s0, int boff,
                                     const Src& src, const Dst& dst,
                                     const Ctx& ctx) {
  constexpr int R = 1 << kR;
  const int top = pb0 + kR;
  const int nh = nbits - top;
  const int groups = 1 << (nbits - kR);
#pragma unroll kU
  for (int g = threadIdx.x; g < groups; g += kNt) {
    const int base = pb0 >= 5
        ? ((g >> pb0) << top) | (g & ((1 << pb0) - 1))
        : ((g & ((1 << nh) - 1)) << top) | (g >> nh);
    const int gb = ((base >> top) & ((1 << s0) - 1)) + boff;
    uint32_t v[R];
    src.template load<kR>(v, base, pb0);
    radix<kR, kFwd>(v, s0, gb, ctx.q(base), ctx.tw(base), ctx.fold(base));
    dst.template store<kR>(v, base, pb0);
  }
}

// pass() as the exchange of a cluster whose blocks each hold one buffer
// (the 16-block cluster): every group of this thread (2^(kNb-kR) groups
// over the block's kNt threads) is loaded from src (other blocks' shared
// memory) and runs its stages in registers, then the cluster barrier, then
// every group is stored to dst (this block's buffer, which other blocks
// read before the barrier).
template <int kR, bool kFwd, int kNb, int kNt, class Src, class Dst,
          class Ctx>
__device__ __forceinline__ void pass_held(int pb0, int s0, int boff,
                                          const Src& src, const Dst& dst,
                                          const Ctx& ctx) {
  constexpr int kG = (1 << (kNb - kR)) / kNt;
  static_assert(kG * kNt == 1 << (kNb - kR), "whole groups a thread");
  const int top = pb0 + kR;
  const int nh = kNb - top;
  uint32_t v[kG][1 << kR];
  int base[kG];
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    const int g = threadIdx.x + i * kNt;
    base[i] = pb0 >= 5
        ? ((g >> pb0) << top) | (g & ((1 << pb0) - 1))
        : ((g & ((1 << nh) - 1)) << top) | (g >> nh);
    const int gb = ((base[i] >> top) & ((1 << s0) - 1)) + boff;
    src.template load<kR>(v[i], base[i], pb0);
    radix<kR, kFwd>(v[i], s0, gb, ctx.q(base[i]), ctx.tw(base[i]),
                    ctx.fold(base[i]));
  }
  cg::this_cluster().sync();
#pragma unroll
  for (int i = 0; i < kG; ++i) dst.template store<kR>(v[i], base[i], pb0);
}

struct GlobalTw {
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
};

// The 16-block cluster's exchange stages kC16Ls + i (i < kC16Log) for this
// block's 32 runs from h0: 2^i twiddles a run, staged at
// ((2^i - 1) << 5) + (ti - 2^(kC16Ls + i) - (h0 << i)).
struct ExTw {
  const uint32_t* w;
  const uint32_t* wsh;
  int h0;
  __device__ __forceinline__ void operator()(int ti, uint32_t& a,
                                             uint32_t& b) const {
    const int i = 31 - __clz(ti) - kC16Ls;
    const int at = (((1 << i) - 1) << 5) + ti - (1 << (kC16Ls + i)) -
                   (h0 << i);
    a = w[at];
    b = wsh[at];
  }
};

// One row for every group (the cluster path).
template <class Tw>
struct RowCtx {
  uint32_t q_;
  Tw tw_;
  const uint32_t* f_;
  __device__ __forceinline__ uint32_t q(int) const { return q_; }
  __device__ __forceinline__ const Tw& tw(int) const { return tw_; }
  __device__ __forceinline__ const uint32_t* fold(int) const { return f_; }
};

// A pass's bits never straddle bit 5 (pb0 >= 5, or pb0 + kR <= 5), so
// position base + (j << pb0) sits at pad(base) + j * stride(pb0).
__device__ __forceinline__ int stride(int pb0) {
  return pb0 >= 5 ? (1 << pb0) + (1 << (pb0 - 5)) : 1 << pb0;
}

struct SmemBuf {
  uint32_t* p;
  template <int kR>
  __device__ __forceinline__ void load(uint32_t (&v)[1 << kR], int base,
                                       int pb0) const {
    const uint32_t* b = p + pad(base);
    const int st = stride(pb0);
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j) v[j] = b[j * st];
  }
  template <int kR>
  __device__ __forceinline__ void store(const uint32_t (&v)[1 << kR],
                                        int base, int pb0) const {
    uint32_t* b = p + pad(base);
    const int st = stride(pb0);
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j) b[j * st] = v[j];
  }
};

// ---------------------------------------------------------------------------
// Cluster path (N >= 2^16): the layouts and their maps
// ---------------------------------------------------------------------------
// Column layout (a block's 32 columns): position p = k * 32 + cl holds the
// row index (k << 8) | (32 * rank + cl).  Run layout (a block's runs from
// h0 = rank * H): position p = hl * 256 + c holds (h0 + hl) << 8 | c.

// Global memory through the column layout (the forward's first pass; with
// to_mont the input's Montgomery factor on load).  Passes over k bits
// (pb0 >= 5): element j is row index col(base) + (j << (pb0 - 5 + lc)),
// lc the log of the column stride (kRunLog on the cluster path, b on the
// two-pass path).
__device__ __forceinline__ int col_index(int p, int c0, int lc) {
  return ((p >> kColLog) << lc) | (c0 + (p & 31));
}

// kFast: the floor mod of residues_r (R, its companion: r, rsh).
template <typename Tin, bool kFast = false>
struct ColIn {
  const Tin* __restrict__ x;
  int c0;
  uint32_t q, r, rsh;
  bool mont;
  int lc = kRunLog;
  template <int kR>
  __device__ __forceinline__ void load(uint32_t (&v)[1 << kR], int base,
                                       int pb0) const {
    const Tin* b = x + col_index(base, c0, lc);
    const int st = 1 << (pb0 + lc - kColLog);
    Tin raw[1 << kR];
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j) raw[j] = __ldg(b + j * st);
    if constexpr (kFast) residues_r<kR>(raw, v, q, r, rsh);
    else residues<kR>(raw, v, q);
    if (mont) {
#pragma unroll
      for (int j = 0; j < (1 << kR); ++j) v[j] = shoup(v[j], r, rsh, q);
    }
  }
};

template <typename Tout>
struct ColOut {
  Tout* __restrict__ y;
  int c0;
  int lc = kRunLog;
  template <int kR>
  __device__ __forceinline__ void store(const uint32_t (&v)[1 << kR],
                                        int base, int pb0) const {
    Tout* b = y + col_index(base, c0, lc);
    const int st = 1 << (pb0 + lc - kColLog);
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j) put(b + j * st, v[j]);
  }
};

// Global memory through the run layout (the inverse's first pass, the
// forward's last): 4 consecutive words a thread when pb0 == 0.  kFast as
// ColIn's.
template <typename Tin, bool kFast = false>
struct RunIn {
  const Tin* __restrict__ x;
  int off;
  uint32_t q;
  bool vec;
  uint32_t r = 0, rsh = 0;
  template <int kR>
  __device__ __forceinline__ void load(uint32_t (&v)[1 << kR], int base,
                                       int pb0) const {
    Tin raw[1 << kR];
    bool done = false;
    if constexpr (kR >= 2) {
      if (pb0 == 0 && vec) {
#pragma unroll
        for (int j = 0; j < (1 << kR); j += 4) load4(x + off + base + j,
                                                     raw + j);
        done = true;
      }
    }
    if (!done) {
#pragma unroll
      for (int j = 0; j < (1 << kR); ++j)
        raw[j] = __ldg(x + off + base + (j << pb0));
    }
    if constexpr (kFast) residues_r<kR>(raw, v, q, r, rsh);
    else residues<kR>(raw, v, q);
  }
};

template <typename Tout>
struct RunOut {
  Tout* __restrict__ y;
  int off;
  template <int kR>
  __device__ __forceinline__ void store(const uint32_t (&v)[1 << kR],
                                        int base, int pb0) const {
    if constexpr (kR >= 2) {
      if (pb0 == 0) {
#pragma unroll
        for (int j = 0; j < (1 << kR); j += 4) put4(y + off + base + j, v + j);
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < (1 << kR); ++j)
      put(y + off + base + (j << pb0), v[j]);
  }
};

// Rank `rank`'s shared::cluster address of this block's word p, and a word
// at such an address: the 16-block exchange reads through these 32-bit
// addresses (through cooperative_groups' map_shared_rank, nvcc keeps the
// ranks in a local array, PERF.md §6); the 8-block one reads through them.
__device__ __forceinline__ uint32_t map_rank(const uint32_t* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ uint32_t ld_cluster(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// The forward's exchange, the first run pass (c bits [5, kRl): pb0 = 5,
// kR = kRl - 5, the cluster's log size): run-layout position base + (j <<
// 5) of this block is column layout position ((h0 + base / 2^kRl) << 5) |
// (base & 31) of block j.
template <int kRl>
struct FromCols {
  uint32_t* cols;
  int h0;
  template <int kR>
  __device__ __forceinline__ void load(uint32_t (&v)[1 << kR], int base,
                                       int) const {
    cg::cluster_group cluster = cg::this_cluster();
    uint32_t* at = cols + pad(((h0 + (base >> kRl)) << kColLog) |
                              (base & 31));
    if constexpr (kRl == kC16Log + kColLog) {
#pragma unroll
      for (int j = 0; j < (1 << kR); ++j) v[j] = ld_cluster(map_rank(at, j));
    } else {
#pragma unroll
      for (int j = 0; j < (1 << kR); ++j)
        v[j] = *cluster.map_shared_rank(at, j);
    }
  }
};

// The inverse's exchange, the first column pass (the low k bits: pb0 = 5,
// 2^kR <= H): column-layout position base + (j << 5) = (k + j) * 32 + cl
// of this block is run-layout position ((k + j) % H) * 2^kRl + c0 + cl of
// block k / H (H = 2^(kLs - kCl) runs a block, kRl = kCl + 5).
template <int kLs, int kCl = kClusterLog>
struct FromRuns {
  uint32_t* runs;
  int c0;
  template <int kR>
  __device__ __forceinline__ void load(uint32_t (&v)[1 << kR], int base,
                                       int) const {
    constexpr int kHLog = kLs - kCl;
    constexpr int kRl = kCl + kColLog;
    cg::cluster_group cluster = cg::this_cluster();
    const int k = base >> kColLog;
    const uint32_t* at =
        runs + pad(((k & ((1 << kHLog) - 1)) << kRl) | c0 | (base & 31));
    if constexpr (kCl == kC16Log) {
      const uint32_t src = map_rank(at, k >> kHLog);
#pragma unroll
      for (int j = 0; j < (1 << kR); ++j)
        v[j] = ld_cluster(src + 4 * j * stride(kRl));
    } else {
      const uint32_t* src = cluster.map_shared_rank(at, k >> kHLog);
#pragma unroll
      for (int j = 0; j < (1 << kR); ++j) v[j] = src[j * stride(kRl)];
    }
  }
};

template <int kLs, int kLayouts = 2, int kExTw = 0>
constexpr int cluster_words() {
  // kLayouts layouts of 2^(kLs+5) padded positions (two on the 8-block
  // cluster, one on the 16-block one), then the first half's twiddles and
  // companions (2^kLs each), then the exchange's (kExTw each: ExTw)
  return kLayouts * ((1 << (kLs + kColLog)) + (1 << (kLs + kColLog - 5))) +
         2 * (1 << kLs) + 2 * kExTw;
}

// One row on a cluster of 2^kCl blocks (this block: `rank`) of kNt threads,
// columns of 2^kLs points and runs of 2^kRl, kRl = kCl + 5.  Grid: 2^kCl
// blocks per (batch entry, row), the batch fastest.  The column and the run
// layout take two buffers, or one (kOne), the exchange then held in
// registers across a cluster barrier (pass_held).
template <bool kFwd, int kLs, int kCl, int kNt, bool kOne, int kU,
          typename Tin, typename Tout>
__device__ __forceinline__ void cluster_row(
    const Tin* __restrict__ x, long long x_bs, long long x_rs,
    Tout* __restrict__ y, const uint32_t* __restrict__ w,
    const uint32_t* __restrict__ wsh, const uint32_t* __restrict__ rowc,
    const int32_t* __restrict__ rows, int B, int L, int mont, int vec) {
  constexpr int kRl = kCl + kColLog;
  constexpr int kLogn = kLs + kRl;
  constexpr int kNb = kLs + kColLog;        // positions a block, log2
  constexpr int kWords = (1 << kNb) + (1 << (kNb - 5));
  constexpr int kHLog = kLs - kCl;          // runs a block, log2
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const cols = smem;
  uint32_t* const runs = kOne ? smem : smem + kWords;
  uint32_t* const sw = smem + (kOne ? 1 : 2) * kWords;
  uint32_t* const ssh = sw + (1 << kLs);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = static_cast<int>(blockIdx.x >> kCl);
  const int b = cid % B;
  const int l = cid / B;
  const long long trow = rows[l];
  const uint32_t* tw = w + (trow << kLogn);
  const uint32_t* tsh = wsh + (trow << kLogn);
  const uint32_t* rc = rowc + trow * kRowConsts;
  const uint32_t q = rc[0];
  for (int i = threadIdx.x; i < (1 << kLs); i += kNt) {
    sw[i] = __ldg(tw + i);
    ssh[i] = __ldg(tsh + i);
  }
  const Tin* xr = x + b * x_bs + l * x_rs;
  Tout* yr = y + ((static_cast<long long>(b) * L + l) << kLogn);
  const int h0 = rank << kHLog;
  const int c0 = rank << kColLog;
  const RowCtx<SmemTw> colc{q, SmemTw{sw, ssh},
                            rc + (mont ? kFoldMont : kFoldPlain)};
  const RowCtx<GlobalTw> runc{q, GlobalTw{tw, tsh}, colc.f_};
  // the 16-block cluster's exchange stages (kLs .. kLs+kCl-1) for its runs:
  // 2^kCl - 1 twiddles a run, staged after the first half's
  constexpr int kExTw = ((1 << kCl) - 1) << kHLog;
  uint32_t* const xw = ssh + (1 << kLs);
  if constexpr (kOne) {
    static_assert(kHLog == 5 && kLs == kC16Ls, "ExTw's layout");
    for (int e = threadIdx.x; e < kExTw; e += kNt) {
      const int i = 31 - __clz((e >> kHLog) + 1);
      const int ti = (1 << (kLs + i)) + (h0 << i) + e -
                     (((1 << i) - 1) << kHLog);
      xw[e] = __ldg(tw + ti);
      xw[kExTw + e] = __ldg(tsh + ti);
    }
  }
  const auto exc = [&] {
    if constexpr (kOne)
      return RowCtx<ExTw>{q, ExTw{xw, xw + kExTw, h0}, colc.f_};
    else
      return runc;
  }();
  const SmemBuf cb{cols}, rb{runs};
  // run passes: c bits [5, kRl), [2, 5), [0, 2) at stages kLs, kLs+kCl,
  // kLs+kCl+3
  if (kFwd) {
    __syncthreads();
    // column passes: k bits from the top, 3 at a time (kLs = 9: 3 + 3 + 3;
    // kLs = 8: 3 + 3 + 2), at position bits 5 + k bit
    const ColIn<Tin, kOne> in{xr, c0, q, rc[kMontR], rc[kMontR + 1],
                              mont != 0, kRl};
    pass<3, true, kNt, kU>(kNb, kColLog + kLs - 3, 0, 0, in, cb, colc);
    __syncthreads();
    pass<3, true, kNt, kU>(kNb, kColLog + kLs - 6, 3, 0, cb, cb, colc);
    __syncthreads();
    pass<kLs - 6, true, kNt, kU>(kNb, kColLog, 6, 0, cb, cb, colc);
    cluster.sync();
    if constexpr (kOne) {
      pass_held<kCl, true, kNb, kNt>(5, kLs, h0, FromCols<kRl>{cols, h0},
                                     rb, exc);
      __syncthreads();
    } else {
      pass<kCl, true, kNt, kU>(kNb, 5, kLs, h0, FromCols<kRl>{cols, h0},
                               rb, runc);
      // no block leaves (its shared memory) before every block has read
      // its columns
      cluster.sync();
    }
    pass<3, true, kNt, kU>(kNb, 2, kLs + kCl, h0 << kCl, rb, rb, runc);
    __syncthreads();
    pass<2, true, kNt, kU>(kNb, 0, kLs + kCl + 3, h0 << (kCl + 3), rb,
                           RunOut<Tout>{yr, h0 << kRl}, runc);
  } else {
    const auto in = [&] {
      if constexpr (kOne)
        return RunIn<Tin, true>{xr, h0 << kRl, q, vec != 0, rc[kMontR],
                                rc[kMontR + 1]};
      else
        return RunIn<Tin>{xr, h0 << kRl, q, vec != 0};
    }();
    pass<2, false, kNt, kU>(kNb, 0, kLs + kCl + 3, h0 << (kCl + 3), in, rb,
                            runc);
    __syncthreads();
    pass<3, false, kNt, kU>(kNb, 2, kLs + kCl, h0 << kCl, rb, rb, runc);
    __syncthreads();
    pass<kCl, false, kNt, kU>(kNb, 5, kLs, h0, rb, rb, exc);
    cluster.sync();
    if constexpr (kOne) {
      pass_held<kLs - 6, false, kNb, kNt>(
          kColLog, 6, 0, FromRuns<kLs, kCl>{runs, c0}, cb, colc);
      __syncthreads();
    } else {
      pass<kLs - 6, false, kNt, kU>(kNb, kColLog, 6, 0,
                                    FromRuns<kLs, kCl>{runs, c0}, cb, colc);
      // no block leaves before every block has read its runs
      cluster.sync();
    }
    pass<3, false, kNt, kU>(kNb, kColLog + kLs - 6, 3, 0, cb, cb, colc);
    __syncthreads();
    pass<3, false, kNt, kU>(kNb, kColLog + kLs - 3, 0, 0, cb,
                            ColOut<Tout>{yr, c0, kRl}, colc);
  }
}

// N = 2^16 (kLs = 8), 2^17 (kLs = 9): a cluster of 8.
template <bool kFwd, int kLs, typename Tin, typename Tout>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, kLs == 8 ? kBlocksPerSm : 1)
ntt_cluster(const Tin* __restrict__ x, long long x_bs, long long x_rs,
            Tout* __restrict__ y, const uint32_t* __restrict__ w,
            const uint32_t* __restrict__ wsh,
            const uint32_t* __restrict__ rowc,
            const int32_t* __restrict__ rows, int B, int L, int mont,
            int vec) {
  cluster_row<kFwd, kLs, kClusterLog, kThreads, false, 2>(
      x, x_bs, x_rs, y, w, wsh, rowc, rows, B, L, mont, vec);
}

// N = 2^18: a cluster of 16 (a non-portable size: launched with the
// cluster dimension as a launch attribute, allowed in ntt_setup), columns
// and runs of 2^9, kC16Layouts buffers a block.
template <bool kFwd, typename Tin, typename Tout>
__global__ void __launch_bounds__(kC16Threads, kC16BlocksPerSm)
ntt_cluster16(const Tin* __restrict__ x, long long x_bs, long long x_rs,
              Tout* __restrict__ y, const uint32_t* __restrict__ w,
              const uint32_t* __restrict__ wsh,
              const uint32_t* __restrict__ rowc,
              const int32_t* __restrict__ rows, int B, int L, int mont,
              int vec) {
  cluster_row<kFwd, kC16Ls, kC16Log, kC16Threads, kC16Layouts == 1,
              kC16Unroll>(
      x, x_bs, x_rs, y, w, wsh, rowc, rows, B, L, mont, vec);
}

// ---------------------------------------------------------------------------
// One-block path (N <= 2^15)
// ---------------------------------------------------------------------------

// Each group's row: position p is row (p >> logn) of the block's rows.
struct BlockCtx {
  const uint32_t* __restrict__ w;
  const uint32_t* __restrict__ wsh;
  const uint32_t* __restrict__ rowc;
  const int32_t* __restrict__ rows;
  int fr0, nrows, L, logn, foff;
  __device__ __forceinline__ long long trow(int base) const {
    int fr = fr0 + (base >> logn);
    fr = fr < nrows ? fr : nrows - 1;
    return rows[fr % L];
  }
  __device__ __forceinline__ uint32_t q(int base) const {
    return __ldg(rowc + trow(base) * kRowConsts);
  }
  __device__ __forceinline__ GlobalTw tw(int base) const {
    const long long t = trow(base) << logn;
    return GlobalTw{w + t, wsh + t};
  }
  __device__ __forceinline__ const uint32_t* fold(int base) const {
    return rowc + trow(base) * kRowConsts + foff;
  }
};

// The one-block path's passes, forward order (from the top bit): [5, logn)
// in balanced chunks of at most 3 bits, then [2, 5) and [0, 2) (cut to
// logn).  Returns the count; pb0[i], r[i] the i-th chunk.
__device__ __forceinline__ int block_chunks(int logn, int* pb0, int* r) {
  int n = 0;
  if (logn > 5) {
    const int wid = logn - 5;
    const int cnt = (wid + 2) / 3;
    int hi = logn;
    for (int i = 0; i < cnt; ++i) {
      const int sz = wid / cnt + (i < wid % cnt ? 1 : 0);
      pb0[n] = hi - sz;
      r[n++] = sz;
      hi -= sz;
    }
  }
  if (logn > 2) {
    pb0[n] = 2;
    r[n++] = (logn < 5 ? logn : 5) - 2;
  }
  pb0[n] = 0;
  r[n++] = logn < 2 ? logn : 2;
  return n;
}

template <bool kFwd, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
ntt_block(const Tin* __restrict__ x, long long x_bs, long long x_rs,
          Tout* __restrict__ y, const uint32_t* __restrict__ w,
          const uint32_t* __restrict__ wsh,
          const uint32_t* __restrict__ rowc,
          const int32_t* __restrict__ rows, int B, int L, int logn,
          int mont) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int logt = logn > kTileLog ? logn : kTileLog;
  const int n = 1 << logn;
  const int nrows = B * L;
  const int fr0 = static_cast<int>(blockIdx.x) << (logt - logn);
  for (int e = threadIdx.x; e < (1 << logt); e += kThreads) {
    const int fr = fr0 + (e >> logn);
    uint32_t v = 0;
    if (fr < nrows) {
      const int b = fr / L;
      const int l = fr - b * L;
      const uint32_t* rc = rowc + static_cast<long long>(rows[l]) *
                                      kRowConsts;
      const uint32_t q = __ldg(rc);
      v = load_residue(__ldg(x + b * x_bs + l * x_rs + (e & (n - 1))), q);
      if (kFwd && mont) v = shoup(v, __ldg(rc + kMontR),
                                  __ldg(rc + kMontR + 1), q);
    }
    smem[pad(e)] = v;
  }
  __syncthreads();
  const BlockCtx ctx{w, wsh, rowc, rows, fr0, nrows, L, logn,
                     mont ? kFoldMont : kFoldPlain};
  const SmemBuf sb{smem};
  int pb0[8], r[8];
  const int cnt = block_chunks(logn, pb0, r);
  for (int c = 0; c < cnt; ++c) {
    const int i = kFwd ? c : cnt - 1 - c;
    const int s0 = logn - pb0[i] - r[i];
    if (r[i] == 3) pass<3, kFwd>(logt, pb0[i], s0, 0, sb, sb, ctx);
    else if (r[i] == 2) pass<2, kFwd>(logt, pb0[i], s0, 0, sb, sb, ctx);
    else pass<1, kFwd>(logt, pb0[i], s0, 0, sb, sb, ctx);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < (1 << logt); e += kThreads) {
    const int fr = fr0 + (e >> logn);
    if (fr < nrows)
      put(y + (static_cast<long long>(fr) << logn) + (e & (n - 1)),
          smem[pad(e)]);
  }
}

// ---------------------------------------------------------------------------
// Two-pass path (N >= 2^19): the cluster kernel's two halves as two launches
// ---------------------------------------------------------------------------

// The split of a ring of 2^logn: runs of 2^b (b returned), columns of
// 2^(logn - b) points.
__host__ __device__ constexpr int runs_log(int logn) {
  return logn - kColMaxLog > kRunMinLog ? logn - kColMaxLog : kRunMinLog;
}

// Positions an ntt_runs block holds, log2 (its runs: 2^(that - b)).
__host__ __device__ constexpr int runs_tile(int lb) {
  return lb > kRunsTileLog ? lb : kRunsTileLog;
}

constexpr int block_bytes(int logt) {
  return ((1 << logt) + (1 << (logt - 5))) * 4;
}

// The ntt_runs blocks an SM's shared memory holds (its 233,472 bytes, 1 KB
// of them reserved a block), the register budget its launch bounds give.
constexpr int runs_per_sm(int lb) {
  return 233472 / (block_bytes(runs_tile(lb)) + 1024);
}

constexpr int cols_bytes(int la) {
  // 32 columns of 2^la points (padded), then the first la stages'
  // twiddles and their companions (2^la each)
  return ((1 << (la + kColLog)) + (1 << (la + kColLog - 5)) +
          2 * (1 << la)) * 4;
}

// block_chunks' passes of a buffer of 2^logn positions as a compile-time
// table (the two-pass kernels are built per split, so their passes unroll
// and the table takes no registers or stack).
struct Chunks {
  int n;
  int pb0[8];
  int r[8];
};

__host__ __device__ constexpr Chunks chunk_table(int logn) {
  Chunks t{0, {}, {}};
  if (logn > 5) {
    const int wid = logn - 5;
    const int cnt = (wid + 2) / 3;
    int hi = logn;
    for (int i = 0; i < cnt; ++i) {
      const int sz = wid / cnt + (i < wid % cnt ? 1 : 0);
      t.pb0[t.n] = hi - sz;
      t.r[t.n++] = sz;
      hi -= sz;
    }
  }
  if (logn > 2) {
    t.pb0[t.n] = 2;
    t.r[t.n++] = (logn < 5 ? logn : 5) - 2;
  }
  t.pb0[t.n] = 0;
  t.r[t.n++] = logn < 2 ? logn : 2;
  return t;
}

// Chunk kC of chunk_table(kTab)'s first kCnt (the forward in order, the
// inverse backwards) over a block's 2^kNb positions: the stages from s_top
// - pb0 - r up, the group index bits offset by the block's first run h0
// (shifted to the pass).  The first pass loads from src, the last stores
// to dst, the others work in sb.
template <bool kFwd, int kTab, int kCnt, int kNb, int kC, class Src,
          class Dst, class Ctx>
__device__ __forceinline__ void chunk_pass(int s_top, int h0,
                                           const Src& src, const SmemBuf& sb,
                                           const Dst& dst, const Ctx& ctx) {
  constexpr int i = kFwd ? kC : kCnt - 1 - kC;
  constexpr int pb0 = chunk_table(kTab).pb0[i];
  constexpr int r = chunk_table(kTab).r[i];
  const int s0 = s_top - pb0 - r;
  const int boff = h0 << (kTab - pb0 - r);
  if constexpr (kC == 0) pass<r, kFwd>(kNb, pb0, s0, boff, src, sb, ctx);
  else if constexpr (kC == kCnt - 1)
    pass<r, kFwd>(kNb, pb0, s0, boff, sb, dst, ctx);
  else pass<r, kFwd>(kNb, pb0, s0, boff, sb, sb, ctx);
  if constexpr (kC < kCnt - 1) __syncthreads();
}

template <bool kFwd, int kTab, int kCnt, int kNb, class Src, class Dst,
          class Ctx, int... kC>
__device__ __forceinline__ void chunk_passes(
    std::integer_sequence<int, kC...>, int s_top, int h0, const Src& src,
    const SmemBuf& sb, const Dst& dst, const Ctx& ctx) {
  (chunk_pass<kFwd, kTab, kCnt, kNb, kC>(s_top, h0, src, sb, dst, ctx), ...);
}

// The first kLa stages (the forward's first launch, the inverse's second)
// on 32 adjacent columns {c0 + cl + 2^lb k} of one row: column layout
// position k * 32 + cl, the passes of block_chunks' [5, kLa + 5), from
// global memory to global memory through ColIn/ColOut at a column stride of
// 2^lb.  Grid: B x 2^(lb-5) x L blocks, the batch fastest.  to_mont on load
// (forward) or the folded constants (inverse's stage 0) as `mont` says.
template <bool kFwd, int kLa, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
ntt_cols(const Tin* __restrict__ x, long long x_bs, long long x_rs,
         Tout* __restrict__ y, const uint32_t* __restrict__ w,
         const uint32_t* __restrict__ wsh, const uint32_t* __restrict__ rowc,
         const int32_t* __restrict__ rows, int B, int L, int lb, int mont) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int nb = kLa + kColLog;         // positions a block, log2
  const int logn = kLa + lb;
  uint32_t* const stw = smem + (1 << nb) + (1 << (nb - 5));
  uint32_t* const stsh = stw + (1 << kLa);
  const int bi = static_cast<int>(blockIdx.x) % B;
  const int rest = static_cast<int>(blockIdx.x) / B;
  const int l = rest >> (lb - kColLog);
  const int c0 = (rest & ((1 << (lb - kColLog)) - 1)) << kColLog;
  const long long trow = rows[l];
  const long long toff = trow << logn;
  const uint32_t* rc = rowc + trow * kRowConsts;
  const uint32_t q = rc[0];
  for (int i = threadIdx.x; i < (1 << kLa); i += kThreads) {
    stw[i] = __ldg(w + toff + i);
    stsh[i] = __ldg(wsh + toff + i);
  }
  const Tin* xr = x + bi * x_bs + l * x_rs;
  Tout* yr = y + ((static_cast<long long>(bi) * L + l) << logn);
  const RowCtx<SmemTw> ctx{q, SmemTw{stw, stsh},
                           rc + (mont ? kFoldMont : kFoldPlain)};
  constexpr int cnt = chunk_table(nb).n - 2;    // the chunks of [5, nb)
  __syncthreads();
  chunk_passes<kFwd, nb, cnt, nb>(
      std::make_integer_sequence<int, cnt>{}, nb, 0,
      ColIn<Tin, true>{xr, c0, q, rc[kMontR], rc[kMontR + 1],
                       kFwd && mont != 0, lb},
      SmemBuf{smem}, ColOut<Tout>{yr, c0, lb}, ctx);
}

// The last kLb stages (the forward's second launch, the inverse's first) on
// 2^(nb-kLb) contiguous runs of 2^kLb of one row (nb = runs_tile(kLb)): run
// layout position hl * 2^kLb + c, the passes of block_chunks(kLb), from
// global memory to global memory through RunIn/RunOut (16-byte words where
// the pass is the lowest and `vec` allows), the twiddles through L2.  Grid:
// B x 2^(la-nb+kLb) x L blocks, the batch fastest.
template <bool kFwd, int kLb, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, runs_per_sm(kLb))
ntt_runs(const Tin* __restrict__ x, long long x_bs, long long x_rs,
         Tout* __restrict__ y, const uint32_t* __restrict__ w,
         const uint32_t* __restrict__ wsh, const uint32_t* __restrict__ rowc,
         const int32_t* __restrict__ rows, int B, int L, int la, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int nb = runs_tile(kLb);
  constexpr int hlog = nb - kLb;            // runs a block, log2
  // every stage here is past stage 0: no fold constants (radix's test)
  __builtin_assume(la > 0);
  const int logn = la + kLb;
  const int bi = static_cast<int>(blockIdx.x) % B;
  const int rest = static_cast<int>(blockIdx.x) / B;
  const int l = rest >> (la - hlog);
  const int h0 = (rest & ((1 << (la - hlog)) - 1)) << hlog;
  const long long trow = rows[l];
  const long long toff = trow << logn;
  const uint32_t* rc = rowc + trow * kRowConsts;
  const uint32_t q = rc[0];
  const Tin* xr = x + bi * x_bs + l * x_rs;
  Tout* yr = y + ((static_cast<long long>(bi) * L + l) << logn);
  const RowCtx<GlobalTw> ctx{q, GlobalTw{w + toff, wsh + toff},
                             rc + kFoldPlain};
  constexpr int cnt = chunk_table(kLb).n;
  chunk_passes<kFwd, kLb, cnt, nb>(
      std::make_integer_sequence<int, cnt>{}, logn, h0,
      RunIn<Tin, true>{xr, h0 << kLb, q, vec != 0, rc[kMontR],
                       rc[kMontR + 1]},
      SmemBuf{smem},
      RunOut<Tout>{yr, h0 << kLb}, ctx);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The two-pass kernels of a ring of 2^kLogn and of (Tin, Tout), int32
// between the passes: the forward runs ntt_cols then ntt_runs, the inverse
// ntt_runs then ntt_cols.
template <bool kFwd, int kLogn, typename Tin, typename Tout>
struct TwoPass {
  static constexpr int kLb = runs_log(kLogn);
  static constexpr int kLa = kLogn - kLb;
  static constexpr int kColsBytes = cols_bytes(kLa);
  static constexpr int kRunsBytes = block_bytes(runs_tile(kLb));
  using ColsIn = std::conditional_t<kFwd, Tin, int32_t>;
  using ColsOut = std::conditional_t<kFwd, int32_t, Tout>;
  using RunsIn = std::conditional_t<kFwd, int32_t, Tin>;
  using RunsOut = std::conditional_t<kFwd, Tout, int32_t>;

  static void allow() {
    cudaFuncSetAttribute(ntt_cols<kFwd, kLa, ColsIn, ColsOut>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kColsBytes);
    cudaFuncSetAttribute(ntt_runs<kFwd, kLb, RunsIn, RunsOut>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kRunsBytes);
  }

  // ntt_occupancy's view: both kernels, their bytes and the split.
  static void info(const void** fc, const void** fr, int* bytes, int* out) {
    *fc = reinterpret_cast<const void*>(ntt_cols<kFwd, kLa, ColsIn, ColsOut>);
    *fr = reinterpret_cast<const void*>(ntt_runs<kFwd, kLb, RunsIn, RunsOut>);
    *bytes = kColsBytes;
    out[5] = kRunsBytes;
    out[6] = kLa;
    out[7] = kLb;
  }

  // One transform: the residues in between in mid (int32 [B, L, N],
  // contiguous, neither x nor y: the second launch reads it through
  // ld.global.nc while it writes y).
  static int launch(const Tin* x, long long x_bs, long long x_rs, Tout* y,
                    int32_t* mid, const uint32_t* w, const uint32_t* wsh,
                    const uint32_t* rowc, const int32_t* rows, int B, int L,
                    int mont, int vec, cudaStream_t st) {
    const long long rs = 1LL << kLogn;
    const dim3 gc(static_cast<unsigned>(B * L) << (kLb - kColLog));
    const dim3 gr(static_cast<unsigned>(B * L)
                  << (kLa - runs_tile(kLb) + kLb));
    cudaError_t err;
    if constexpr (kFwd) {
      ntt_cols<kFwd, kLa, ColsIn, ColsOut><<<gc, kThreads, kColsBytes, st>>>(
          x, x_bs, x_rs, mid, w, wsh, rowc, rows, B, L, kLb, mont);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      ntt_runs<kFwd, kLb, RunsIn, RunsOut><<<gr, kThreads, kRunsBytes, st>>>(
          mid, rs * L, rs, y, w, wsh, rowc, rows, B, L, kLa, 1);
    } else {
      ntt_runs<kFwd, kLb, RunsIn, RunsOut><<<gr, kThreads, kRunsBytes, st>>>(
          x, x_bs, x_rs, mid, w, wsh, rowc, rows, B, L, kLa, vec);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      ntt_cols<kFwd, kLa, ColsIn, ColsOut><<<gc, kThreads, kColsBytes, st>>>(
          mid, rs * L, rs, y, w, wsh, rowc, rows, B, L, kLb, mont);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

// The rings of the two-pass path: 2^(kTwoPassMinLog + i), i in Rings.
using Rings = std::make_integer_sequence<int, kMaxLog - kTwoPassMinLog + 1>;

template <bool kFwd, typename Tin, typename Tout, int... kI>
int launch_two_pass(std::integer_sequence<int, kI...>, int logn,
                    const Tin* x, long long x_bs, long long x_rs, Tout* y,
                    int32_t* mid, const uint32_t* w, const uint32_t* wsh,
                    const uint32_t* rowc, const int32_t* rows, int B, int L,
                    int mont, int vec, cudaStream_t st) {
  using Fn = decltype(&TwoPass<kFwd, kTwoPassMinLog, Tin, Tout>::launch);
  static constexpr Fn kLaunch[] = {
      &TwoPass<kFwd, kTwoPassMinLog + kI, Tin, Tout>::launch...};
  return kLaunch[logn - kTwoPassMinLog](x, x_bs, x_rs, y, mid, w, wsh, rowc,
                                        rows, B, L, mont, vec, st);
}

template <bool kFwd, typename Tin, typename Tout, int... kI>
void allow_two_pass(std::integer_sequence<int, kI...>) {
  (TwoPass<kFwd, kTwoPassMinLog + kI, Tin, Tout>::allow(), ...);
}

template <int... kI>
void two_pass_info(std::integer_sequence<int, kI...>, int logn,
                   const void** fc, const void** fr, int* bytes, int* out) {
  using Fn = decltype(&TwoPass<true, kTwoPassMinLog, int32_t, int32_t>::info);
  static constexpr Fn kInfo[] = {
      &TwoPass<true, kTwoPassMinLog + kI, int32_t, int32_t>::info...};
  kInfo[logn - kTwoPassMinLog](fc, fr, bytes, out);
}

constexpr int kCluster16Bytes =
    cluster_words<kC16Ls, kC16Layouts,
                  ((1 << kC16Log) - 1) << (kC16Ls - kC16Log)>() * 4;

// The 2^18 kernel's launch: a cluster of 16 blocks a row.
template <bool kFwd, typename Tin, typename Tout>
cudaError_t launch_cluster16(const Tin* x, long long x_bs, long long x_rs,
                             Tout* y, const uint32_t* w, const uint32_t* wsh,
                             const uint32_t* rowc, const int32_t* rows,
                             int B, int L, int mont, int vec,
                             cudaStream_t st) {
  cudaLaunchAttribute attr[1] = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << kC16Log;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * L) << kC16Log);
  cfg.blockDim = dim3(kC16Threads);
  cfg.dynamicSmemBytes = kCluster16Bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ntt_cluster16<kFwd, Tin, Tout>, x, x_bs,
                            x_rs, y, w, wsh, rowc, rows, B, L, mont, vec);
}

template <bool kFwd, typename Tin, typename Tout>
int launch_typed(const void* xv, long long x_bs, long long x_rs, void* yv,
                 void* scratch, const uint32_t* w, const uint32_t* wsh,
                 const uint32_t* rowc, const int32_t* rows, int B, int L,
                 int logn, int mont, int vec, cudaStream_t st) {
  const auto* x = static_cast<const Tin*>(xv);
  auto* y = static_cast<Tout*>(yv);
  if (logn >= kTwoPassMinLog) {
    auto* mid = static_cast<int32_t*>(scratch);
    if (mid == nullptr || scratch == yv || scratch == xv)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_two_pass<kFwd>(Rings{}, logn, x, x_bs, x_rs, y, mid, w,
                                 wsh, rowc, rows, B, L, mont, vec, st);
  }
  if (logn == kCluster16Log) {
    const cudaError_t err = launch_cluster16<kFwd>(
        x, x_bs, x_rs, y, w, wsh, rowc, rows, B, L, mont, vec, st);
    const cudaError_t last = cudaGetLastError();      // and clear it
    return static_cast<int>(err != cudaSuccess ? err : last);
  }
  if (logn >= kClusterMinLog) {
    const dim3 grid(static_cast<unsigned>(kCluster * B * L));
    if (logn == 16)
      ntt_cluster<kFwd, 8, Tin, Tout>
          <<<grid, kThreads, cluster_words<8>() * 4, st>>>(
              x, x_bs, x_rs, y, w, wsh, rowc, rows, B, L, mont, vec);
    else
      ntt_cluster<kFwd, 9, Tin, Tout>
          <<<grid, kThreads, cluster_words<9>() * 4, st>>>(
              x, x_bs, x_rs, y, w, wsh, rowc, rows, B, L, mont, vec);
  } else {
    const int logt = logn > kTileLog ? logn : kTileLog;
    const int per = 1 << (logt - logn);
    const dim3 grid(static_cast<unsigned>((B * L + per - 1) / per));
    ntt_block<kFwd, Tin, Tout><<<grid, kThreads, block_bytes(logt), st>>>(
        x, x_bs, x_rs, y, w, wsh, rowc, rows, B, L, logn, mont);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kFwd>
int launch(const void* x, long long x_bs, long long x_rs, int in_bytes,
           void* y, int out_bytes, void* scratch, const void* w,
           const void* wsh, const void* rowc, const void* rows, int B, int L,
           int logn, int mont, int vec, void* stream) {
  if (logn < 1 || logn > kMaxLog || B < 1 || L < 1 ||
      (in_bytes != 4 && in_bytes != 8) || (out_bytes != 4 && out_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* tw = static_cast<const uint32_t*>(w);
  const auto* ts = static_cast<const uint32_t*>(wsh);
  const auto* rc = static_cast<const uint32_t*>(rowc);
  const auto* rv = static_cast<const int32_t*>(rows);
  auto st = static_cast<cudaStream_t>(stream);
  if (in_bytes == 4 && out_bytes == 4)
    return launch_typed<kFwd, int32_t, int32_t>(x, x_bs, x_rs, y, scratch, tw,
                                                ts, rc, rv, B, L, logn, mont,
                                                vec, st);
  if (in_bytes == 4)
    return launch_typed<kFwd, int32_t, long long>(x, x_bs, x_rs, y, scratch,
                                                  tw, ts, rc, rv, B, L, logn,
                                                  mont, vec, st);
  if (out_bytes == 4)
    return launch_typed<kFwd, long long, int32_t>(x, x_bs, x_rs, y, scratch,
                                                  tw, ts, rc, rv, B, L, logn,
                                                  mont, vec, st);
  return launch_typed<kFwd, long long, long long>(x, x_bs, x_rs, y, scratch,
                                                  tw, ts, rc, rv, B, L, logn,
                                                  mont, vec, st);
}

template <bool kFwd, typename Tin, typename Tout>
void allow_smem() {
  allow_two_pass<kFwd, Tin, Tout>(Rings{});
  cudaFuncSetAttribute(ntt_cluster16<kFwd, Tin, Tout>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kCluster16Bytes);
  cudaFuncSetAttribute(ntt_cluster16<kFwd, Tin, Tout>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(ntt_cluster<kFwd, 8, Tin, Tout>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       cluster_words<8>() * 4);
  cudaFuncSetAttribute(ntt_cluster<kFwd, 9, Tin, Tout>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       cluster_words<9>() * 4);
  cudaFuncSetAttribute(ntt_block<kFwd, Tin, Tout>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       block_bytes(kClusterMinLog - 1));
}

template <bool kFwd>
void allow_smem_all() {
  allow_smem<kFwd, int32_t, int32_t>();
  allow_smem<kFwd, int32_t, long long>();
  allow_smem<kFwd, long long, int32_t>();
  allow_smem<kFwd, long long, long long>();
}

}  // namespace

// Allows every kernel its dynamic shared memory (and the 16-block cluster
// its non-portable size); call once, outside any CUDA graph capture, before
// the first launch.  Returns cudaGetLastError().
extern "C" int ntt_setup() {
  allow_smem_all<true>();
  allow_smem_all<false>();
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] for the kernel a ring of 2^logn takes (on the two-pass path its
// column pass, ntt_cols): blocks per SM, clusters the card can hold at once
// (0 off the cluster paths), dynamic shared memory bytes a block, threads a
// block; out[4..7] on the two-pass path the run pass's (ntt_runs) blocks
// per SM and bytes a block, and the split a, b (logN = a + b; the column
// pass runs the first a stages), else 0.  Returns a CUDA error code.
extern "C" int ntt_occupancy(int logn, int* out) {
  if (logn < 1 || logn > kMaxLog)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, clusters = 0, bytes, threads = kThreads;
  cudaError_t err;
  out[4] = out[5] = out[6] = out[7] = 0;
  if (logn >= kTwoPassMinLog) {
    const void* fc;
    const void* fr;
    two_pass_info(Rings{}, logn, &fc, &fr, &bytes, out);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fc,
                                                        kThreads, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], fr,
                                                          kThreads, out[5]);
  } else if (logn >= kClusterMinLog) {
    const void* fn = logn == 16
        ? reinterpret_cast<const void*>(
              ntt_cluster<true, 8, int32_t, int32_t>)
        : logn == 17 ? reinterpret_cast<const void*>(
                           ntt_cluster<true, 9, int32_t, int32_t>)
        : reinterpret_cast<const void*>(ntt_cluster16<true, int32_t, int32_t>);
    const int size = logn == kCluster16Log ? 1 << kC16Log : kCluster;
    threads = logn == kCluster16Log ? kC16Threads : kThreads;
    bytes = logn == 16 ? cluster_words<8>() * 4
        : logn == 17 ? cluster_words<9>() * 4 : kCluster16Bytes;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        bytes);
    if (err == cudaSuccess) {
      cudaLaunchAttribute attr[1] = {};
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = size;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(size * 1024);
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = bytes;
      // the 8-block kernels carry their cluster size in __cluster_dims__
      cfg.attrs = logn == kCluster16Log ? attr : nullptr;
      cfg.numAttrs = logn == kCluster16Log ? 1 : 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    }
  } else {
    bytes = block_bytes(logn > kTileLog ? logn : kTileLog);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ntt_block<true, int32_t, int32_t>, kThreads, bytes);
  }
  out[0] = blocks;
  out[1] = clusters;
  out[2] = bytes;
  out[3] = threads;
  return static_cast<int>(err);
}

// Each launches one kernel on `stream` (two for N >= 2^19) and returns
// cudaGetLastError() or the launch's own error (0 on success).  x: [B, L,
// N] with element strides (x_bs, x_rs, 1), in_bytes 4 (int32 residues) or
// 8 (int64, reduced on load); y: [B, L, N] contiguous, out_bytes 4 or 8;
// scratch: int32 [B, L, N] for N >= 2^19 (the residues between the two
// passes; a buffer of its own, neither x nor y), else unused (may be null);
// w/wsh: the forward tables (w, w_sh) for ntt_fwd and the inverse ones
// (wi, wi_sh) for ntt_inv, [L_tot, N]; rowc [L_tot, 11]; rows [L]; mont:
// to_mont on load (forward) or from_mont folded (inverse); vec: x and its
// strides allow 16-byte loads.
extern "C" int ntt_fwd_launch(const void* x, long long x_bs, long long x_rs,
                              int in_bytes, void* y, int out_bytes,
                              void* scratch, const void* w, const void* wsh,
                              const void* rowc, const void* rows, int B,
                              int L, int logn, int mont, int vec,
                              void* stream) {
  return launch<true>(x, x_bs, x_rs, in_bytes, y, out_bytes, scratch, w, wsh,
                      rowc, rows, B, L, logn, mont, vec, stream);
}

extern "C" int ntt_inv_launch(const void* x, long long x_bs, long long x_rs,
                              int in_bytes, void* y, int out_bytes,
                              void* scratch, const void* w, const void* wsh,
                              const void* rowc, const void* rows, int B,
                              int L, int logn, int mont, int vec,
                              void* stream) {
  return launch<false>(x, x_bs, x_rs, in_bytes, y, out_bytes, scratch, w,
                       wsh, rowc, rows, B, L, logn, mont, vec, stream);
}
