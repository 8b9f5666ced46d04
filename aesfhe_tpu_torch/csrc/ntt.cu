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
// with the host's companions w_sh = floor(w * 2^32 / q); every stage keeps
// its outputs canonical, so the result equals the plain int64 version's
// residue for residue.  The input is int64 as the port's callers hold it and
// is reduced on load (floor mod), so any int64 gives NTT(x mod q), the plain
// version's result wherever that one does not overflow.
//
// Bound: memory.  Each int64 input word is read once and each int64 output
// word written once: 16 bytes per element, against 3 integer multiplies per
// butterfly (N/2 * logN butterflies per row): at N=2^16 that is 24 multiplies
// per element, ~1.4 ps at the card's 32-bit multiply rate against ~4.8 ps
// for the 16 bytes at 3.35 TB/s.  The design:
//   - two passes for N > 2^12 (one for smaller N, whose row fits one
//     block's shared memory): the first ceil(logN/2) stages as sub-transforms
//     over the strided columns {r + S*k} (S = N >> those stages), then the
//     last floor(logN/2) stages over contiguous runs of 2^floor(logN/2);
//     the inverse runs the two in the other order.  Each pass holds
//     kTile = 4096 residues of one row in shared memory (16 strided columns
//     side by side, so neighbouring threads load neighbouring words) and
//     runs all of its stages there, one __syncthreads() apart;
//   - a uint32 scratch buffer between the passes (the wrapper allocates
//     it), so the data cross device memory as 8 + 4 + 4 + 8 = 24 bytes per
//     element: at most 2/3 of the bound;
//   - grid (groups / groups per block, L, B): one block row per data row and
//     batch entry; a row vector maps each data row to its table row, so one
//     upload of the [L_tot, N] tables serves every row selection.
// Not done here (later work): one launch for both passes, vectorised
// loads, TMA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileLog = 12;            // residues a block holds: 4096
constexpr int kOnePassLog = kTileLog;   // N <= 2^12: one pass
constexpr int kMaxLog = 17;
constexpr int kRowConsts = 5;           // q, ninv, ninv_sh, wi1n, wi1n_sh

__device__ __forceinline__ uint32_t add_q(uint32_t a, uint32_t b,
                                          uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_q(uint32_t a, uint32_t b,
                                          uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// a * w mod q for a < 2^32, w < q < 2^31, wsh = floor(w * 2^32 / q): the
// unreduced value lies in [0, 2q).
__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w,
                                          uint32_t wsh, uint32_t q) {
  const uint32_t r = a * w - __umulhi(a, wsh) * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t load_residue(long long x, uint32_t q) {
  if (static_cast<unsigned long long>(x) < q) return static_cast<uint32_t>(x);
  const long long r = x % static_cast<long long>(q);
  return static_cast<uint32_t>(r < 0 ? r + q : r);
}

__device__ __forceinline__ uint32_t load_residue(uint32_t x, uint32_t) {
  return x;
}

__device__ __forceinline__ void store(long long* p, uint32_t v) { *p = v; }
__device__ __forceinline__ void store(uint32_t* p, uint32_t v) { *p = v; }

// One pass: logp consecutive stages of the 2^logp-point sub-transforms they
// split into, for one row of one batch entry.
//   kStrided: stages 0 .. logp-1; group g < S = N >> logp holds the elements
//             g + S*k, k < 2^logp;
//   else:     stages logN-logp .. logN-1; group g holds g*2^logp + k.
// The block takes 2^logc consecutive groups.  Shared position of (group gl,
// point k): k*C + gl when strided (neighbouring threads on neighbouring
// columns), gl*P + k otherwise; either way the e-th load of the block goes
// to position e.  Forward runs the stages upward, inverse downward.
template <bool kFwd, bool kStrided, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
ntt_pass(const Tin* __restrict__ x, long long x_bs, long long x_rs,
         Tout* __restrict__ y, const uint32_t* __restrict__ w,
         const uint32_t* __restrict__ wsh,
         const uint32_t* __restrict__ rowc,
         const int32_t* __restrict__ rows, int L, int logn, int logp,
         int logc) {
  __shared__ uint32_t buf[1 << kTileLog];
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const long long trow = rows[l];
  const uint32_t* __restrict__ tw = w + (trow << logn);
  const uint32_t* __restrict__ tsh = wsh + (trow << logn);
  const uint32_t* __restrict__ rc = rowc + trow * kRowConsts;
  const uint32_t q = rc[0];
  const int P = 1 << logp;
  const int C = 1 << logc;
  const int E = P << logc;
  const int g0 = blockIdx.x << logc;
  const int col_shift = logn - logp;      // strided: log2 S
  const Tin* __restrict__ xr = x + b * x_bs + l * x_rs;
  Tout* __restrict__ yr = y + ((static_cast<long long>(b) * L + l) << logn);

  for (int e = threadIdx.x; e < E; e += kThreads) {
    const int idx = kStrided
        ? g0 + (e & (C - 1)) + ((e >> logc) << col_shift)
        : (g0 << logp) + e;
    buf[e] = load_residue(xr[idx], q);
  }
  __syncthreads();

  const int s_lo = kStrided ? 0 : logn - logp;
  const int half = E >> 1;
  for (int j = 0; j < logp; ++j) {
    const int s = kFwd ? s_lo + j : s_lo + logp - 1 - j;
    const int logt = logp - 1 - (s - s_lo);     // local half-span, log2
    const int tl = 1 << logt;
    const bool fold = !kFwd && s == 0;
    for (int bf = threadIdx.x; bf < half; bf += kThreads) {
      int gl, i;
      if (kStrided) {
        gl = bf & (C - 1);
        i = bf >> logc;
      } else {
        gl = bf >> (logp - 1);
        i = bf & ((P >> 1) - 1);
      }
      const int ku = ((i >> logt) << (logt + 1)) | (i & (tl - 1));
      const int kv = ku + tl;
      const int idx_u = kStrided ? g0 + gl + (ku << col_shift)
                                 : ((g0 + gl) << logp) + ku;
      const int pu = kStrided ? ku * C + gl : gl * P + ku;
      const int pv = kStrided ? kv * C + gl : gl * P + kv;
      const int ti = (1 << s) + (idx_u >> (logn - s));
      const uint32_t u = buf[pu];
      const uint32_t v = buf[pv];
      if (kFwd) {
        const uint32_t wv = shoup(v, __ldg(tw + ti), __ldg(tsh + ti), q);
        buf[pu] = add_q(u, wv, q);
        buf[pv] = sub_q(u, wv, q);
      } else if (fold) {
        buf[pu] = shoup(add_q(u, v, q), rc[1], rc[2], q);
        buf[pv] = shoup(sub_q(u, v, q), rc[3], rc[4], q);
      } else {
        buf[pu] = add_q(u, v, q);
        buf[pv] = shoup(sub_q(u, v, q), __ldg(tw + ti), __ldg(tsh + ti), q);
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < E; e += kThreads) {
    const int idx = kStrided
        ? g0 + (e & (C - 1)) + ((e >> logc) << col_shift)
        : (g0 << logp) + e;
    store(yr + idx, buf[e]);
  }
}

template <bool kFwd, bool kStrided, typename Tin, typename Tout>
void launch_pass(const Tin* x, long long x_bs, long long x_rs, Tout* y,
                 const uint32_t* w, const uint32_t* wsh,
                 const uint32_t* rowc, const int32_t* rows, int B, int L,
                 int logn, int logp, cudaStream_t stream) {
  const int groups_log = logn - logp;   // sub-transforms per row, log2
  const int logc = groups_log < kTileLog - logp ? groups_log
                                                : kTileLog - logp;
  const dim3 grid(1u << (groups_log - logc), L, B);
  ntt_pass<kFwd, kStrided, Tin, Tout><<<grid, kThreads, 0, stream>>>(
      x, x_bs, x_rs, y, w, wsh, rowc, rows, L, logn, logp, logc);
}

// x: int64 [B, L, N] with element strides (x_bs, x_rs, 1); y: int64
// [B, L, N] contiguous; scratch: uint32 [B, L, N] (unused for N <= 2^12,
// may then be null); w, wsh: [L_tot, N]; rowc: [L_tot, 5]; rows: [L].
template <bool kFwd>
int launch(const void* x, long long x_bs, long long x_rs, void* y,
           void* scratch, const void* w, const void* wsh, const void* rowc,
           const void* rows, int B, int L, int logn, void* stream) {
  if (logn < 1 || logn > kMaxLog || B < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xi = static_cast<const long long*>(x);
  auto* yo = static_cast<long long*>(y);
  auto* sc = static_cast<uint32_t*>(scratch);
  const auto* tw = static_cast<const uint32_t*>(w);
  const auto* ts = static_cast<const uint32_t*>(wsh);
  const auto* rc = static_cast<const uint32_t*>(rowc);
  const auto* rv = static_cast<const int32_t*>(rows);
  auto st = static_cast<cudaStream_t>(stream);
  if (logn <= kOnePassLog) {
    launch_pass<kFwd, false>(xi, x_bs, x_rs, yo, tw, ts, rc, rv, B, L, logn,
                             logn, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (sc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = 1LL << logn;
  const int lc = logn / 2;          // contiguous stages
  const int ls = logn - lc;         // strided stages
  if (kFwd) {
    launch_pass<true, true>(xi, x_bs, x_rs, sc, tw, ts, rc, rv, B, L, logn,
                            ls, st);
    launch_pass<true, false>(static_cast<const uint32_t*>(sc), L * n, n, yo,
                             tw, ts, rc, rv, B, L, logn, lc, st);
  } else {
    launch_pass<false, false>(xi, x_bs, x_rs, sc, tw, ts, rc, rv, B, L, logn,
                              lc, st);
    launch_pass<false, true>(static_cast<const uint32_t*>(sc), L * n, n, yo,
                             tw, ts, rc, rv, B, L, logn, ls, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches its passes on `stream` and returns cudaGetLastError()
// (0 on success).  w/wsh are the forward tables (w, w_sh) for ntt_fwd and
// the inverse ones (wi, wi_sh) for ntt_inv.
extern "C" int ntt_fwd_launch(const void* x, long long x_bs, long long x_rs,
                              void* y, void* scratch, const void* w,
                              const void* wsh, const void* rowc,
                              const void* rows, int B, int L, int logn,
                              void* stream) {
  return launch<true>(x, x_bs, x_rs, y, scratch, w, wsh, rowc, rows, B, L,
                      logn, stream);
}

extern "C" int ntt_inv_launch(const void* x, long long x_bs, long long x_rs,
                              void* y, void* scratch, const void* w,
                              const void* wsh, const void* rowc,
                              const void* rows, int B, int L, int logn,
                              void* stream) {
  return launch<false>(x, x_bs, x_rs, y, scratch, w, wsh, rowc, rows, B, L,
                       logn, stream);
}
