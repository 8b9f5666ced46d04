// The LUT sums: a ciphertext multiply-accumulate, sum_k ct_k * c_k mod q,
// hand-written for Hopper (sm_90a).
//
// Replaces the reference's XLA-fused elementwise sums (one fusion each):
//   lut_sum        aesfhe_tpu/core/ops_impl.py:ct_linear_combo (l.201):
//                  out = sum_k x_k * (re_k + s_c imz_k) mod q, a slot
//                  constant per term, s_c = -1 on the columns where
//                  xhalf_sign_neg holds, else +1 (x*re + x*imz or
//                  x*re - x*imz, the same residue as x*(re +- imz));
//   lut_sum_dense  the same file's ct_linear_combo_dense (l.229):
//                  out = sum_k x_k * p_k * 2^-32 mod q, a dense Montgomery
//                  plaintext per term.
// In the port they were chains of int64 torch ops, ~21 launches a term
// (scalar) and ~7 (dense), each reading and writing the whole operand at
// 8 bytes a word.  They are EvalMod's Paterson-Stockmeyer leaves, the
// rounds' LUT sums (scalar) and CoeffToSlot's and SlotToCoeff's BSGS sums
// (dense).
//
// Bound: bytes.  Each launch reads every input word once and writes every
// output word once: (K*D + D) * L * N * 4 bytes (plus K * L * N * 4 for the
// dense plaintexts), D = deg+1 components of L limbs; at EvalMod's shape
// (K = 7, D = 2, L = 42, N = 2^16) 176 MB, ~53 us at 3.35 TB/s.  A word
// costs 3 32-bit multiplies (scalar: Shoup) or 3-4 (dense: REDC), far under
// the card's integer rate for 4 bytes read.  So the design only streams:
//   - grid (N / (4 * kBlock), L): a block row per limb; a thread owns 4
//     consecutive columns of that limb in every component (16-byte loads
//     and stores, neighbouring threads on neighbouring addresses);
//   - the K loop runs inside the thread, the D accumulators in registers;
//     the column signs (4 bytes) are read once for all K terms and D
//     components, a dense plaintext word once for the D components;
//   - scalar: a block stages its limb's term constants kTile at a time in
//     shared memory, w+ = re + imz and w- = re - imz mod q with their Shoup
//     companions floor(w 2^32 / q), so a term is one Shoup product;
//   - lazy accumulation in 32 bits: a Shoup product or a REDC without its
//     last subtraction lies in [0, 2q), the accumulator in [0, 2q), their
//     sum below 4q < 2^32 (every prime of the params is below 2^30,
//     params.py), one conditional subtraction of 2q a term; one final
//     subtraction of q gives the canonical residue, so the result equals
//     the plain versions' (core/lut_sum.py) word for word, for any K >= 1
//     and any prime below 2^30.
// Nothing is allocated and nothing synchronises with the host: a launch can
// be captured in a CUDA graph.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 64;      // scalar terms whose constants a block stages

// acc + t folded back below 2q; acc, t < 2q and 4q < 2^32
__device__ __forceinline__ uint32_t lazy_add(uint32_t acc, uint32_t t,
                                             uint32_t q2) {
  const uint32_t s = acc + t;
  return s >= q2 ? s - q2 : s;
}

// x * w mod q in [0, 2q) for any x < 2^32, w < q, sh = floor(w 2^32 / q)
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t x, uint32_t w,
                                               uint32_t sh, uint32_t q) {
  return x * w - __umulhi(x, sh) * q;
}

// x * p * 2^-32 mod q in [0, 2q) for x < 2^32, p < q, qinv = -q^-1 mod 2^32:
// t + m q < 2^33 q < 2^63 and divisible by 2^32
__device__ __forceinline__ uint32_t redc_lazy(uint32_t x, uint32_t p,
                                              uint32_t q, uint32_t qinv) {
  const uint64_t t = static_cast<uint64_t>(x) * p;
  const uint32_t m = static_cast<uint32_t>(t) * qinv;
  return static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32);
}

__device__ __forceinline__ uint32_t canon(uint32_t a, uint32_t q) {
  return a >= q ? a - q : a;
}

__device__ __forceinline__ uint32_t shoup_const(uint32_t w, uint32_t q) {
  return static_cast<uint32_t>((static_cast<uint64_t>(w) << 32) / q);
}

// x: [K, D, L, n4] uint4; consts: [K, L, 4] words (re_w, re_shoup, imz_w,
// imz_shoup; the weights are read, their companions recomputed for w+-);
// neg: [n4] words, byte j the sign of column 4c + j; out: [D, L, n4].
template <int D>
__global__ void __launch_bounds__(kBlock)
lut_sum_scalar(const uint4* __restrict__ x,
               const uint32_t* __restrict__ consts,
               const uint32_t* __restrict__ neg,
               const uint32_t* __restrict__ q_arr, uint4* __restrict__ out,
               int K, int L, int n4) {
  __shared__ uint4 s_w[kTile];
  const int m = blockIdx.y;
  const uint32_t q = q_arr[m], q2 = 2 * q;
  const int c = blockIdx.x * kBlock + threadIdx.x;
  const bool live = c < n4;
  const long long plane = static_cast<long long>(L) * n4;
  const long long row = static_cast<long long>(m) * n4 + c;
  const uint32_t sg = live ? neg[c] : 0;
  const bool n0 = sg & 0xffu, n1 = sg & 0xff00u, n2 = sg & 0xff0000u,
             n3 = sg & 0xff000000u;
  uint4 acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int kt = min(kTile, K - k0);
    if (threadIdx.x < kt) {
      const uint32_t* w =
          consts + (static_cast<long long>(k0 + threadIdx.x) * L + m) * 4;
      const uint32_t re = w[0] % q, im = w[2] % q;
      const uint32_t wp = canon(re + im, q);
      const uint32_t wm = re >= im ? re - im : re + q - im;
      s_w[threadIdx.x] =
          make_uint4(wp, shoup_const(wp, q), wm, shoup_const(wm, q));
    }
    __syncthreads();
    if (live) {
      const uint4* xk = x + static_cast<long long>(k0) * D * plane + row;
#pragma unroll 2
      for (int j = 0; j < kt; ++j) {
        const uint4 w = s_w[j];
        const uint32_t w0 = n0 ? w.z : w.x, h0 = n0 ? w.w : w.y;
        const uint32_t w1 = n1 ? w.z : w.x, h1 = n1 ? w.w : w.y;
        const uint32_t w2 = n2 ? w.z : w.x, h2 = n2 ? w.w : w.y;
        const uint32_t w3 = n3 ? w.z : w.x, h3 = n3 ? w.w : w.y;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const uint4 v = xk[(static_cast<long long>(j) * D + d) * plane];
          acc[d].x = lazy_add(acc[d].x, shoup_lazy(v.x, w0, h0, q), q2);
          acc[d].y = lazy_add(acc[d].y, shoup_lazy(v.y, w1, h1, q), q2);
          acc[d].z = lazy_add(acc[d].z, shoup_lazy(v.z, w2, h2, q), q2);
          acc[d].w = lazy_add(acc[d].w, shoup_lazy(v.w, w3, h3, q), q2);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < D; ++d)
    out[d * plane + row] = make_uint4(canon(acc[d].x, q), canon(acc[d].y, q),
                                      canon(acc[d].z, q), canon(acc[d].w, q));
}

// x: [K, D, L, n4] uint4; pts: K plaintexts of [>= L, n4] uint4, term k at
// k * pts_term4; out: [D, L, n4].
template <int D>
__global__ void __launch_bounds__(kBlock)
lut_sum_dense(const uint4* __restrict__ x, const uint4* __restrict__ pts,
              long long pts_term4, const uint32_t* __restrict__ q_arr,
              const uint32_t* __restrict__ qinv_arr, uint4* __restrict__ out,
              int K, int L, int n4) {
  const int m = blockIdx.y;
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= n4) return;
  const uint32_t q = q_arr[m], q2 = 2 * q, qinv = qinv_arr[m];
  const long long plane = static_cast<long long>(L) * n4;
  const long long row = static_cast<long long>(m) * n4 + c;
  uint4 acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = make_uint4(0, 0, 0, 0);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const uint4 p = pts[k * pts_term4 + row];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const uint4 v = x[(static_cast<long long>(k) * D + d) * plane + row];
      acc[d].x = lazy_add(acc[d].x, redc_lazy(v.x, p.x, q, qinv), q2);
      acc[d].y = lazy_add(acc[d].y, redc_lazy(v.y, p.y, q, qinv), q2);
      acc[d].z = lazy_add(acc[d].z, redc_lazy(v.z, p.z, q, qinv), q2);
      acc[d].w = lazy_add(acc[d].w, redc_lazy(v.w, p.w, q, qinv), q2);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d)
    out[d * plane + row] = make_uint4(canon(acc[d].x, q), canon(acc[d].y, q),
                                      canon(acc[d].z, q), canon(acc[d].w, q));
}

dim3 grid_of(int L, int N) {
  return dim3((N / 4 + kBlock - 1) / kBlock, L);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success);
// D (components) 2 or 3, else cudaErrorInvalidValue without a launch.
extern "C" int lut_sum_scalar_launch(const void* x, const void* consts,
                                     const void* neg, const void* q,
                                     void* out, int K, int D, int L, int N,
                                     void* stream) {
  const auto kernel = D == 2 ? lut_sum_scalar<2>
                      : D == 3 ? lut_sum_scalar<3> : nullptr;
  if (kernel == nullptr || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid_of(L, N), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint32_t*>(consts),
      static_cast<const uint32_t*>(neg), static_cast<const uint32_t*>(q),
      static_cast<uint4*>(out), K, L, N / 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lut_sum_dense_launch(const void* x, const void* pts,
                                    long long pts_term_words, const void* q,
                                    const void* qinv, void* out, int K, int D,
                                    int L, int N, void* stream) {
  const auto kernel = D == 2 ? lut_sum_dense<2>
                      : D == 3 ? lut_sum_dense<3> : nullptr;
  if (kernel == nullptr || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid_of(L, N), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(pts),
      pts_term_words / 4, static_cast<const uint32_t*>(q),
      static_cast<const uint32_t*>(qinv), static_cast<uint4*>(out), K, L,
      N / 4);
  return static_cast<int>(cudaGetLastError());
}
