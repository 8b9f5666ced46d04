// The hybrid key-switch's two basis conversions and their common epilogue,
// hand-written for Hopper (sm_90a).
//
// Replaces the reference's XLA-lowered elementwise chains:
//   ks_modup    aesfhe_tpu/core/ops_impl.py:ks_decompose (l.497-538), its
//               digit loop (l.516-534): per digit j, y_a = c_a * inv_w_a
//               mod q_a for the digit's limbs a, then
//               out[j, m] = sum_a y_a * conv_w[a, m] mod basis_m over the
//               extended basis (active q primes | special primes);
//   ks_moddown  aesfhe_tpu/core/ops_impl.py:_mod_down_specials (l.697-764),
//               steps 2 and 2b (l.735-757): y_i = d_i * inv_w_i mod p_i
//               over the K special rows, the conversion
//               sum_i y_i * conv_w[i, m] mod q_m and the centred correction
//               - v_hat * (P mod q_m), v_hat = round(sum_i y_i / p_i) in
//               float32;
//   sub_scale   the same function's step 4 (l.760-764), (x - y) * w mod q
//               row by row, which is also the last step of ct_rescale
//               (l.383-386) and ct_rescale_pair (l.456-458).
//
// All residues are canonical (< q <= 2^30) and every digit or special set
// has at most kMaxDigit = 8 primes, so a sum of 8 products of two residues
// stays below 2^63: the conversions accumulate lazily in 64 bits and reduce
// once per output word (Barrett with mu = floor(2^64 / q): the quotient
// estimate is short by at most one, one conditional subtraction).  Single
// products by a constant are Shoup multiplies (w, floor(w * 2^32 / q)).
//
// Bound: bytes.  Each kernel reads its input words and writes its output
// words once: ks_modup reads (l+1) rows and writes J * M rows (at prod_boot's
// top level, J = 7 digits over M = 63 rows of 2^16 words: ~130 MB, ~39 us at
// 3.35 TB/s), ks_moddown reads K rows and writes l+1 rows a component,
// sub_scale reads two rows and writes one.  The integer work (about 8
// 32x32->64 products an output word, one 64-bit Barrett) stays below the
// byte time.  The design therefore streams:
//   - one thread per 4 consecutive coefficients of one row, 16-byte loads
//     and stores, neighbouring threads on neighbouring addresses;
//   - the conversions compute their y_a for their 4 columns once into
//     registers and then loop over a chunk of kRows output rows (the
//     grid's z axis), so the input is read once per chunk (from L2) and
//     every output word is written once; a chunk's conversion constants sit
//     in shared memory;
//   - sub_scale reads its x through a batch and a row stride (a view of
//     the leading rows of a wider tensor), so no caller copies.
// ks_moddown's float32 v_hat follows the port's plain version bit for bit:
// K = 8 as eight rounded products added in halves (t_i + t_{i+4}, then
// + t_{i+2}, then + t_{i+1}); any other K as a fused multiply-add chain from
// 0 in i order; round half to even.  The intrinsics (__fmul_rn, __fadd_rn,
// __fmaf_rn) keep nvcc from contracting the K = 8 order into FMAs.
// Nothing is allocated, nothing synchronises: every launch can be captured
// in a CUDA graph.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxDigit = 8;
constexpr int kRows = 16;

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w,
                                          uint32_t wsh, uint32_t q) {
  const uint32_t r = x * w - __umulhi(x, wsh) * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t reduce64(unsigned long long x,
                                             unsigned long long mu,
                                             uint32_t q) {
  const unsigned long long r = x - __umul64hi(x, mu) * q;
  const uint32_t r32 = static_cast<uint32_t>(r);
  return r32 >= q ? r32 - q : r32;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

__device__ __forceinline__ uint4 shoup4(uint4 v, uint32_t w, uint32_t wsh,
                                        uint32_t q) {
  return make_uint4(shoup(v.x, w, wsh, q), shoup(v.y, w, wsh, q),
                    shoup(v.z, w, wsh, q), shoup(v.w, w, wsh, q));
}

struct Acc4 {
  unsigned long long x, y, z, w;
};

__device__ __forceinline__ void mac4(Acc4& acc, uint4 v, uint32_t c) {
  acc.x += static_cast<unsigned long long>(v.x) * c;
  acc.y += static_cast<unsigned long long>(v.y) * c;
  acc.z += static_cast<unsigned long long>(v.z) * c;
  acc.w += static_cast<unsigned long long>(v.w) * c;
}

__device__ __forceinline__ uint4 reduce4(const Acc4& a,
                                         unsigned long long mu, uint32_t q) {
  return make_uint4(reduce64(a.x, mu, q), reduce64(a.y, mu, q),
                    reduce64(a.z, mu, q), reduce64(a.w, mu, q));
}

// c: [l+1, n4] uint4, canonical residues (the INTT's from_mont output).
// dig: [jlive, 2] (first limb, limb count) of each digit active at l;
// dq, dinv, dinvsh: [jlive, kMaxDigit] each digit limb's prime, inv_w and
// its Shoup companion; conv: [jlive, kMaxDigit, M] conv_w; bq, bmu: [M] the
// basis primes and floor(2^64 / q).  out: [J, M, n4], digit j0 + j; a digit
// at or past jlive is padding and comes out zero.
__global__ void __launch_bounds__(kBlock)
ks_modup_kernel(const uint4* __restrict__ c, const int32_t* __restrict__ dig,
                const uint32_t* __restrict__ dq,
                const uint32_t* __restrict__ dinv,
                const uint32_t* __restrict__ dinvsh,
                const uint32_t* __restrict__ conv,
                const uint32_t* __restrict__ bq,
                const unsigned long long* __restrict__ bmu,
                uint4* __restrict__ out, int j0, int jlive, int M, int n4) {
  __shared__ uint32_t s_conv[kMaxDigit][kRows];
  __shared__ uint32_t s_q[kRows];
  __shared__ unsigned long long s_mu[kRows];
  const int j = blockIdx.y;
  const int jg = j0 + j;
  const int m0 = blockIdx.z * kRows;
  const int rows = min(kRows, M - m0);
  const int live = jg < jlive;
  const int first = live ? dig[2 * jg] : 0;
  const int cnt = live ? dig[2 * jg + 1] : 0;
  for (int t = threadIdx.x; t < kMaxDigit * kRows; t += kBlock) {
    const int a = t / kRows, r = t % kRows;
    s_conv[a][r] = (a < cnt && r < rows)
        ? conv[(static_cast<long long>(jg) * kMaxDigit + a) * M + m0 + r]
        : 0u;
  }
  if (threadIdx.x < rows) {
    s_q[threadIdx.x] = bq[m0 + threadIdx.x];
    s_mu[threadIdx.x] = bmu[m0 + threadIdx.x];
  }
  __syncthreads();
  const int col = blockIdx.x * kBlock + threadIdx.x;
  if (col >= n4) return;
  uint4 y[kMaxDigit];
#pragma unroll
  for (int a = 0; a < kMaxDigit; ++a) {
    if (a < cnt) {
      const int k = jg * kMaxDigit + a;
      y[a] = shoup4(c[static_cast<long long>(first + a) * n4 + col],
                    dinv[k], dinvsh[k], dq[k]);
    } else {
      y[a] = make_uint4(0, 0, 0, 0);
    }
  }
  uint4* o = out + (static_cast<long long>(j) * M + m0) * n4 + col;
  for (int r = 0; r < rows; ++r) {
    Acc4 acc = {0, 0, 0, 0};
#pragma unroll
    for (int a = 0; a < kMaxDigit; ++a) mac4(acc, y[a], s_conv[a][r]);
    o[static_cast<long long>(r) * n4] = reduce4(acc, s_mu[r], s_q[r]);
  }
}

__device__ __forceinline__ uint32_t vhat1(const float* yf,
                                          const float* inv_p, int K) {
  float f;
  if (K == 8) {
    float t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = __fmul_rn(yf[i], inv_p[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = __fadd_rn(t[i], t[i + 4]);
#pragma unroll
    for (int i = 0; i < 2; ++i) t[i] = __fadd_rn(t[i], t[i + 2]);
    f = __fadd_rn(t[0], t[1]);
  } else {
    f = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxDigit; ++i)
      if (i < K) f = __fmaf_rn(yf[i], inv_p[i], f);
  }
  return static_cast<uint32_t>(__float2int_rn(f));
}

// d: [B, K, n4] uint4, the special rows after the INTT (canonical mod p_i).
// sp, sinv, sinvsh: [K] p_i, inv_w_i and its Shoup companion; inv_p: [K]
// float32 1/p_i; conv: [K, R] conv_w; q, mu, pmod, pmodsh: [R] the q
// primes, floor(2^64 / q), P mod q and its Shoup companion.
// out: [B, R, n4] = sum_i y_i conv_w[i, m] - v_hat (P mod q_m) mod q_m.
__global__ void __launch_bounds__(kBlock)
ks_moddown_kernel(const uint4* __restrict__ d,
                  const uint32_t* __restrict__ sp,
                  const uint32_t* __restrict__ sinv,
                  const uint32_t* __restrict__ sinvsh,
                  const float* __restrict__ inv_p,
                  const uint32_t* __restrict__ conv,
                  const uint32_t* __restrict__ q,
                  const unsigned long long* __restrict__ mu,
                  const uint32_t* __restrict__ pmod,
                  const uint32_t* __restrict__ pmodsh,
                  uint4* __restrict__ out, int K, int R, int n4) {
  __shared__ uint32_t s_conv[kMaxDigit][kRows];
  __shared__ uint32_t s_q[kRows], s_pm[kRows], s_pmsh[kRows];
  __shared__ unsigned long long s_mu[kRows];
  const int b = blockIdx.y;
  const int m0 = blockIdx.z * kRows;
  const int rows = min(kRows, R - m0);
  for (int t = threadIdx.x; t < kMaxDigit * kRows; t += kBlock) {
    const int i = t / kRows, r = t % kRows;
    s_conv[i][r] = (i < K && r < rows) ? conv[i * R + m0 + r] : 0u;
  }
  if (threadIdx.x < rows) {
    const int m = m0 + threadIdx.x;
    s_q[threadIdx.x] = q[m];
    s_mu[threadIdx.x] = mu[m];
    s_pm[threadIdx.x] = pmod[m];
    s_pmsh[threadIdx.x] = pmodsh[m];
  }
  __syncthreads();
  const int col = blockIdx.x * kBlock + threadIdx.x;
  if (col >= n4) return;
  uint4 y[kMaxDigit];
  float ip[kMaxDigit];
#pragma unroll
  for (int i = 0; i < kMaxDigit; ++i) {
    if (i < K) {
      y[i] = shoup4(d[(static_cast<long long>(b) * K + i) * n4 + col],
                    sinv[i], sinvsh[i], sp[i]);
      ip[i] = inv_p[i];
    } else {
      y[i] = make_uint4(0, 0, 0, 0);
      ip[i] = 0.0f;
    }
  }
  float fx[kMaxDigit], fy[kMaxDigit], fz[kMaxDigit], fw[kMaxDigit];
#pragma unroll
  for (int i = 0; i < kMaxDigit; ++i) {
    fx[i] = __uint2float_rn(y[i].x);
    fy[i] = __uint2float_rn(y[i].y);
    fz[i] = __uint2float_rn(y[i].z);
    fw[i] = __uint2float_rn(y[i].w);
  }
  const uint4 vh = make_uint4(vhat1(fx, ip, K), vhat1(fy, ip, K),
                              vhat1(fz, ip, K), vhat1(fw, ip, K));
  uint4* o = out + (static_cast<long long>(b) * R + m0) * n4 + col;
  for (int r = 0; r < rows; ++r) {
    Acc4 acc = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < kMaxDigit; ++i) mac4(acc, y[i], s_conv[i][r]);
    const uint32_t qm = s_q[r];
    const uint4 cv = reduce4(acc, s_mu[r], qm);
    const uint4 corr = shoup4(vh, s_pm[r], s_pmsh[r], qm);
    o[static_cast<long long>(r) * n4] =
        make_uint4(sub_mod(cv.x, corr.x, qm), sub_mod(cv.y, corr.y, qm),
                   sub_mod(cv.z, corr.z, qm), sub_mod(cv.w, corr.w, qm));
  }
}

// x: [B, R, n4] uint4 through strides (xb, xr, in uint4 units); y likewise;
// tab: [3, R] q, w, floor(w * 2^32 / q).  out: [B, R, n4] contiguous,
// (x - y) * w mod q.
__global__ void __launch_bounds__(kBlock)
sub_scale_kernel(const uint4* __restrict__ x, long long xb, long long xr,
                 const uint4* __restrict__ y, long long yb, long long yr,
                 const uint32_t* __restrict__ tab, uint4* __restrict__ out,
                 int R, int n4) {
  const int col = blockIdx.x * kBlock + threadIdx.x;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  if (col >= n4) return;
  const uint32_t q = tab[m], w = tab[R + m], wsh = tab[2 * R + m];
  const uint4 a = x[b * xb + m * xr + col];
  const uint4 c = y[b * yb + m * yr + col];
  const uint4 diff = make_uint4(sub_mod(a.x, c.x, q), sub_mod(a.y, c.y, q),
                                sub_mod(a.z, c.z, q), sub_mod(a.w, c.w, q));
  out[(static_cast<long long>(b) * R + m) * n4 + col] =
      shoup4(diff, w, wsh, q);
}

inline unsigned grid_x(int n4) { return (n4 + kBlock - 1) / kBlock; }
inline unsigned chunks(int rows) { return (rows + kRows - 1) / kRows; }

}  // namespace

// Each launcher runs on `stream` and returns cudaGetLastError() (0 on
// success); N is a multiple of 4 and every pointer 16-byte aligned (the
// wrapper checks both).

extern "C" int ks_modup_launch(const void* c, const void* dig,
                               const void* dq, const void* dinv,
                               const void* dinvsh, const void* conv,
                               const void* bq, const void* bmu, void* out,
                               int j0, int J, int jlive, int M, int N,
                               void* stream) {
  const int n4 = N / 4;
  const dim3 grid(grid_x(n4), J, chunks(M));
  ks_modup_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(c), static_cast<const int32_t*>(dig),
      static_cast<const uint32_t*>(dq), static_cast<const uint32_t*>(dinv),
      static_cast<const uint32_t*>(dinvsh),
      static_cast<const uint32_t*>(conv), static_cast<const uint32_t*>(bq),
      static_cast<const unsigned long long*>(bmu), static_cast<uint4*>(out),
      j0, jlive, M, n4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ks_moddown_launch(const void* d, const void* sp,
                                 const void* sinv, const void* sinvsh,
                                 const void* inv_p, const void* conv,
                                 const void* q, const void* mu,
                                 const void* pmod, const void* pmodsh,
                                 void* out, int B, int K, int R, int N,
                                 void* stream) {
  const int n4 = N / 4;
  const dim3 grid(grid_x(n4), B, chunks(R));
  ks_moddown_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(d), static_cast<const uint32_t*>(sp),
      static_cast<const uint32_t*>(sinv),
      static_cast<const uint32_t*>(sinvsh),
      static_cast<const float*>(inv_p), static_cast<const uint32_t*>(conv),
      static_cast<const uint32_t*>(q),
      static_cast<const unsigned long long*>(mu),
      static_cast<const uint32_t*>(pmod),
      static_cast<const uint32_t*>(pmodsh), static_cast<uint4*>(out), K, R,
      n4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sub_scale_launch(const void* x, long long xb, long long xr,
                                const void* y, long long yb, long long yr,
                                const void* tab, void* out, int B, int R,
                                int N, void* stream) {
  const int n4 = N / 4;
  const dim3 grid(grid_x(n4), R, B);
  sub_scale_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), xb / 4, xr / 4,
      static_cast<const uint4*>(y), yb / 4, yr / 4,
      static_cast<const uint32_t*>(tab), static_cast<uint4*>(out), R, n4);
  return static_cast<int>(cudaGetLastError());
}
