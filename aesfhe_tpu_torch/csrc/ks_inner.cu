// Hybrid key-switch digit inner product, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel aesfhe_tpu/core/pallas_ks.py:_kernel, reached from
// both of its entry points: ks_inner_pallas (keys gathered to [J, M, N]) and
// ks_inner_pallas_rows (keys read in their stored, possibly level-capped
// layout through an affine row map in the BlockSpec).  Here the row-index
// vector rows_key (ops_impl._key_rows) is an input, so one kernel serves
// both layouts and reads the stored [dnum, Mk, N] key in place.
//
// Computes, for every limb m < M and coefficient c < N:
//   out[0, m, c] = sum_{j<J} mont_mul(d[j, m, c], key_b[j, rows_key[m], c]) mod q_m
//   out[1, m, c] = the same with key_a
// mont_mul is REDC on the 64-bit product: t = a*b; m = (u32)t * qinv;
// u = (t + m*q) >> 32; u -= q if u >= q -- the same residue as the
// reference's split 16-bit form (aesfhe_tpu/core/rns.py:134-146).  All
// residues are canonical (< q <= 2^30), so t + m*q < 2^63.
//
// Bound: memory.  Every input word is read once and every output word
// written once: (3*J*M + 2*M) * N * 4 bytes, against 6*J*M*N multiply-adds
// of 32-bit integers.  At prod_boot's top level (J=7, M=63, N=2^16) that is
// ~380 MB, ~113 us at 3.35 TB/s; the integer work is far below the card's
// rate.  The design therefore only has to stream at full bandwidth:
//   - one thread per (limb m, 4 consecutive coefficients), 16-byte loads
//     and stores, neighbouring threads on neighbouring addresses;
//   - grid (N / (4 * blockDim), M); each block loads q[m], qinv[m] and
//     rows_key[m] once into shared memory;
//   - the J-digit loop keeps acc_b and acc_a in registers, so nothing but
//     the two results is written.
// Keys are passed with their digit stride (Mk * N words), so a key that
// holds more digits or rows than this switch uses is read in place, with
// no gathered copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t q, uint32_t qinv) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * qinv;
  const uint32_t u =
      static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32);
  return u >= q ? u - q : u;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ void mac4(uint4& acc, const uint4 d,
                                     const uint4 k, uint32_t q,
                                     uint32_t qinv) {
  acc.x = add_mod(acc.x, mont_mul(d.x, k.x, q, qinv), q);
  acc.y = add_mod(acc.y, mont_mul(d.y, k.y, q, qinv), q);
  acc.z = add_mod(acc.z, mont_mul(d.z, k.z, q, qinv), q);
  acc.w = add_mod(acc.w, mont_mul(d.w, k.w, q, qinv), q);
}

constexpr int kBlock = 256;

// d: [J, M, N/4] uint4; kb, ka: [>=J, Mk, N/4] uint4 with digit stride
// key_digit_stride (in uint4 units); out: [2, M, N/4] uint4.
__global__ void __launch_bounds__(kBlock)
ks_inner_kernel(const uint4* __restrict__ d, const uint4* __restrict__ kb,
                const uint4* __restrict__ ka,
                const int32_t* __restrict__ rows_key,
                const uint32_t* __restrict__ q_arr,
                const uint32_t* __restrict__ qinv_arr,
                uint4* __restrict__ out, int J, int M, int n4,
                long long key_digit_stride) {
  __shared__ uint32_t s_q, s_qinv;
  __shared__ long long s_krow;
  const int m = blockIdx.y;
  if (threadIdx.x == 0) {
    s_q = q_arr[m];
    s_qinv = qinv_arr[m];
    s_krow = static_cast<long long>(rows_key[m]) * n4;
  }
  __syncthreads();
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= n4) return;
  const uint32_t q = s_q, qinv = s_qinv;
  const long long drow = static_cast<long long>(m) * n4 + c;
  const long long krow = s_krow + c;
  const long long dstride = static_cast<long long>(M) * n4;
  uint4 acc_b = make_uint4(0, 0, 0, 0);
  uint4 acc_a = make_uint4(0, 0, 0, 0);
  for (int j = 0; j < J; ++j) {
    const uint4 dv = d[j * dstride + drow];
    mac4(acc_b, dv, kb[j * key_digit_stride + krow], q, qinv);
    mac4(acc_a, dv, ka[j * key_digit_stride + krow], q, qinv);
  }
  out[drow] = acc_b;
  out[dstride + drow] = acc_a;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ks_inner_launch(const void* d, const void* kb, const void* ka,
                               const void* rows_key, const void* q,
                               const void* qinv, void* out, int J, int M,
                               int N, long long key_digit_stride_words,
                               void* stream) {
  const int n4 = N / 4;
  const dim3 grid((n4 + kBlock - 1) / kBlock, M);
  ks_inner_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(d), static_cast<const uint4*>(kb),
      static_cast<const uint4*>(ka), static_cast<const int32_t*>(rows_key),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(qinv),
      static_cast<uint4*>(out), J, M, n4, key_digit_stride_words / 4);
  return static_cast<int>(cudaGetLastError());
}
