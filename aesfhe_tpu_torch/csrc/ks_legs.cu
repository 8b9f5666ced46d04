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
// Bound: bytes.  Each kernel reads its input words and writes its output
// words once: ks_modup reads (l+1) rows and writes J * M rows (at prod_boot's
// top level, J = 7 digits over M = 63 rows of 2^16 words: ~130 MB, ~39 us at
// 3.35 TB/s), ks_moddown reads K rows and writes l+1 rows a component,
// sub_scale reads two rows and writes one.
//
// What held the conversions back: they are small matrix products,
// out[m, n] = sum_a conv[a, m] y_a[n] mod q_m over a <= 8 limbs, M <= 64
// rows (any M works, in tiles of 16) and N columns, and written as 8
// widening 32x32->64 multiply-adds and a 64-bit Barrett reduction an output
// word they issued ~40 instructions a word on the 32-bit integer pipe (64
// lanes an SM a clock): issue-bound above the byte time.  The design moves
// the products onto the int8 tensor cores, exactly, in the byte scheme of
// the reference's accelerator NTT on the TPU's matrix unit
// (aesfhe_tpu/core/mxu_ntt.py, l.1-40): the contraction index is
// k = 4a + s over limb a and byte s of y_a (k = 32: one
// mma.sync.m16n8k32.u8.u8.s32), the per-level digit matrices are
// A_e[m, k] = byte_e(conv[a, m] * 256^s * 2^32 mod q_m), and each
// S_e = sum_k A_e[m, k] byte_s(y_a) < 32 * 255^2 < 2^21.  The m16n8k32 B
// fragment gives each thread 4 consecutive k of one column in a register:
// with k = 4a + s those registers are the residues y_a[n] as they are.  The
// fold: L = S_0 + (S_1 << 8) and H = S_2 + (S_3 << 8) (< 2^30), the 64-bit
// x = L + 2^16 H (+ v_hat * (-P 2^32 mod q) in ks_moddown), one Montgomery
// step (the 2^32 in A_e cancels its 2^-32) and an unsigned minimum: ~8
// instructions a word.  A block owns one digit (ks_modup) or one component
// (ks_moddown), kCols columns and every output row:
//   - prologue: the <= 8 input limbs of its columns are read once, the
//     Shoup product y = c * inv_w applied once into shared memory (rows
//     padded so a warp's fragment loads hit 32 banks), and ks_moddown's
//     v_hat computed once a column (a thread owns a column);
//   - products: each warp owns a 16-row tile (its A fragments, 4 x 4
//     registers, loaded once from the table, which is stored in fragment
//     order) and walks its columns 8 at a time: 2 shared-memory loads,
//     4 mma, the fold, two 8-byte stores of two consecutive columns (each
//     warp store fills 8 whole 32-byte sectors);
//   - a digit with fewer than 8 limbs has zeros in both A and y; a padded
//     digit (at or past the level's live ones) writes zeros;
//   - a digit of more than 8 limbs, or more than 8 special primes, is
//     nch = ceil(width / 8) chunks of one k-step each, in one launch of
//     the *_chunks kernels (their own design note below); a width of <= 8
//     takes the kernels above.
// The fold is exact for every odd q below 2^31: r lies in
// (-q, floor(x / 2^32)], and floor(x / 2^32) < 2^15 < q above 2^15, while
// a prime below 2^16 has zero bytes 2 and 3 in A, so H = 0, x < 2^32 and
// r in (-q, 0] (ks_legs.digit_tables checks the bound row by row; for
// summed chunks ks_legs.fold_group).
// ks_moddown's float32 v_hat follows the port's plain version bit for bit
// (ks_legs.vhat_frac, XLA:CPU's order): K = 8 as eight rounded products
// added in halves (t_i + t_{i+4}, then + t_{i+2}, then + t_{i+1}); K >= 16
// the same eight lanes, each accumulating rows l + 8c by fused
// multiply-adds before the halves, then the K % 8 rows left as a fused
// multiply-add chain; any other K as a fused multiply-add chain from 0 in
// i order; round half to even.  The intrinsics (__fmul_rn, __fadd_rn,
// __fmaf_rn) keep nvcc from contracting the halving order into FMAs.
// sub_scale streams: one thread per 4 consecutive coefficients of one row,
// 16-byte loads and stores, x read through a batch and a row stride (a view
// of the leading rows of a wider tensor), so no caller copies.
// Nothing is allocated, nothing synchronises: every launch can be captured
// in a CUDA graph.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxDigit = 8;  // primes a k-step takes (ks_legs.CHUNK)
constexpr int kLanes = 8;     // XLA:CPU's v_hat vector lanes (XLA_LANES)
// Columns a conversion block owns and 8-column tiles a warp takes at a time
// (`legs_variants` times the alternatives on the card).  ks_modup also caps
// its registers at 64 (8 blocks an SM): uncapped it takes ~90 and runs
// slower; ks_moddown's grid fills the card without the cap.
constexpr int kUpCols = 128, kDownCols = 256, kUnroll = 4;
static_assert(kUpCols % 32 == 0 && kDownCols % 32 == 0,
              "a warp's column group must be whole 8-column tiles");

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w,
                                          uint32_t wsh, uint32_t q) {
  const uint32_t r = x * w - __umulhi(x, wsh) * q;
  return r >= q ? r - q : r;
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

// D = A B for one 16x8 tile, k = 32, u8 x u8 -> s32.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "r"(0));
}

// One output row's fold constants: q, q^-1 mod 2^32, and (ks_moddown)
// the correction factor -P 2^32 mod q.
struct Fold {
  uint32_t q, qinv, corr;
};

// sum_e 256^e S_e + vh corr, times 2^-32, mod q.  The digit matrices carry
// the factor 2^32, so this is the conversion (minus vh P).  With
// lo = S_0 + 2^8 S_1 and hi = S_2 + 2^8 S_3 below 2^30 and vh <= K,
// x = lo + 2^16 hi + vh corr < 2^47, and the Montgomery step
// m = x_lo q^-1, x - m q = (x_hi - hi(m q)) 2^32 leaves x_hi - hi(m q) in
// (-q, x_hi], x_hi < q (see the note above): one conditional addition (an
// unsigned minimum) makes it canonical.
__device__ __forceinline__ uint32_t fold4(int s0, int s1, int s2, int s3,
                                          uint32_t vh, const Fold& f) {
  const uint32_t lo = static_cast<uint32_t>(s0) +
                      (static_cast<uint32_t>(s1) << 8);
  const uint32_t hi = static_cast<uint32_t>(s2) +
                      (static_cast<uint32_t>(s3) << 8);
  const unsigned long long x = static_cast<unsigned long long>(hi) * 65536u +
                               lo +
                               static_cast<unsigned long long>(vh) * f.corr;
  const uint32_t m = static_cast<uint32_t>(x) * f.qinv;
  const uint32_t r = static_cast<uint32_t>(x >> 32) - __umulhi(m, f.q);
  return min(r, r + f.q);  // unsigned: r + q wraps below r when r < 0
}

// The block's conversion: out[m, col0 + c] for every row m < M and column
// c < kCols (col0 + c < N) from the y words in s_y (row a = limb a, zero
// past the limbs and past column N) and the digit matrices `afrag`
// [MT][4][32] uint4 in fragment order; fold [3, M].  Warp w takes the
// (row tile, column group) items w, w + kWarps, ...; with MT < kWarps row
// tiles of 16 the columns split into kWarps / MT groups.  A row past M
// computes row M - 1's fold and is not stored.  kDown: subtract
// v_hat (s_vh) P.
template <int kCols, bool kDown>
__device__ __forceinline__ void convert_block(
    const uint32_t (*s_y)[kCols + 8], const uint32_t* s_vh,
    const uint4* __restrict__ afrag, const uint32_t* __restrict__ fold,
    uint32_t* __restrict__ out, int M, int N, int col0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int MT = (M + 15) >> 4;
  const int groups = MT >= kWarps ? 1 : kWarps / MT;
  const int width = kCols / groups;
  for (int item = warp; item < MT * groups; item += kWarps) {
    const int mt = item % MT;
    const int c0 = (item / MT) * width;
    const int cols = min(width, N - col0 - c0);
    uint4 a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = afrag[(mt * 4 + e) * 32 + lane];
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const int m0 = min(r0, M - 1), m1 = min(r1, M - 1);
    const Fold f0{fold[m0], fold[M + m0], fold[2 * M + m0]};
    const Fold f1{fold[m1], fold[M + m1], fold[2 * M + m1]};
    // this thread stores columns i + 2t, i + 2t + 1 of tile i while i < lim
    const int lim0 = r0 < M ? cols - 2 * t : 0;
    const int lim1 = r1 < M ? cols - 2 * t : 0;
    const uint32_t* y0 = s_y[t] + c0 + g;
    const uint32_t* y1 = s_y[t + 4] + c0 + g;
    const uint32_t* vhp = s_vh + c0 + 2 * t;
    const long long at = col0 + c0 + 2 * t;
    uint32_t* p0 = out + static_cast<long long>(m0) * N + at;
    uint32_t* p1 = out + static_cast<long long>(m1) * N + at;
#pragma unroll (kUnroll)
    for (int i = 0; i < cols; i += 8) {
      const uint32_t b0 = y0[i], b1 = y1[i];
      int s[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) mma_u8(s[e], a[e], b0, b1);
      uint2 vh = make_uint2(0, 0);
      if (kDown) vh = *reinterpret_cast<const uint2*>(vhp + i);
      const uint2 v0 =
          make_uint2(fold4(s[0][0], s[1][0], s[2][0], s[3][0], vh.x, f0),
                     fold4(s[0][1], s[1][1], s[2][1], s[3][1], vh.y, f0));
      const uint2 v1 =
          make_uint2(fold4(s[0][2], s[1][2], s[2][2], s[3][2], vh.x, f1),
                     fold4(s[0][3], s[1][3], s[2][3], s[3][3], vh.y, f1));
      if (i < lim0) *reinterpret_cast<uint2*>(p0 + i) = v0;
      if (i < lim1) *reinterpret_cast<uint2*>(p1 + i) = v1;
    }
  }
}

// c: [l+1, n4] uint4, canonical residues (the INTT's from_mont output).
// dig: [jlive, 2] (first limb, limb count) of each digit active at l;
// dq, dinv, dinvsh: [jlive, kMaxDigit] each digit limb's prime, inv_w and
// its Shoup companion; afrag: [jlive, MT, 4, 32] uint4 the digit matrices
// in fragment order; bfold: [3, M] the basis primes' fold constants.
// out: [J, M, N], digit j0 + j; a digit at or past jlive is padding and
// comes out zero.  Grid (ceil(N / kUpCols), J).
__global__ void __launch_bounds__(kBlock, 8)
ks_modup_kernel(const uint4* __restrict__ c, const int32_t* __restrict__ dig,
                const uint32_t* __restrict__ dq,
                const uint32_t* __restrict__ dinv,
                const uint32_t* __restrict__ dinvsh,
                const uint4* __restrict__ afrag,
                const uint32_t* __restrict__ bfold,
                uint32_t* __restrict__ out, int j0, int jlive, int M,
                int N) {
  constexpr int kCols = kUpCols;
  __shared__ __align__(16) uint32_t s_y[kMaxDigit][kCols + 8];
  const int jg = j0 + blockIdx.y;
  const int col0 = blockIdx.x * kCols;
  const int n4 = N / 4;
  uint32_t* o = out + static_cast<long long>(blockIdx.y) * M * N;
  if (jg >= jlive) {
    for (int i = threadIdx.x; i < M * (kCols / 4); i += kBlock) {
      const int m = i / (kCols / 4), col = col0 + 4 * (i % (kCols / 4));
      if (col < N)
        *reinterpret_cast<uint4*>(o + static_cast<long long>(m) * N + col) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int first = dig[2 * jg], cnt = dig[2 * jg + 1];
  for (int i = threadIdx.x; i < kMaxDigit * (kCols / 4); i += kBlock) {
    const int a = i / (kCols / 4), c4 = i % (kCols / 4);
    const int col = col0 + 4 * c4;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (a < cnt && col < N) {
      const int k = jg * kMaxDigit + a;
      v = shoup4(c[static_cast<long long>(first + a) * n4 + col / 4],
                 dinv[k], dinvsh[k], dq[k]);
    }
    *reinterpret_cast<uint4*>(&s_y[a][4 * c4]) = v;
  }
  __syncthreads();
  const int MT = (M + 15) >> 4;
  convert_block<kCols, false>(
      s_y, nullptr, afrag + static_cast<long long>(jg) * MT * 4 * 32, bfold,
      o, M, N, col0);
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

// d: [B, K, N], the special rows after the INTT (canonical mod p_i).
// sp, sinv, sinvsh: [K] p_i, inv_w_i and its Shoup companion; inv_p: [K]
// float32 1/p_i; afrag: [MT, 4, 32] uint4 conv_w's digit matrices in
// fragment order; fold: [3, R] the q primes' fold constants (with the
// correction factor -P 2^32 mod q).
// out: [B, R, N] = sum_i y_i conv_w[i, m] - v_hat (P mod q_m) mod q_m.
// Grid (ceil(N / kDownCols), B).  A thread owns a column in the prologue:
// its K words, their y and its v_hat.
__global__ void __launch_bounds__(kBlock)
ks_moddown_kernel(const uint32_t* __restrict__ d,
                  const uint32_t* __restrict__ sp,
                  const uint32_t* __restrict__ sinv,
                  const uint32_t* __restrict__ sinvsh,
                  const float* __restrict__ inv_p,
                  const uint4* __restrict__ afrag,
                  const uint32_t* __restrict__ fold,
                  uint32_t* __restrict__ out, int K, int R, int N) {
  constexpr int kCols = kDownCols;
  __shared__ __align__(16) uint32_t s_y[kMaxDigit][kCols + 8];
  __shared__ __align__(16) uint32_t s_vh[kCols];
  const int b = blockIdx.y;
  const int col0 = blockIdx.x * kCols;
  for (int c = threadIdx.x; c < kCols; c += kBlock) {
    const int col = col0 + c;
    float yf[kMaxDigit], ip[kMaxDigit];
#pragma unroll
    for (int i = 0; i < kMaxDigit; ++i) {
      uint32_t y = 0;
      if (i < K && col < N)
        y = shoup(d[(static_cast<long long>(b) * K + i) * N + col], sinv[i],
                  sinvsh[i], sp[i]);
      s_y[i][c] = y;
      yf[i] = __uint2float_rn(y);
      ip[i] = i < K ? inv_p[i] : 0.0f;
    }
    s_vh[c] = vhat1(yf, ip, K);
  }
  __syncthreads();
  convert_block<kCols, true>(s_y, s_vh, afrag, fold,
                             out + static_cast<long long>(b) * R * N, R, N,
                             col0);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

// D += A B for one 16x8 tile, k = 32, u8 x u8 -> s32: the chunks' products
// accumulate in the mma's C operand.
__device__ __forceinline__ void mma_u8_acc(int (&d)[4], const uint4& a,
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without registers; valid == false writes zeros
// (the source is not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every group of this thread's copies but the newest one has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// v_hat of one column from its K words y[i * pitch], in vhat1's order for
// any K (ks_legs.vhat_frac).
__device__ __forceinline__ uint32_t vhat_rows(const uint32_t* y, int pitch,
                                              const float* __restrict__ inv_p,
                                              int K) {
  float f = 0.0f;
  int i = 0;
  if (K == kLanes || K >= 2 * kLanes) {
    float u[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
      u[l] = __fmul_rn(__uint2float_rn(y[l * pitch]), __ldg(inv_p + l));
    const int vec = K / kLanes * kLanes;
    for (i = kLanes; i < vec; i += kLanes) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        u[l] = __fmaf_rn(__uint2float_rn(y[(i + l) * pitch]),
                         __ldg(inv_p + i + l), u[l]);
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) u[l] = __fadd_rn(u[l], u[l + 4]);
#pragma unroll
    for (int l = 0; l < 2; ++l) u[l] = __fadd_rn(u[l], u[l + 2]);
    f = __fadd_rn(u[0], u[1]);
  }
  for (; i < K; ++i)
    f = __fmaf_rn(__uint2float_rn(y[i * pitch]), __ldg(inv_p + i), f);
  return static_cast<uint32_t>(__float2int_rn(f));
}

// ---------------------------------------------------------------------------
// The chunked conversions: a digit of more than kMaxDigit limbs, or more
// than kMaxDigit special primes, as nch chunks of one k-step each.
//
// Bound: bytes, 3-8 us at N = 2^16, where a block's latency chain (load,
// Shoup product, v_hat, products, fold) and one wave of blocks weigh.  A
// first design ran, for every 8-column tile and chunk after chunk, four
// __ldg of the chunk's A fragments (L1 traffic of a whole fragment set a
// tile), four mma, a full fold and a modular addition, as one dependent
// chain with no tile unrolled, every digit paying for the widest digit's
// chunks: 9-28 us whatever the size, 21-38% of the bound.  Here:
//   - one fold an output word: the chunks' products accumulate in the
//     mma's s32 C operand.  Each chunk adds S_e < 32 * 255^2 < 2^21; the
//     fold (fold4) needs the sums S_e < 2^31, L = S_0 + 2^8 S_1 and
//     H = S_2 + 2^8 S_3 below 2^32, and floor(x / 2^32) < q for
//     x = L + 2^16 H (+ v_hat corr): then r = x_hi - hi(m q) lies in
//     (-q, x_hi] and one conditional addition makes it canonical.
//     ks_legs.fold_group reads the largest sums the tables' bytes and the
//     inputs' primes allow, row by row, and gives the chunks a fold may
//     take (`group`): all of them up to ~7 chunks of 30-bit primes; past
//     that the kernel folds every `group` chunks and adds the canonical
//     partials mod q (v_hat enters the first fold only);
//   - the A fragments held in registers: a warp owns one 16-row tile and
//     one column group for the block's life and loads its nch x 4 uint4
//     once (instances NCH = 2 and 3, the chunk loop unrolled); other chunk
//     counts, or a fold group below nch, take the NCH = 0 instance, which
//     reads the fragments from L1 a tile and loops at run time;
//   - per-digit chunks: a digit of cnt limbs loads, stores and multiplies
//     ceil(cnt / 8) chunks, not the widest digit's;
//   - loads overlap the products: a block walks column tiles (kChUpCols,
//     kChDownCols; grid: kChWaves waves of the blocks the card holds at
//     once, from the occupancy calculator), the next tile's input rows in
//     flight by cp.async into the other of two shared buffers while this
//     tile converts; the Shoup product y = c inv_w is applied in place by
//     the thread whose copies landed, then the block synchronises;
//   - the block is MT x G warps (MT = ceil(M / 16) row tiles, G column
//     groups, G = kChWarps / MT below kChWarps tiles): no warp idles on a
//     missing tile.
// ---------------------------------------------------------------------------

// Tile columns (ks_modup_chunks, ks_moddown_chunks), 8-column tiles a warp
// takes at once, resident waves of the grid, and warps of a block below
// kChWarps row tiles (`legs_variants` times the alternatives on the card).
constexpr int kChUpCols = 128, kChDownCols = 256, kChUnroll = 4, kChWaves = 1;
constexpr int kChWarps = 4;
constexpr int kChMaxTiles = 16;  // row tiles a block takes: M <= 256
static_assert(kChUpCols % 32 == 0 && kChDownCols % 32 == 0,
              "a column group must be whole 8-column tiles");

__host__ __device__ constexpr int ch_groups(int MT) {
  return MT >= kChWarps ? 1 : kChWarps / MT;
}

// The block's conversion of one column tile [col0, col0 + kCols) from y
// in s_y (limb a of chunk c at row c * kMaxDigit + a, rows of kCols + 8
// words, zero past the limbs and past column N) and the A fragments (`a`
// held, or `af` read for NCH = 0: [nch][MT][4][32] uint4 from the warp's
// tile and lane); nch the chunks of this digit (or special set), group the
// chunks a fold takes.  kDown: subtract v_hat (s_vh) P in the first fold.
template <int NCH, int kCols, bool kDown>
__device__ __forceinline__ void convert_tile(
    const uint32_t* s_y, const uint32_t* s_vh,
    const uint4 (&a)[NCH > 0 ? NCH : 1][4], const uint4* af, long long chunk,
    const Fold& f0, const Fold& f1, uint32_t* __restrict__ out, int M,
    int N, int col0, int c0, int width, int r0, int nch, int group) {
  constexpr int kPitch = kCols + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int cols = min(width, N - col0 - c0);
  const int lim0 = r0 < M ? cols - 2 * t : 0;
  const int lim1 = r0 + 8 < M ? cols - 2 * t : 0;
  const uint32_t* y = s_y + t * kPitch + c0 + g;
  const uint32_t* vhp = s_vh + c0 + 2 * t;
  const long long at = col0 + c0 + 2 * t;
  uint32_t* p0 = out + static_cast<long long>(min(r0, M - 1)) * N + at;
  uint32_t* p1 = out + static_cast<long long>(min(r0 + 8, M - 1)) * N + at;
  // the instance for any chunk count takes one tile at a time: unrolled
  // like the others it spills (ptxas)
#pragma unroll(NCH > 0 ? kChUnroll : 1)
  for (int i = 0; i < cols; i += 8) {
    uint2 vh = make_uint2(0, 0);
    if (kDown) vh = *reinterpret_cast<const uint2*>(vhp + i);
    uint2 v0, v1;
    if (NCH > 0) {
      int s[4][4] = {};
#pragma unroll
      for (int c = 0; c < (NCH > 0 ? NCH : 1); ++c) {
        if (c < nch) {
          const uint32_t b0 = y[c * kMaxDigit * kPitch + i];
          const uint32_t b1 = y[(c * kMaxDigit + 4) * kPitch + i];
#pragma unroll
          for (int e = 0; e < 4; ++e) mma_u8_acc(s[e], a[c][e], b0, b1);
        }
      }
      v0 = make_uint2(fold4(s[0][0], s[1][0], s[2][0], s[3][0], vh.x, f0),
                      fold4(s[0][1], s[1][1], s[2][1], s[3][1], vh.y, f0));
      v1 = make_uint2(fold4(s[0][2], s[1][2], s[2][2], s[3][2], vh.x, f1),
                      fold4(s[0][3], s[1][3], s[2][3], s[3][3], vh.y, f1));
    } else {
      v0 = v1 = make_uint2(0, 0);
      for (int c0g = 0; c0g < nch; c0g += group) {
        int s[4][4] = {};
        for (int c = c0g; c < min(c0g + group, nch); ++c) {
          const uint32_t b0 = y[c * kMaxDigit * kPitch + i];
          const uint32_t b1 = y[(c * kMaxDigit + 4) * kPitch + i];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mma_u8_acc(s[e], __ldg(af + c * chunk + e * 32), b0, b1);
        }
        v0.x = add_mod(v0.x, fold4(s[0][0], s[1][0], s[2][0], s[3][0],
                                   vh.x, f0), f0.q);
        v0.y = add_mod(v0.y, fold4(s[0][1], s[1][1], s[2][1], s[3][1],
                                   vh.y, f0), f0.q);
        v1.x = add_mod(v1.x, fold4(s[0][2], s[1][2], s[2][2], s[3][2],
                                   vh.x, f1), f1.q);
        v1.y = add_mod(v1.y, fold4(s[0][3], s[1][3], s[2][3], s[3][3],
                                   vh.y, f1), f1.q);
        vh = make_uint2(0, 0);
      }
    }
    if (i < lim0) *reinterpret_cast<uint2*>(p0 + i) = v0;
    if (i < lim1) *reinterpret_cast<uint2*>(p1 + i) = v1;
  }
}

// What every chunked block sets up once: its warp's row tile mt, column
// group (offset c0, width of a kCols tile), the fold constants of its two
// rows, and (NCH > 0) its A fragments of the nch chunks.
template <int NCH, int kCols>
struct ChunkWarp {
  int r0, c0, width;
  Fold f0, f1;
  uint4 a[NCH > 0 ? NCH : 1][4];
  const uint4* af;  // this warp's fragments in chunk 0 ([nch][MT][4][32])
  long long chunk;  // uint4 between two chunks' fragments

  __device__ __forceinline__ ChunkWarp(const uint4* __restrict__ afrag,
                                       const uint32_t* __restrict__ fold,
                                       int M, int nch) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int MT = (M + 15) >> 4, G = ch_groups(MT);
    const int mt = warp % MT;
    width = kCols / G;
    c0 = (warp / MT) * width;
    r0 = mt * 16 + (lane >> 2);
    const int m0 = min(r0, M - 1), m1 = min(r0 + 8, M - 1);
    f0 = Fold{fold[m0], fold[M + m0], fold[2 * M + m0]};
    f1 = Fold{fold[m1], fold[M + m1], fold[2 * M + m1]};
    chunk = static_cast<long long>(MT) * 4 * 32;
    af = afrag + mt * 4 * 32 + lane;
#pragma unroll
    for (int c = 0; c < (NCH > 0 ? NCH : 1); ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[c][e] = NCH > 0 && c < nch ? af[c * chunk + e * 32]
                                     : make_uint4(0, 0, 0, 0);
  }
};

// ks_modup_kernel for digits of more than kMaxDigit limbs: dq, dinv,
// dinvsh [jlive, nch * kMaxDigit], afrag [jlive, nch, MT, 4, 32] uint4
// (nch the widest digit's chunks); dynamic shared memory two buffers of
// nch * kMaxDigit rows of kChUpCols + 8 words.  Grid (blocks, J): a block
// walks the column tiles blockIdx.x, + gridDim.x, ... of digit j0 +
// blockIdx.y.
template <int NCH>
__global__ void __launch_bounds__(kChMaxTiles * 32)
ks_modup_chunks_kernel(const uint4* __restrict__ c,
                       const int32_t* __restrict__ dig,
                       const uint32_t* __restrict__ dq,
                       const uint32_t* __restrict__ dinv,
                       const uint32_t* __restrict__ dinvsh,
                       const uint4* __restrict__ afrag,
                       const uint32_t* __restrict__ bfold,
                       uint32_t* __restrict__ out, int j0, int jlive, int M,
                       int N, int nch, int group) {
  constexpr int kCols = kChUpCols, kPitch = kCols + 8;
  extern __shared__ __align__(16) uint32_t s_dyn[];
  const int W = nch * kMaxDigit;
  const int jg = j0 + blockIdx.y;
  const int ntiles = (N + kCols - 1) / kCols;
  const int n4 = N / 4;
  uint32_t* o = out + static_cast<long long>(blockIdx.y) * M * N;
  if (jg >= jlive) {
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
      for (int i = threadIdx.x; i < M * (kCols / 4); i += blockDim.x) {
        const int m = i / (kCols / 4);
        const int col = t * kCols + 4 * (i % (kCols / 4));
        if (col < N)
          *reinterpret_cast<uint4*>(o + static_cast<long long>(m) * N +
                                    col) = make_uint4(0, 0, 0, 0);
      }
    return;
  }
  const int first = dig[2 * jg], cnt = dig[2 * jg + 1];
  const int rows = (cnt + kMaxDigit - 1) / kMaxDigit * kMaxDigit;
  const int words = rows * (kCols / 4);
  const ChunkWarp<NCH, kCols> w(
      afrag + static_cast<long long>(jg) * nch * ((M + 15) >> 4) * 4 * 32,
      bfold, M, rows / kMaxDigit);
  // the rows of tile t into buffer b, zero past the digit's limbs and N
  auto load = [&](int t, int b) {
    uint32_t* buf = s_dyn + b * W * kPitch;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const int a = i / (kCols / 4), c4 = i % (kCols / 4);
      const int col = t * kCols + 4 * c4;
      const bool ok = a < cnt && col < N;
      cp_async16(buf + a * kPitch + 4 * c4,
                 ok ? c + static_cast<long long>(first + a) * n4 + col / 4
                    : c,
                 ok);
    }
  };
  int b = 0;
  if (static_cast<int>(blockIdx.x) < ntiles) load(blockIdx.x, 0);
  cp_async_commit();
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, b ^= 1) {
    if (t + static_cast<int>(gridDim.x) < ntiles) load(t + gridDim.x, b ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    uint32_t* buf = s_dyn + b * W * kPitch;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const int a = i / (kCols / 4), c4 = i % (kCols / 4);
      if (a < cnt) {
        uint4* p = reinterpret_cast<uint4*>(buf + a * kPitch + 4 * c4);
        const int k = jg * W + a;
        *p = shoup4(*p, dinv[k], dinvsh[k], dq[k]);
      }
    }
    __syncthreads();
    convert_tile<NCH, kCols, false>(buf, nullptr, w.a, w.af, w.chunk, w.f0,
                                    w.f1, o, M, N, t * kCols, w.c0, w.width,
                                    w.r0, rows / kMaxDigit, group);
    __syncthreads();
  }
}

// ks_moddown_kernel for more than kMaxDigit special primes: afrag
// [nch, MT, 4, 32] uint4; dynamic shared memory kChDownCols words of v_hat
// and two buffers of nch * kMaxDigit rows of
// kChDownCols + 8 words.  Grid (blocks, B): a block walks the column tiles
// blockIdx.x, + gridDim.x, ... of component blockIdx.y.
template <int NCH>
__global__ void __launch_bounds__(kChMaxTiles * 32)
ks_moddown_chunks_kernel(const uint32_t* __restrict__ d,
                         const uint32_t* __restrict__ sp,
                         const uint32_t* __restrict__ sinv,
                         const uint32_t* __restrict__ sinvsh,
                         const float* __restrict__ inv_p,
                         const uint4* __restrict__ afrag,
                         const uint32_t* __restrict__ fold,
                         uint32_t* __restrict__ out, int K, int R, int N,
                         int nch, int group) {
  constexpr int kCols = kChDownCols, kPitch = kCols + 8;
  extern __shared__ __align__(16) uint32_t s_dyn[];
  uint32_t* s_vh = s_dyn;
  const int W = nch * kMaxDigit;
  const int ntiles = (N + kCols - 1) / kCols;
  const int words = W * (kCols / 4);
  const uint4* dc = reinterpret_cast<const uint4*>(
      d + static_cast<long long>(blockIdx.y) * K * N);
  uint32_t* o = out + static_cast<long long>(blockIdx.y) * R * N;
  const ChunkWarp<NCH, kCols> w(afrag, fold, R, nch);
  auto load = [&](int t, int b) {
    uint32_t* buf = s_dyn + kCols + b * W * kPitch;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const int r = i / (kCols / 4), c4 = i % (kCols / 4);
      const int col = t * kCols + 4 * c4;
      const bool ok = r < K && col < N;
      cp_async16(buf + r * kPitch + 4 * c4,
                 ok ? dc + (static_cast<long long>(r) * N + col) / 4 : dc,
                 ok);
    }
  };
  int b = 0;
  if (static_cast<int>(blockIdx.x) < ntiles) load(blockIdx.x, 0);
  cp_async_commit();
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, b ^= 1) {
    if (t + static_cast<int>(gridDim.x) < ntiles) load(t + gridDim.x, b ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    uint32_t* buf = s_dyn + kCols + b * W * kPitch;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const int r = i / (kCols / 4), c4 = i % (kCols / 4);
      if (r < K) {
        uint4* p = reinterpret_cast<uint4*>(buf + r * kPitch + 4 * c4);
        *p = shoup4(*p, sinv[r], sinvsh[r], sp[r]);
      }
    }
    __syncthreads();
    for (int cl = threadIdx.x; cl < kCols; cl += blockDim.x)
      s_vh[cl] = vhat_rows(buf + cl, kPitch, inv_p, K);
    __syncthreads();
    convert_tile<NCH, kCols, true>(buf, s_vh, w.a, w.af, w.chunk, w.f0,
                                   w.f1, o, R, N, t * kCols, w.c0, w.width,
                                   w.r0, nch, group);
    __syncthreads();
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

}  // namespace

// Each launcher runs on `stream` and returns cudaGetLastError() (0 on
// success); N is a multiple of 4 and every pointer 16-byte aligned (the
// wrapper checks both).

extern "C" int ks_modup_launch(const void* c, const void* dig,
                               const void* dq, const void* dinv,
                               const void* dinvsh, const void* afrag,
                               const void* bfold, void* out, int j0, int J,
                               int jlive, int M, int N, void* stream) {
  const dim3 grid((N + kUpCols - 1) / kUpCols, J);
  ks_modup_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(c), static_cast<const int32_t*>(dig),
      static_cast<const uint32_t*>(dq), static_cast<const uint32_t*>(dinv),
      static_cast<const uint32_t*>(dinvsh), static_cast<const uint4*>(afrag),
      static_cast<const uint32_t*>(bfold), static_cast<uint32_t*>(out), j0,
      jlive, M, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ks_moddown_launch(const void* d, const void* sp,
                                 const void* sinv, const void* sinvsh,
                                 const void* inv_p, const void* afrag,
                                 const void* fold, void* out, int B, int K,
                                 int R, int N, void* stream) {
  const dim3 grid((N + kDownCols - 1) / kDownCols, B);
  ks_moddown_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(d), static_cast<const uint32_t*>(sp),
      static_cast<const uint32_t*>(sinv),
      static_cast<const uint32_t*>(sinvsh),
      static_cast<const float*>(inv_p), static_cast<const uint4*>(afrag),
      static_cast<const uint32_t*>(fold), static_cast<uint32_t*>(out), K, R,
      N);
  return static_cast<int>(cudaGetLastError());
}

// The chunked conversions (nch chunks of kMaxDigit primes, `group` of them
// a fold): the same arguments as the launchers above.  The instance:
// NCH = nch for 2 and 3 chunks folded once, else NCH = 0.  The grid:
// kChWaves times the blocks the card holds at once (the occupancy
// calculator; cached per instance and shape, so a launch inside a CUDA
// graph capture asks nothing), at most one block a column tile.  A kernel
// that needs dynamic shared memory past 48 KB (3 chunks of the mod-down, 6
// of ks_modup) is allowed the card's limit once, or the launch fails.
namespace {

struct ChShape {
  int threads, smem;
};

ChShape ch_shape(bool down, int nch, int M) {
  const int MT = (M + 15) / 16;
  const int cols = down ? kChDownCols : kChUpCols;
  return ChShape{32 * MT * ch_groups(MT),
                 static_cast<int>(sizeof(uint32_t)) *
                     ((down ? cols : 0) + 2 * nch * kMaxDigit * (cols + 8))};
}

// blocks of `kernel` resident at once on the card at this shape
template <typename Kernel>
int ch_resident(Kernel kernel, const ChShape& sh, int* out) {
  struct Entry {
    const void* fn;
    int threads, smem, blocks;
  };
  static Entry cache[32];
  static int used = 0, sms = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].fn == reinterpret_cast<const void*>(kernel) &&
        cache[i].threads == sh.threads && cache[i].smem == sh.smem) {
      *out = cache[i].blocks;
      return 0;
    }
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err && sms == 0)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int optin = 0;
  if (!err && sh.smem > 48 * 1024)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err && sh.smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        sh.threads, sh.smem);
  if (err) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  *out = per_sm * sms;
  if (used < 32) cache[used++] = Entry{reinterpret_cast<const void*>(kernel),
                                       sh.threads, sh.smem, *out};
  return 0;
}

inline int ch_instance(int nch, int group) {
  return (nch == 2 || nch == 3) && group >= nch ? nch : 0;
}

// a grid of (blocks, gy) over column tiles of `cols`: kChWaves resident
// waves of blocks, each walking its tiles
template <typename Kernel, typename... Args>
int ch_launch(Kernel kernel, const ChShape& sh, int cols, int gy, int N,
              void* stream, Args... args) {
  int resident = 0;
  if (const int err = ch_resident(kernel, sh, &resident)) return err;
  const int ntiles = (N + cols - 1) / cols;
  const int gx = min(ntiles, (resident * kChWaves + gy - 1) / gy);
  kernel<<<dim3(gx, gy), sh.threads, sh.smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (threads, dynamic shared bytes) of a chunked launch: out[0], out[1]
extern "C" int ks_chunks_shape(int down, int nch, int M, int* out) {
  if (nch < 1 || M < 1 || (M + 15) / 16 > kChMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const ChShape sh = ch_shape(down != 0, nch, M);
  out[0] = sh.threads;
  out[1] = sh.smem;
  return 0;
}

extern "C" int ks_modup_chunks_launch(const void* c, const void* dig,
                                      const void* dq, const void* dinv,
                                      const void* dinvsh, const void* afrag,
                                      const void* bfold, void* out, int j0,
                                      int J, int jlive, int M, int N, int nch,
                                      int group, void* stream) {
  if (nch < 1 || group < 1 || (M + 15) / 16 > kChMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const ChShape sh = ch_shape(false, nch, M);
  const auto kernel = ch_instance(nch, group) == 2 ? ks_modup_chunks_kernel<2>
                      : ch_instance(nch, group) == 3
                          ? ks_modup_chunks_kernel<3>
                          : ks_modup_chunks_kernel<0>;
  return ch_launch(kernel, sh, kChUpCols, J, N, stream,
                   static_cast<const uint4*>(c),
                   static_cast<const int32_t*>(dig),
                   static_cast<const uint32_t*>(dq),
                   static_cast<const uint32_t*>(dinv),
                   static_cast<const uint32_t*>(dinvsh),
                   static_cast<const uint4*>(afrag),
                   static_cast<const uint32_t*>(bfold),
                   static_cast<uint32_t*>(out), j0, jlive, M, N, nch, group);
}

extern "C" int ks_moddown_chunks_launch(const void* d, const void* sp,
                                        const void* sinv, const void* sinvsh,
                                        const void* inv_p, const void* afrag,
                                        const void* fold, void* out, int B,
                                        int K, int R, int N, int nch,
                                        int group, void* stream) {
  if (nch < 1 || group < 1 || (R + 15) / 16 > kChMaxTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const ChShape sh = ch_shape(true, nch, R);
  const auto kernel = ch_instance(nch, group) == 2
                          ? ks_moddown_chunks_kernel<2>
                      : ch_instance(nch, group) == 3
                          ? ks_moddown_chunks_kernel<3>
                          : ks_moddown_chunks_kernel<0>;
  return ch_launch(kernel, sh, kChDownCols, B, N, stream,
                   static_cast<const uint32_t*>(d),
                   static_cast<const uint32_t*>(sp),
                   static_cast<const uint32_t*>(sinv),
                   static_cast<const uint32_t*>(sinvsh),
                   static_cast<const float*>(inv_p),
                   static_cast<const uint4*>(afrag),
                   static_cast<const uint32_t*>(fold),
                   static_cast<uint32_t*>(out), K, R, N, nch, group);
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
