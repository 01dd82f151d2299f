// Shared pieces of the short-sequence attention kernels
// (flash_attention_small_fwd.cu, flash_attention_small_bwd.cu), the port of
// rqvae_tpu/ops/flash_attention.py:flash_attention_small: Nq, Nk < 256, so
// one CTA stages the whole K and V (and, backward, Q and the upstream
// gradient) of its (batch, head) pairs in shared memory and each query row
// sees its whole score row at once: one max / exp / sum, no online-softmax
// carry, the TPU kernel's order.
//
// The mask is flash_attention's (flash_attention_common.cuh:BiasMask): the
// (B, Nk) key mask as an additive fp32 bias (0 / -1e30) on the scaled
// scores, then the causal cut col <= row (query rows counted from 0, no
// block offset), -inf for the zero-filled keys past Nk.
//
// The fp32 tensor-core kernels (Dh = 64) read their fragments as the
// section at the end of this file sets out: the forward straight from
// global memory into registers, the backward from fp32 rows it stages (q,
// g, a strip's K and V, then e and ds).
//
// Tensor-core tiles (bf16, Dh = 64): a staged operand is [rows][64] bf16 in
// the swizzled 128-byte rows below, padded to a multiple of 16 rows with
// zeros; the e / ds tiles of the backward are [q rows][keys + 8] (an odd
// number of 16-byte chunks a row, so ldmatrix rows fall in distinct banks).
// Fragment layouts are those of flash_attention_common.cuh.
#pragma once

#include "flash_attention_common.cuh"

#include <algorithm>

namespace flash {
namespace small {

constexpr int kMaxLen = 255;    // attend's short route: Nq, Nk < 256
constexpr int kMaxWarps = 8;
constexpr int kSmsH100 = 132;
constexpr long long kPairSmemBudget = 110 * 1024;   // a CTA's pairs stay within it: two CTAs an SM
constexpr long long kOneCtaSmem = 232448;   // the shared memory a CTA may take

// The kernel family a call takes (each library's gate, exported as
// flash_small_{fwd_route,bwd_gate}): fp32 or bf16 FMAs on the CUDA cores,
// bf16 on mma.sync, fp32 as three TF32 products on mma.sync (Dh = 64).
enum Route { kRouteCudaCores = 0, kRouteMmaBf16 = 1, kRouteTf32x3 = 2 };

// The masked, scaled score of key ``col`` for query ``row`` (bias: the
// pair's staged key bias).
__device__ __forceinline__ float score(float dot, float scale, const float* bias, int row, int col,
                                       int Nk, int causal) {
  if (col >= Nk) return -INFINITY;
  const float s = dot * scale + bias[col];
  return (causal && col > row) ? kNegInf : s;
}

// Store a warp's 16 x 64 fp32 accumulator, times ``mul``, as bf16 rows
// row0 + g and row0 + g + 8 (those < n) of a strided slice.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride, int row0,
                                           int n, const float acc[8][4], float mul) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + (long long)row * row_stride + 8 * j + 2 * c) =
          pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

// ---- unpadded, swizzled tiles (the forward; the backward's tiles and rows kernels) ----
//
// A staged operand is [rows][64] bf16 with no pitch padding: 16-byte chunk
// ch of row r lies at chunk ch ^ (r % 8), so the eight rows one ldmatrix
// phase reads fall in distinct banks. 128 bytes a row instead of 144 is what
// lets the backward tiles kernel's ring (two query sides, a key side, e and
// ds), and the forward's two stages, fit twice on an SM at 81 tokens.

// element offset of (r, col) in such a tile
__device__ __forceinline__ int sw(int r, int col) {
  return r * kMD + ((((col >> 3) ^ r) & 7) << 3) + (col & 7);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of the first n_pad rows of a (n, 64) bf16 slice into a
// swizzled tile (rows past n become zeros); threads tid of nthreads share them.
__device__ __forceinline__ void stage_rows_sw(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              long long row_stride, int n, int n_pad, int tid,
                                              int nthreads) {
  for (int e = tid; e < n_pad * 8; e += nthreads) {
    const int r = e >> 3, ch = e & 7;
    const bool ok = r < n;
    cp_async16(dst + sw(r, 8 * ch), ok ? src + (long long)r * row_stride + 8 * ch : src, ok ? 16 : 0);
  }
}

// The same for n_pad fp32 values of a contiguous row (zeros past n).
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int n, int n_pad, int tid,
                                             int nthreads) {
  for (int j = tid; j < n_pad; j += nthreads) {
    const bool ok = j < n;
    cp_async4(dst + j, ok ? src + j : src, ok ? 4 : 0);
  }
}

// A fragments (16 rows x 64 dims, four k-steps of 16) of rows row0.. of a
// swizzled tile.
__device__ __forceinline__ void load_a_sw(uint32_t f[4][4], const __nv_bfloat16* tile, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    ldsm_x4(f[s], tile + sw(row0 + (lane & 7) + 8 * ((lane >> 3) & 1), 16 * s + 8 * (lane >> 4)));
}

// acc0 / acc1 (16 x 8 each: tile rows kr..kr+7 and kr+8..kr+15) += A B with
// A a warp's 16 x 64 fragments and B[k][n] = tile[kr + n][k]: q k^T, g v^T
// and, with k or v as A, their transposes.
__device__ __forceinline__ void mma_nt_sw(float acc0[4], float acc1[4], const uint32_t f[4][4],
                                          const __nv_bfloat16* tile, int kr) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t b[4];
    ldsm_x4(b, tile + sw(kr + (lane & 7) + 8 * (lane >> 4), 16 * s + 8 * ((lane >> 3) & 1)));
    mma16816(acc0, f[s], b[0], b[1]);
    mma16816(acc1, f[s], b[2], b[3]);
  }
}

// A bf16 pair times two fp32 factors, rounded back to a bf16 pair.
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16(f.x * lo, f.y * hi);
}

// acc0 / acc1 (16 x 8 each: dims 16 jj .. + 7 and 16 jj + 8 .. + 15) += A
// B over one k-step of 16 tile rows: A a packed bf16 fragment (registers),
// B[k][n] = tile[kr + k][16 jj + n] (ds k, ds^T q, e^T g). kScale: B's row
// k is first multiplied by rs[kr + k] and rounded to bf16, as bf16(g * inv)
// is formed for dv, with no third staged copy of g.
template <bool kScale>
__device__ __forceinline__ void mma_pa_sw_n16(float acc0[4], float acc1[4], const uint32_t a[4],
                                              const __nv_bfloat16* tile, int kr, const float* rs,
                                              int jj) {
  const int lane = threadIdx.x & 31;
  uint32_t b[4];
  ldsm_x4_t(b, tile + sw(kr + (lane & 7) + 8 * ((lane >> 3) & 1), 16 * jj + 8 * (lane >> 4)));
  if (kScale) {   // b[0], b[2]: rows kr + 2c, +1; b[1], b[3]: rows kr + 8 + 2c, +1
    const int k0 = kr + 2 * (lane & 3);
    const float f0 = rs[k0], f1 = rs[k0 + 1], f2 = rs[k0 + 8], f3 = rs[k0 + 9];
    b[0] = scale_pair(b[0], f0, f1);
    b[2] = scale_pair(b[2], f0, f1);
    b[1] = scale_pair(b[1], f2, f3);
    b[3] = scale_pair(b[3], f2, f3);
  }
  mma16816(acc0, a, b[0], b[1]);
  mma16816(acc1, a, b[2], b[3]);
}

// acc (16 x 64) += A B over one k-step of 16 tile rows, every dim: the four
// quarters of mma_pa_sw_n16.
template <bool kScale>
__device__ __forceinline__ void mma_pa_sw(float acc[8][4], const uint32_t a[4],
                                          const __nv_bfloat16* tile, int kr, const float* rs) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
    mma_pa_sw_n16<kScale>(acc[2 * jj], acc[2 * jj + 1], a, tile, kr, rs, jj);
}

// The A fragment of a 16 x 16 block from its fp32 C fragments (columns 0-7
// in p0, 8-15 in p1), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t a[4], const float p0[4], const float p1[4]) {
  a[0] = pack_bf16(p0[0], p0[1]);
  a[1] = pack_bf16(p0[2], p0[3]);
  a[2] = pack_bf16(p1[0], p1[1]);
  a[3] = pack_bf16(p1[2], p1[3]);
}

// The transpose of an 8 x 8 bf16 block held as a warp's fragment (thread t:
// row t / 4, columns 2 (t % 4) and + 1), in the same layout.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The A fragment of the transpose of a 16 x 16 block given by its A fragment.
__device__ __forceinline__ void transpose_a(uint32_t t[4], const uint32_t a[4]) {
  t[0] = transpose8x8(a[0]);
  t[1] = transpose8x8(a[2]);
  t[2] = transpose8x8(a[1]);
  t[3] = transpose8x8(a[3]);
}

// The live key tiles of a pair from its (Nk) key bias, staged or in global
// memory, as one warp:
// bit t when tile t holds a key with a bias above -5e29 (lanes 0-15 look at
// tile t0, lanes 16-31 at tile t0 + 1); alike in every lane.
template <int KT>
__device__ __forceinline__ unsigned live_mask(const float* bs, int Nk) {
  const int lane = threadIdx.x & 31;
  unsigned mask = 0u;
#pragma unroll
  for (int t0 = 0; t0 < KT; t0 += 2) {
    const int key = 16 * t0 + lane;
    const unsigned live = __ballot_sync(kFull, key < Nk && bs[key] > 0.5f * kNegInf);
    mask |= ((live & 0xffffu) ? 1u : 0u) << t0;
    mask |= ((live >> 16) ? 1u : 0u) << (t0 + 1);
  }
  return mask;
}

// The indices of mask's set bits, ascending, 4 bits each.
template <int KT>
__device__ __forceinline__ unsigned long long tile_list(unsigned mask) {
  unsigned long long idx = 0ull;
  int n = 0;
#pragma unroll
  for (int t = 0; t < KT; ++t)
    if ((mask >> t) & 1u) idx |= (unsigned long long)t << (4 * n++);
  return idx;
}

// ---- fp32, Dh = 64: three TF32 products on mma.sync m16n8k8 ----
//
// The fp32 kernels (small_fwd_tf32_kernel, small_bwd_tf32_kernel) take each
// product as flash_attention_common.cuh's three TF32 products (split_tf32,
// mma_tf32x3). The forward stages nothing: a warp reads its fragments
// straight from the strided operands, 16 bytes a lane, through the
// read-only cache, and splits them in registers (the warps of a pair share
// K and V in L1); the backward reads its staged rows in the same order.
// Two permutations, free because a product sums over its k dimension in any
// order and the kernel places the output's columns itself, make every read
// a float4 of one row:
//   * the head dimension as a product's k (q k^T, g v^T): lane (g, c) reads
//     dims 16 kk + 4 c .. + 3 of its rows; k-step 2 kk takes the first two
//     of them (k indices c, c + 4), k-step 2 kk + 1 the last two;
//   * the head dimension as a product's n (e v, ds k, ds^T q, e^T (g inv)):
//     column g of n-tile n is dim 8 g + n, so lane g reads dims 8 g .. 8 g + 7
//     of a row for all eight n-tiles, and the accumulator's (row, 2 c) /
//     (row, 2 c + 1) of n-tile n is dim 16 c + n / 16 c + 8 + n: 16
//     contiguous dims a lane, four float4 stores a row.
// Keys (e v, ds k) and queries (ds^T q, e^T g) as a product's k are in the
// accumulator's order (flash_attention_common.cuh: key_pos, frag_a_acc):
// k index c is row 2 c of the 8, c + 4 row 2 c + 1.

__device__ __forceinline__ float4 ldg4(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// A fragments of k-steps 2 kk and 2 kk + 1 from dims 16 kk + 4 c .. + 3 of
// rows g (x) and g + 8 (y)
__device__ __forceinline__ void frag_a_dims(const float4& x, const float4& y, uint32_t ab[2][4],
                                            uint32_t as[2][4]) {
  const float a0[4] = {x.x, y.x, x.y, y.y};
  const float a1[4] = {x.z, y.z, x.w, y.w};
  split4(a0, ab[0], as[0]);
  split4(a1, ab[1], as[1]);
}

// s (16 rows x 8 keys) += A B over the 16 dims of A's two k-steps, B from
// dims 16 kk + 4 c .. + 3 of key row g (x)
__device__ __forceinline__ void mma_dims(float s[4], const uint32_t ab[2][4], const uint32_t as[2][4],
                                         const float4& x) {
  uint32_t bb[2], bs[2];
  split_tf32(x.x, bb[0], bs[0]);
  split_tf32(x.y, bb[1], bs[1]);
  mma_tf32x3(s, ab[0], as[0], bb, bs);
  split_tf32(x.z, bb[0], bs[0]);
  split_tf32(x.w, bb[1], bs[1]);
  mma_tf32x3(s, ab[1], as[1], bb, bs);
}

// acc[n] += A B for n-tiles n0 .. n0 + N - 1 of one k-step: A split (ab,
// as), B's k index c from row values r0 (dims 8 g + n0 ..), c + 4 from r1
template <int N>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t ab[4], const uint32_t as[4],
                                         const float r0[N], const float r1[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    uint32_t bb[2], bs[2];
    split_tf32(r0[n], bb[0], bs[0]);
    split_tf32(r1[n], bb[1], bs[1]);
    mma_tf32x3(acc[n], ab, as, bb, bs);
  }
}

// dims 8 g .. 8 g + 7 of a row (zeros when !ok)
__device__ __forceinline__ void load8(float r[8], const float* row, bool ok) {
  const int g = (threadIdx.x & 31) >> 2;
  const float4 a = ldg4(row + 8 * g, ok), b = ldg4(row + 8 * g + 4, ok);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w, r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

// Store n-tiles n0 .. n0 + N - 1 (N = 4 or 8) of a warp's 16-row
// accumulator, times mul[0] / mul[1] (rows g / g + 8), as rows row0 + g and
// row0 + g + 8 (those < n) of a strided fp32 slice: lane (g, c) writes dims
// 16 c + n0 .. and 16 c + 8 + n0 .. of its rows.
template <int N>
__device__ __forceinline__ void store_dims(float* dst, long long row_stride, int row0, int n, int n0,
                                           const float (*acc)[4], const float mul[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    float* p = dst + (long long)row * row_stride + 16 * c + n0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int n4 = 0; n4 < N; n4 += 4)
        *reinterpret_cast<float4*>(p + 8 * hh + n4) =
            make_float4(acc[n4][2 * r + hh] * mul[r], acc[n4 + 1][2 * r + hh] * mul[r],
                        acc[n4 + 2][2 * r + hh] * mul[r], acc[n4 + 3][2 * r + hh] * mul[r]);
  }
}

// Launch a persistent kernel: as many CTAs of ``warps`` warps and ``smem``
// bytes as fit on the device at once, at most ``units`` (the kernel walks
// its units with a stride of the grid).
template <typename Kernel, typename... Args>
inline int launch_persistent(Kernel kernel, int warps, long long smem, int units, int device,
                             cudaStream_t stream, Args... args) {
  cudaError_t err = prepare(kernel, (size_t)smem, device);
  if (err != cudaSuccess) return (int)err;
  const int per_sm = blocks_per_sm(kernel, 32 * warps, (size_t)smem, device);
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long grid = std::min<long long>(units, (long long)per_sm * sm_count(device));
  kernel<<<(unsigned)grid, 32 * warps, (size_t)smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace small
}  // namespace flash
