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
// Tensor-core tiles (bf16, Dh = 64): a staged operand is [rows][kMP] bf16
// (flash_attention_common.cuh's 144-byte pitch), rows padded to a multiple of
// 16 with zeros; the e / ds tiles of the backward are [q rows][keys + 8]
// (an odd number of 16-byte chunks a row, so ldmatrix rows fall in distinct
// banks). Fragment layouts are those of flash_attention_common.cuh.
#pragma once

#include "flash_attention_common.cuh"

namespace flash {
namespace small {

constexpr int kMaxLen = 255;    // attend's short route: Nq, Nk < 256
constexpr int kMaxWarps = 8;
constexpr int kSmsH100 = 132;
constexpr long long kPairSmemBudget = 110 * 1024;   // a CTA's pairs stay within it: two CTAs an SM

// Issue the copies of rows [r0, r0 + n_pad) of a (n, 64) bf16 slice into
// dst[n_pad][kMP]; rows past n become zeros. Every thread of the block takes
// part; cp_async_wait_all() and a barrier make them visible.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride, int r0, int n, int n_pad) {
  for (int e = threadIdx.x; e < n_pad * (kMD / 8); e += blockDim.x) {
    const int r = e / (kMD / 8);
    const int ch = e % (kMD / 8);
    const bool ok = r0 + r < n;
    cp_async16(dst + r * kMP + ch * 8, src + (ok ? (long long)(r0 + r) * row_stride + ch * 8 : 0),
               ok ? 16 : 0);
  }
}

// The masked, scaled score of key ``col`` for query ``row`` (bias: the
// pair's staged key bias).
__device__ __forceinline__ float score(float dot, float scale, const float* bias, int row, int col,
                                       int Nk, int causal) {
  if (col >= Nk) return -INFINITY;
  const float s = dot * scale + bias[col];
  return (causal && col > row) ? kNegInf : s;
}

// acc0 / acc1 (16 x 8 each: keys kr..kr+7 and kr+8..kr+15) += A B with A a
// warp's 16 x 64 fragments and B[k][n] = tile[kr + n][k] (q k^T, g v^T).
__device__ __forceinline__ void mma_nt16(float acc0[4], float acc1[4], const uint32_t f[4][4],
                                         const __nv_bfloat16* tile, int kr) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t b[4];
    ldsm_x4(b, tile + (kr + (lane & 7) + 8 * (lane >> 4)) * kMP + 16 * s + 8 * ((lane >> 3) & 1));
    mma16816(acc0, f[s], b[0], b[1]);
    mma16816(acc1, f[s], b[2], b[3]);
  }
}

// acc (16 x 64) += P B over one k-step of 16 tile rows: P (16 x 16, fp32 in
// C layout, keys 0-7 in p0 and 8-15 in p1) rounded to bf16 here, B[k][n] =
// tile[kr + k][n] (p v, ds k).
__device__ __forceinline__ void mma_nn16(float acc[8][4], const float p0[4], const float p1[4],
                                         const __nv_bfloat16* tile, int kr) {
  const int lane = threadIdx.x & 31;
  const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]), pack_bf16(p1[0], p1[1]),
                         pack_bf16(p1[2], p1[3])};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    uint32_t b[4];
    ldsm_x4_t(b, tile + (kr + (lane & 7) + 8 * ((lane >> 3) & 1)) * kMP + 16 * jj + 8 * (lane >> 4));
    mma16816(acc[2 * jj], a, b[0], b[1]);
    mma16816(acc[2 * jj + 1], a, b[2], b[3]);
  }
}

// acc (16 keys x 64) += S^T B over one k-step of 16 query rows: S is a staged
// [q][key] bf16 tile of pitch sp (e or ds), read transposed, keys
// [key0, key0 + 16) and rows [q0, q0 + 16); B[k][n] = tile[q0 + k][n]
// (ds^T q, e^T (g inv)).
__device__ __forceinline__ void mma_tn16(float acc[8][4], const __nv_bfloat16* S, int sp, int key0,
                                         int q0, const __nv_bfloat16* tile) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4];
  ldsm_x4_t(a, S + (q0 + (lane & 7) + 8 * (lane >> 4)) * sp + key0 + 8 * ((lane >> 3) & 1));
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    uint32_t b[4];
    ldsm_x4_t(b, tile + (q0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kMP + 16 * jj + 8 * (lane >> 4));
    mma16816(acc[2 * jj], a, b[0], b[1]);
    mma16816(acc[2 * jj + 1], a, b[2], b[3]);
  }
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

// How many (batch, head) pairs one CTA owns: enough to give it up to
// ``want_warps`` warps of work on short query sides (each warp owns 16 query
// rows of one pair), as long as the pairs' shared memory stays within the
// budget and the grid keeps at least two CTAs for each SM.
inline int pick_group(int BH, int n_qt, long long pair_smem, int want_warps) {
  int G = 1;
  while (2 * G * n_qt <= want_warps && 2 * G * pair_smem <= kPairSmemBudget &&
         (BH + 2 * G - 1) / (2 * G) >= 2 * kSmsH100)
    G *= 2;
  return G;
}

}  // namespace small
}  // namespace flash
