// Shared pieces of the flash-attention forward and backward kernels
// (flash_attention_fwd.cuh, flash_attention_bwd.cuh) and their two mask
// policies: the key bias of flash_attention and the per-query spans of
// flash_attention_spans.
//
// Operands are (B, H, N, Dh) views given by element strides for the batch,
// head and sequence axes; the head dimension must be contiguous (stride 1).
// That lets the kernels read the transformer's q / k / v straight out of the
// fused qkv product, (B, N, H, Dh) slices, with no layout copy.
//
// Tiles are 64 query rows x 64 keys, staged in shared memory as fp32 with a
// row pitch of DP + 1 (conflict-free column reads); 256 threads arranged
// 16 x 16, thread (ty, tx) owning rows ty + 16 i and columns tx + 16 j,
// i, j < 4. DP is the head dimension rounded up to 32, 64 or 128; padded
// dimensions are loaded as zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kSP = kBK + 1;   // pitch of a (kBQ, kBK) score tile in shared memory
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the TPU kernel's ``.astype(v.dtype)`` casts of
// matmul operands, so the fp32 accumulations see the same operand values.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// Max / sum over the 16 threads (tx) that share a row: lanes differing in
// their low 4 bits.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Stage rows [r0, r0 + 64) of a (n_rows, Dh) strided slice into dst[64][pitch]
// as fp32; rows past n_rows and dimensions past Dh become zeros.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src, long long row_stride,
                                          int r0, int n_rows, int Dh) {
  for (int e = threadIdx.x; e < kBQ * DP; e += kThreads) {
    const int r = e / DP;
    const int d = e - r * DP;
    const int row = r0 + r;
    float v = 0.f;
    if (row < n_rows && d < Dh) v = to_f(src[(long long)row * row_stride + d]);
    dst[r * pitch + d] = v;
  }
}

// ---- mask policies ----
//
// The kernels (flash_attention_fwd.cuh, flash_attention_bwd.cuh) are
// templates over a mask policy. A kernel walks (query tile, key tile) pairs;
// at each pair every thread of the block calls ``tile(sm, q0, k0)`` where the
// loop's leading __syncthreads() would stand. It is that barrier; it stages
// what ``score`` reads for the pair in ``sm`` (visible after the kernel's
// next __syncthreads()); and it returns, alike in every thread, whether any
// query row of the tile may attend any key of it. A pair it rejects is
// skipped: each of its scores would be -1e30 (or -inf), whose exp is exactly
// 0 against a finite row max, and a row with no allowed key at all has
// inv = 0. ``score`` maps the q k^T dot product of query ``row`` (``rl``
// within its tile) and key ``col`` (``cl`` within its tile) to the masked,
// scaled score: -inf for a key past Nk (a tile's ragged tail, which must
// weigh nothing), -1e30 (the TPU kernels' mask value) where the mask
// forbids.

// flash_attention's mask: an additive fp32 key bias (0 / -1e30), then the
// causal cut as a select, as rqvae_tpu/ops/flash_attention.py:_flash_kernel.
struct BiasMask {
  struct Smem {
    float bias[kBK];
  };
  const float* bias;  // (B, Nk) fp32; after at(b), row b
  int Nk, causal;

  __device__ __forceinline__ BiasMask at(int b) const { return {bias + (long long)b * Nk, Nk, causal}; }
  __device__ __forceinline__ bool tile(Smem& sm, int, int k0) const {
    __syncthreads();
    if (threadIdx.x < kBK) sm.bias[threadIdx.x] = k0 + threadIdx.x < Nk ? bias[k0 + threadIdx.x] : 0.f;
    return true;
  }
  __device__ __forceinline__ float score(const Smem& sm, float dot, float scale, int, int cl, int row,
                                         int col) const {
    if (col >= Nk) return -INFINITY;
    const float s = dot * scale + sm.bias[cl];
    return (causal && col > row) ? kNegInf : s;
  }
};

// flash_attention_spans' mask, as rqvae_tpu/ops/flash_attention.py:
// _span_allow: query i attends key j iff lo_i <= j < hi_i or j == extra_i, a
// select after scaling (no bias). For each (query tile, key tile) pair, the
// thread of each query row folds its (lo, hi, extra) into a 64-bit mask of
// the tile's allowed keys (the two compares become a bit range, the
// equality one bit) and stages it; ``score`` reads one bit, so a thread
// loads one word per row it owns. A key tile in which no row has a bit is
// skipped (the packed layout keeps each segment's window contiguous and
// every extra column, a user token, in key tile 0).
__device__ __forceinline__ unsigned long long bits_below(int n) {  // n in [0, 64]
  return n >= 64 ? ~0ull : (1ull << n) - 1ull;
}

struct SpanMask {
  struct Smem {
    unsigned long long allow[kBQ];  // bit j: the row may attend key k0 + j
  };
  const int* lo;  // (B, Nq) int32 each; after at(b), row b
  const int* hi;
  const int* ex;
  int Nq, Nk;
  // the bounds of query row q0 + threadIdx.x (threads < kBQ), kept across
  // key tiles so a query tile reads them from memory once
  int q0 = -1, l = 0, h = 0, x = -1;

  __device__ __forceinline__ SpanMask at(int b) const {
    const long long o = (long long)b * Nq;
    return {lo + o, hi + o, ex + o, Nq, Nk};
  }
  __device__ __forceinline__ bool tile(Smem& sm, int tq0, int k0) {
    if (tq0 != q0) {  // alike in every thread
      q0 = tq0;
      l = 0, h = 0, x = -1;  // rows past Nq attend nothing
      if (threadIdx.x < kBQ && q0 + (int)threadIdx.x < Nq) {
        l = lo[q0 + threadIdx.x];
        h = hi[q0 + threadIdx.x];
        x = ex[q0 + threadIdx.x];
      }
    }
    unsigned long long bits = 0;
    if (threadIdx.x < kBQ) {
      const int k1 = min(k0 + kBK, Nk);
      const int a = min(max(l - k0, 0), kBK), z = min(max(min(h, k1) - k0, 0), kBK);
      bits = bits_below(z) & ~bits_below(a);
      if (x >= k0 && x < k1) bits |= 1ull << (x - k0);
    }
    const int need = __syncthreads_or(bits != 0);
    if (need && threadIdx.x < kBQ) sm.allow[threadIdx.x] = bits;
    return need != 0;
  }
  __device__ __forceinline__ float score(const Smem& sm, float dot, float scale, int rl, int cl,
                                         int, int col) const {
    if (col >= Nk) return -INFINITY;
    return ((sm.allow[rl] >> cl) & 1ull) ? dot * scale : kNegInf;
  }
};

// The row max a kernel stores for the backward: a row that met no key tile
// (all skipped) keeps its initial -inf, which would make the backward's
// exp(s - m) infinite; it stores the -1e30 that a fully masked row has.
__device__ __forceinline__ float stored_max(float m) { return m == -INFINITY ? kNegInf : m; }

inline int dp_for(int Dh) { return Dh <= 32 ? 32 : (Dh <= 64 ? 64 : (Dh <= 128 ? 128 : 0)); }

// ---- tensor-core path: bf16, Dh = 64, mma.sync.m16n8k16 ----
//
// Four warps per block; each warp owns 16 rows of a 64-row tile. Tiles are
// staged in shared memory as bf16 [64][kMP] (a 144-byte pitch, so the eight
// 16-byte rows an ldmatrix reads fall in distinct banks) and read into
// fragments with ldmatrix. Fragment layouts of m16n8k16 (g = lane / 4,
// c = lane % 4): A (16 x 16) a0a1 = (g, 2c..), a2a3 = (g + 8, 2c..),
// a4a5 = (g, 2c + 8..), a6a7 = (g + 8, 2c + 8..); B (16 x 8) b0b1 = (k 2c..,
// n g), b2b3 = (k 2c + 8.., n g); C (16 x 8) c0c1 = (g, 2c..), c2c3 =
// (g + 8, 2c..).
constexpr int kMmaThreads = 128;
constexpr int kMD = 64;        // head dimension of the tensor-core path
constexpr int kMP = kMD + 8;   // bf16 pitch of a staged tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += a b (fp32 accumulate)
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [r0, r0 + 64) of a (n_rows, 64) bf16 slice into dst[64][kMP]
// with 16-byte copies; rows past n_rows become zeros.
__device__ __forceinline__ void load_tile_mma(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              long long row_stride, int r0, int n_rows) {
  for (int e = threadIdx.x; e < 64 * (kMD / 8); e += kMmaThreads) {
    const int r = e / (kMD / 8);
    const int ch = e % (kMD / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n_rows) v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + ch * 8);
    *reinterpret_cast<uint4*>(dst + r * kMP + ch * 8) = v;
  }
}

// A fragments (16 rows x 64 dims, four k-steps of 16) of a warp's 16 rows
// starting at ``row0`` of a staged tile.
__device__ __forceinline__ void load_a_frags(uint32_t f[4][4], const __nv_bfloat16* tile, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    ldsm_x4(f[s], tile + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kMP + 16 * s + 8 * (lane >> 4));
}

// acc[j] (16 x 8 block j of a 16 x 64 result) += A (16 x 64, fragments f) B,
// B[k][n] = tile[n][k] (a product with a staged tile's rows: q k^T, g v^T).
__device__ __forceinline__ void mma_rows_nt(float acc[8][4], const uint32_t f[4][4],
                                            const __nv_bfloat16* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, tile + (16 * jj + (lane & 7) + 8 * (lane >> 4)) * kMP + 16 * s + 8 * ((lane >> 3) & 1));
      mma16816(acc[2 * jj], f[s], b[0], b[1]);
      mma16816(acc[2 * jj + 1], f[s], b[2], b[3]);
    }
}

// acc[j] (16 x 8 block j of a 16 x 64 result) += P (16 x 64 along the
// tile's rows, fp32 values in C layout, rounded to bf16 here) B,
// B[k][n] = tile[k][n] (p v, ds k, p^T g, ds^T q).
__device__ __forceinline__ void mma_rows_nn(float acc[8][4], const float p[8][4],
                                            const __nv_bfloat16* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t a[4] = {pack_bf16(p[2 * t][0], p[2 * t][1]), pack_bf16(p[2 * t][2], p[2 * t][3]),
                           pack_bf16(p[2 * t + 1][0], p[2 * t + 1][1]),
                           pack_bf16(p[2 * t + 1][2], p[2 * t + 1][3])};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + (16 * t + (lane & 7) + 8 * ((lane >> 3) & 1)) * kMP + 16 * jj + 8 * (lane >> 4));
      mma16816(acc[2 * jj], a, b[0], b[1]);
      mma16816(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// Whether a (B, H, N, 64) bf16 operand can be staged with 16-byte copies.
inline bool mma_aligned(const void* p, const long long* st) {
  return ((uintptr_t)p % 16 == 0) && st[0] % 8 == 0 && st[1] % 8 == 0 && st[2] % 8 == 0;
}

template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_optin = 0;
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if ((long long)smem > max_optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace flash
