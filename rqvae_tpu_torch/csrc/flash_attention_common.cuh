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

#include <mutex>

namespace flash {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kSP = kBK + 1;   // pitch of a (kBQ, kBK) score tile in shared memory
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;
// the wgmma forward keeps scores in log2 units (s log2 e, so exp(s) = 2^(s log2 e))
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // the mask value in those units

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Asynchronous copies global -> shared (cp.async): ``bytes`` of the source
// are read (16 / 4, or 0), the rest of the destination zero-filled. The
// source address must be valid even when no byte is read. cp_async_commit
// closes a group of copies; cp_async_wait_all closes one and waits for all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
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

// The wgmma forward (flash_attention_fwd.cuh: flash_fwd_wg_kernel) asks a
// policy other questions. Each thread owns two query rows for the whole
// kernel and keeps what the mask needs of them in ``Rows`` (``rows``; a row
// past Nq attends nothing). The key tiles a warpgroup computes are words of
// 32 tiles: ``key_need`` (over the block's threads, tid of n) gives the
// tiles that hold a key some row may attend as far as the keys alone say,
// and in ``mixed`` the tiles whose scores need the per-score mask whatever
// the rows; ``row_need`` the tiles the thread's rows may attend. A tile
// outside both is skipped, exactly as ``tile`` rejects a pair. ``fetch``
// starts the cp.async copies of what ``scores`` reads of a key tile into a
// ring stage (``Stage``). ``scores`` is called by a whole warp on its raw
// q k^T dot products: it returns true, alike in the warp, when the warp's
// rows may attend every key of the tile with nothing added (the caller then
// folds scale log2 e into the exponent), else it writes the masked, scaled
// scores in log2 units (the mask value kNegInf2). The ragged tail of the
// last key tile is the caller's (-inf).

// bits j < 32 of the key tiles t0 + j in [a, z]
__device__ __forceinline__ unsigned tile_range_bits(int a, int z, int t0) {
  const int lo = max(a - t0, 0), hi = min(z - t0, 31);
  if (lo > hi) return 0u;
  return (hi == 31 ? kFull : (1u << (hi + 1)) - 1u) & ~((1u << lo) - 1u);
}

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
  // need / stage: tile() in two halves, for a loop that decides the next
  // pair while the current one computes (flash_attention_bwd.cuh). need()
  // is alike in every thread (here: always, with no barrier); stage()
  // writes what score() reads, visible after the caller's next barrier.
  __device__ __forceinline__ bool need(int, int) const { return true; }
  __device__ __forceinline__ void stage(Smem& sm, int, int k0) const {
    if (threadIdx.x < kBK) sm.bias[threadIdx.x] = k0 + threadIdx.x < Nk ? bias[k0 + threadIdx.x] : 0.f;
  }
  __device__ __forceinline__ float score(const Smem& sm, float dot, float scale, int, int cl, int row,
                                         int col) const {
    if (col >= Nk) return -INFINITY;
    const float s = dot * scale + sm.bias[cl];
    return (causal && col > row) ? kNegInf : s;
  }
  // live: need() that also rules out a pair with nothing to attend, for
  // the fp32 tensor-core backward: a key tile whose every key has a bias
  // <= -5e29 or, under the causal cut, lies past the q tile's last row.
  // Exact: each of its scores weighs exp(-1e30 - m) = 0 against a row with
  // a valid key, and a row with none has inv = 0. A barrier, alike in every
  // thread.
  __device__ __forceinline__ bool live(int q0, int k0) const {
    const int key = k0 + (int)threadIdx.x;
    const bool ok = threadIdx.x < kBK && key < Nk && bias[key] > 0.5f * kNegInf &&
                    (!causal || key <= q0 + kBQ - 1);
    return __syncthreads_or(ok) != 0;
  }

  // ---- the wgmma forward (see above) ----
  // A key tile every key of which has a bias <= -5e29 is skipped (exact for
  // the 0 / -1e30 bias of the wrappers: such a key weighs exp(-1e30 - m) = 0
  // against a row with a valid key, and a row with none has inv = 0); with
  // the causal cut, so is a tile past the block's last row. A tile whose
  // bias is 0 throughout, full and, under the cut, at or below a warp's
  // first row takes no per-score mask. Both warpgroups of a block attend the
  // same key tiles (under the cut all but the diagonal ones), so the
  // schedule is the overlapped one.
  static constexpr bool kFwdOverlap = true;
  struct Rows {
    int r[2];  // the rows, -1 past Nq
  };
  struct Stage {
    float bias[kBK];
  };
  __device__ __forceinline__ Rows rows(int r0, int r1, int Nq) const {
    return {{r0 < Nq ? r0 : -1, r1 < Nq ? r1 : -1}};
  }
  __device__ __forceinline__ unsigned key_need(int t0, int tid, int n, unsigned& mixed) const {
    unsigned need = 0u, mix = 0u;
    const int k1 = min(Nk, (t0 + 32) * kBK);
    for (int key = t0 * kBK + tid; key < k1; key += n) {
      const float x = bias[key];
      const unsigned bit = 1u << ((key >> 6) - t0);
      if (x > 0.5f * kNegInf) need |= bit;
      if (x != 0.f) mix |= bit;
    }
    if (tid == 0 && Nk % kBK != 0) mix |= tile_range_bits((Nk - 1) / kBK, (Nk - 1) / kBK, t0);
    mixed = mix;
    return need;
  }
  __device__ __forceinline__ unsigned row_need(const Rows& rw, int t0) const {
    unsigned bits = 0u;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rw.r[i] >= 0) bits |= tile_range_bits(0, causal ? rw.r[i] / kBK : (Nk - 1) / kBK, t0);
    return bits;
  }
  __device__ __forceinline__ void fetch(Stage& st, int k0, int tid) const {
    if (tid < kBK) {
      const bool ok = k0 + tid < Nk;
      cp_async4(&st.bias[tid], ok ? bias + k0 + tid : bias, ok ? 4 : 0);
    }
  }
  __device__ __forceinline__ bool scores(const Rows& rw, const Stage& st, bool mixed, float s[8][4],
                                         int k0, int warp_row0, float sl2, int c) const {
    if (!mixed && (!causal || k0 + kBK - 1 <= warp_row0)) return true;  // alike in the warp
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(&st.bias[8 * j + 2 * c]);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = k0 + 8 * j + 2 * c + (x & 1);
        const float v = fmaf(s[j][x], sl2, ((x & 1) ? b.y : b.x) * kLog2e);
        s[j][x] = (causal && col > rw.r[x >> 1]) ? kNegInf2 : v;
      }
    }
    return false;
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
  // bit j: whether a row with bounds (l, h, x) may attend key k0 + j
  __device__ __forceinline__ unsigned long long key_bits(int l, int h, int x, int k0) const {
    const int k1 = min(k0 + kBK, Nk);
    const int a = min(max(l - k0, 0), kBK), z = min(max(min(h, k1) - k0, 0), kBK);
    unsigned long long bits = bits_below(z) & ~bits_below(a);
    if (x >= k0 && x < k1) bits |= 1ull << (x - k0);
    return bits;
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
    const unsigned long long bits = threadIdx.x < kBQ ? key_bits(l, h, x, k0) : 0ull;
    const int need = __syncthreads_or(bits != 0);
    if (need && threadIdx.x < kBQ) sm.allow[threadIdx.x] = bits;
    return need != 0;
  }
  // need / stage: tile() in two halves (see BiasMask), reading the bounds
  // of row q0 + threadIdx.x afresh. need() is a barrier.
  __device__ __forceinline__ unsigned long long row_bits(int tq0, int k0) const {
    const int row = tq0 + (int)threadIdx.x;
    if (threadIdx.x >= kBQ || row >= Nq) return 0ull;  // rows past Nq attend nothing
    return key_bits(lo[row], hi[row], ex[row], k0);
  }
  __device__ __forceinline__ bool need(int tq0, int k0) const {
    return __syncthreads_or(row_bits(tq0, k0) != 0ull) != 0;
  }
  __device__ __forceinline__ bool live(int tq0, int k0) const { return need(tq0, k0); }
  __device__ __forceinline__ void stage(Smem& sm, int tq0, int k0) const {
    if (threadIdx.x < kBQ) sm.allow[threadIdx.x] = row_bits(tq0, k0);
  }
  __device__ __forceinline__ float score(const Smem& sm, float dot, float scale, int rl, int cl,
                                         int, int col) const {
    if (col >= Nk) return -INFINITY;
    return ((sm.allow[rl] >> cl) & 1ull) ? dot * scale : kNegInf;
  }

  // ---- the wgmma forward (see above) ----
  // The thread keeps its two rows' bounds in registers and folds them into
  // each tile's 64-bit key mask itself: nothing is staged. A warp whose
  // rows all attend every key of a (full) tile takes no per-score select.
  // The two warpgroups of a block often cover different packed segments, so
  // the schedule is the serial one, in which each skips the key tiles its
  // rows do not attend.
  static constexpr bool kFwdOverlap = false;
  struct Rows {
    int l[2], h[2], x[2];
  };
  struct Stage {};
  __device__ __forceinline__ Rows rows(int r0, int r1, int) const {
    Rows rw{{0, 0}, {0, 0}, {-1, -1}};  // rows past Nq attend nothing
    const int r[2] = {r0, r1};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r[i] < Nq) {
        rw.l[i] = lo[r[i]];
        rw.h[i] = hi[r[i]];
        rw.x[i] = ex[r[i]];
      }
    return rw;
  }
  __device__ __forceinline__ unsigned key_need(int t0, int, int, unsigned& mixed) const {
    mixed = 0u;
    return tile_range_bits(0, (Nk - 1) / kBK, t0);
  }
  __device__ __forceinline__ unsigned row_need(const Rows& rw, int t0) const {
    unsigned bits = 0u;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int a = max(rw.l[i], 0), z = min(rw.h[i], Nk) - 1;
      if (a <= z) bits |= tile_range_bits(a / kBK, z / kBK, t0);
      if (rw.x[i] >= 0 && rw.x[i] < Nk) bits |= tile_range_bits(rw.x[i] / kBK, rw.x[i] / kBK, t0);
    }
    return bits;
  }
  __device__ __forceinline__ void fetch(Stage&, int, int) const {}
  __device__ __forceinline__ bool scores(const Rows& rw, const Stage&, bool, float s[8][4], int k0,
                                         int, float sl2, int c) const {
    unsigned long long b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) b[i] = key_bits(rw.l[i], rw.h[i], rw.x[i], k0);
    if (__all_sync(kFull, (b[0] & b[1]) == ~0ull)) return true;
    b[0] >>= 2 * c;
    b[1] >>= 2 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        s[j][x] = ((b[x >> 1] >> (8 * j + (x & 1))) & 1ull) ? s[j][x] * sl2 : kNegInf2;
    return false;
  }
};

// The row max a kernel stores for the backward: a row that met no key tile
// (all skipped) keeps its initial -inf, which would make the backward's
// exp(s - m) infinite; it stores the -1e30 that a fully masked row has.
__device__ __forceinline__ float stored_max(float m) { return m == -INFINITY ? kNegInf : m; }

inline int dp_for(int Dh) { return Dh <= 32 ? 32 : (Dh <= 64 ? 64 : (Dh <= 128 ? 128 : 0)); }

// ---- tensor-core path: bf16, Dh = 64, mma.sync.m16n8k16 ----
//
// The short kernels' products (flash_attention_small.cuh); the flat and span
// kernels run on wgmma (below). A warp owns 16 rows of a tile. Tiles are
// staged in shared memory as bf16 [rows][kMP] (a 144-byte pitch, so the eight
// 16-byte rows an ldmatrix reads fall in distinct banks) and read into
// fragments with ldmatrix. Fragment layouts of m16n8k16 (g = lane / 4,
// c = lane % 4): A (16 x 16) a0a1 = (g, 2c..), a2a3 = (g + 8, 2c..),
// a4a5 = (g, 2c + 8..), a6a7 = (g + 8, 2c + 8..); B (16 x 8) b0b1 = (k 2c..,
// n g), b2b3 = (k 2c + 8.., n g); C (16 x 8) c0c1 = (g, 2c..), c2c3 =
// (g + 8, 2c..).
constexpr int kMmaThreads = 128;
constexpr int kMD = 64;        // head dimension of the tensor-core path
constexpr int kMP = kMD + 8;   // bf16 pitch of a staged tile

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

// A fragments (16 rows x 64 dims, four k-steps of 16) of a warp's 16 rows
// starting at ``row0`` of a staged tile.
__device__ __forceinline__ void load_a_frags(uint32_t f[4][4], const __nv_bfloat16* tile, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    ldsm_x4(f[s], tile + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kMP + 16 * s + 8 * (lane >> 4));
}

// ---- wgmma path: 64 x 64 bf16 tiles in the 128-byte swizzle ----
//
// A staged tile is 64 rows of 64 bf16 (128 bytes), 16-byte chunk ch of row r
// stored at chunk ch ^ (r % 8) (tile bases 1024-byte aligned), the layout
// that wgmma reads through a shared-memory descriptor with the 128-byte
// swizzle: K-major when a row holds the product's K dimension, MN-major when
// it holds M or N. One warpgroup (the block's four warps) runs
// wgmma.mma_async m64n64k16; warp w's accumulator rows are 16 w .. 16 w + 15
// in the mma.sync C layout above, and an A operand from registers has the
// mma.sync A layout, so the fragments of the mma.sync path carry over.
constexpr int kSwTile = 64 * 64;   // bf16 elements of a swizzled tile (8 KB)

// The block's shared memory from a 1024-byte boundary (the swizzle's atom);
// the launch asks for kSmemSlack bytes more than the layout needs.
constexpr int kSmemSlack = 1024;
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  return raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u);
}

// byte offset of element (r, col) of a swizzled tile
__device__ __forceinline__ uint32_t sw_offset(int r, int col) {
  return (uint32_t)(r * 128 + (((col >> 3) ^ (r & 7)) << 4) + (col & 7) * 2);
}

// Stage rows [r0, r0 + 64) of a (n_rows, 64) bf16 slice into a swizzled
// tile by cp.async (started, not waited for); rows past n_rows become zeros.
// Threads tid of nthreads share the copies.
__device__ __forceinline__ void load_tile_sw_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                   long long row_stride, int r0, int n_rows,
                                                   int tid = threadIdx.x,
                                                   int nthreads = kMmaThreads) {
  for (int e = tid; e < 64 * 8; e += nthreads) {
    const int r = e >> 3;
    const int ch = e & 7;
    const bool ok = r0 + r < n_rows;
    cp_async16(reinterpret_cast<char*>(dst) + sw_offset(r, 8 * ch),
               ok ? src + (long long)(r0 + r) * row_stride + ch * 8 : src, ok ? 16 : 0);
  }
}

// Shared-memory matrix descriptor of a swizzled tile, ``offset`` bytes in
// (a K-major operand's k-slice of 16: 32 bytes; an MN-major one's: 2048):
// start address >> 4, leading offset 1 (unused: one 128-byte swizzle atom
// across the contiguous dimension), stride 1024 bytes (8 rows), 128B swizzle.
__device__ __forceinline__ uint64_t sw_desc(const void* tile, uint32_t offset) {
  const uint32_t addr = smem_addr(tile) + offset;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }
// shared-memory writes by this thread (st.shared, cp.async) made visible to
// the wgmma (async) proxy; a barrier must follow before another thread's
// wgmma reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads of accumulators across the wait
__device__ __forceinline__ void fence_acc(float d[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+f"(d[j][x])::"memory");
}

// keeps a register A operand's registers from reuse until a wait has retired
// the wgmma that reads them
template <int N = 4>
__device__ __forceinline__ void fence_frags(uint32_t a[N][4]) {
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[t][x])::"memory");
}

// 2^x on the special-function unit (ex2.approx, ~2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64 fp32, this thread's 32) = or += A B, A and B by descriptor
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float d[8][4], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d += A B, A (the warp's 16 rows x 16) from registers in the mma.sync A layout
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float d[8][4], const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
}

// d = A B^T over K = 64: A (M = 64 rows) and B (N = 64 rows) both K-major
// tiles (q k^T, g v^T and their transposes); started, not waited for
__device__ __forceinline__ void wg_rows_nt(float d[8][4], const __nv_bfloat16* a,
                                           const __nv_bfloat16* b) {
#pragma unroll
  for (int t = 0; t < 4; ++t) wgmma_ss<0, 0>(d, sw_desc(a, 32 * t), sw_desc(b, 32 * t), t > 0);
}

// d += P B over K = 64: P (the warp's 16 rows) packed from fp32 C-layout
// values, B an MN-major tile (rows along K: e^T (g inv), ds^T q)
__device__ __forceinline__ void pack_a_frags(uint32_t a[4][4], const float p[8][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t][0] = pack_bf16(p[2 * t][0], p[2 * t][1]);
    a[t][1] = pack_bf16(p[2 * t][2], p[2 * t][3]);
    a[t][2] = pack_bf16(p[2 * t + 1][0], p[2 * t + 1][1]);
    a[t][3] = pack_bf16(p[2 * t + 1][2], p[2 * t + 1][3]);
  }
}
__device__ __forceinline__ void wg_regs_nn(float d[8][4], const uint32_t a[4][4],
                                           const __nv_bfloat16* b) {
#pragma unroll
  for (int t = 0; t < 4; ++t) wgmma_rs<1>(d, a[t], sw_desc(b, 2048 * t));
}

// d = A B over K = 64, A staged transposed (at[k][m], MN-major) and B an
// MN-major tile (ds k from ds^T)
__device__ __forceinline__ void wg_tn(float d[8][4], const __nv_bfloat16* at,
                                      const __nv_bfloat16* b) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    wgmma_ss<1, 1>(d, sw_desc(at, 2048 * t), sw_desc(b, 2048 * t), t > 0);
}

// Whether a (B, H, N, 64) bf16 operand can be staged with 16-byte copies.
inline bool mma_aligned(const void* p, const long long* st) {
  return ((uintptr_t)p % 16 == 0) && st[0] % 8 == 0 && st[1] % 8 == 0 && st[2] % 8 == 0;
}

// ---- fp32 on the tensor cores: three TF32 products (Dh = 64) ----
//
// A TF32 product keeps 11 significant bits of each operand, too few for the
// fp32 kernels' 1e-4 against their twins. Each operand x is split as
// big = tf32(x) (cvt.rna: round to nearest, ties away, on the 13 dropped
// bits) and small = tf32(x - big), and a product a b is taken as
// a_small b_big + a_big b_small + a_big b_big with fp32 accumulation: the
// dropped a_small b_small term is ~2^-22 of a b
// (tests/test_torch_flash_fp32_tc.py emulates the order of operations).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Whether a (B, H, N, 64) fp32 operand can be copied 16 bytes at a time,
// or (pair_aligned) written 8 bytes at a time.
inline bool tf32_aligned(const void* p, const long long* st) {
  return ((uintptr_t)p % 16 == 0) && st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0;
}
inline bool pair_aligned(const void* p, const long long* st) {
  return ((uintptr_t)p % 8 == 0) && st[0] % 2 == 0 && st[1] % 2 == 0 && st[2] % 2 == 0;
}

// The kernels a flat or span call takes (the *_route exports): fp32 or
// bf16 FMAs on the CUDA cores, bf16 wgmma, or fp32 as three TF32 products.
enum Route { kRouteCudaCores = 0, kRouteWgmmaBf16 = 1, kRouteTf32x3 = 2 };

// wgmma on TF32 (the forward). A 64 x 64 fp32 tile whose rows hold the
// product's K dimension (K-major, the only layout wgmma takes for TF32) is
// two 64 x 32 halves of 8 KB, each in the 128-byte swizzle: 16-byte chunk
// ch of row r at chunk ch ^ (r % 8). Byte for byte a half is a bf16 64 x 64
// tile, so sw_desc reads it: k-step t (8 values, 32 bytes) of a tile starts
// (t / 4) halves and 32 (t % 4) bytes in.
constexpr int kF32Tile = 64 * 64;   // floats of an fp32 tile (16 KB)

__device__ __forceinline__ uint32_t sw32_offset(int r, int col) {   // bytes
  return (uint32_t)((col >> 5) * 8192 + r * 128 + ((((col >> 2) & 7) ^ (r & 7)) << 4) +
                    (col & 3) * 4);
}
__device__ __forceinline__ uint32_t tf32_kstep(int t) { return (uint32_t)((t >> 2) * 8192 + 32 * (t & 3)); }

// The column of key j of a 64-key tile in a V^T tile: within each 8, the
// even keys first. An accumulator holds keys 2c, 2c + 1 of each 8 in thread
// c of a quad, where a TF32 A operand in registers wants k-indices c and
// c + 4; the permutation lets the score accumulator be the A operand of
// e V as it stands (the sum over keys is the same in any order).
__device__ __forceinline__ int key_pos(int j) { return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1); }

// d (64 x 64 fp32, this thread's 32) = or += A B^T, both K-major TF32
// tiles by descriptor
__device__ __forceinline__ void wgmma_tf32_ss(float d[8][4], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B^T, A (the warp's 16 rows x 8) from registers in the mma.sync
// m16n8k8 TF32 A layout (a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3
// (g + 8, c + 4)), B a K-major TF32 tile by descriptor
__device__ __forceinline__ void wgmma_tf32_rs(float d[8][4], const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// mma.sync on TF32 (the backward): fragments read from fp32 tiles staged
// as they are, [64 rows][kRP], and split in registers. The pitch of 68
// floats keeps 16-byte rows for cp.async and puts the fragment reads of
// both orientations in distinct banks: (row g, column c) at 4 g + c, and
// (row 2 c (+1), column g) at 8 c (+4) + g.
constexpr int kRP = 68;
constexpr int kRawTile = 64 * kRP;   // floats

// d += a b, m16n8k8, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b as three TF32 products, the small terms first
__device__ __forceinline__ void mma_tf32x3(float d[4], const uint32_t ab[4], const uint32_t as[4],
                                           const uint32_t bb[2], const uint32_t bs[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}
__device__ __forceinline__ void split4(const float x[4], uint32_t b[4], uint32_t s[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], b[i], s[i]);
}
// A fragment (16 x 8) at rows m0.., columns k0.. of a staged tile
__device__ __forceinline__ void frag_a(const float* t, int m0, int k0, uint32_t b[4], uint32_t s[4]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  const float* p = t + (m0 + g) * kRP + k0 + c;
  const float x[4] = {p[0], p[8 * kRP], p[4], p[8 * kRP + 4]};
  split4(x, b, s);
}
// B fragment (8 x 8, k x n) whose n runs along the tile's rows n0..:
// (k c, n g) and (k c + 4, n g) at row n0 + g, columns k0 + c, k0 + c + 4
__device__ __forceinline__ void frag_b_rows(const float* t, int n0, int k0, uint32_t b[2],
                                            uint32_t s[2]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  const float* p = t + (n0 + g) * kRP + k0 + c;
  split_tf32(p[0], b[0], s[0]);
  split_tf32(p[4], b[1], s[1]);
}
// B fragment whose k runs along the tile's rows in the accumulator's
// order: k-index c is row k0 + 2 c, c + 4 is row k0 + 2 c + 1 (times
// ``w0`` / ``w1``), n is column n0 + g
__device__ __forceinline__ void frag_b_pairs(const float* t, int k0, int n0, float w0, float w1,
                                             uint32_t b[2], uint32_t s[2]) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  const float* p = t + (k0 + 2 * c) * kRP + n0 + g;
  split_tf32(p[0] * w0, b[0], s[0]);
  split_tf32(p[kRP] * w1, b[1], s[1]);
}
// the A fragment of k-step j of a 16 x 64 accumulator (x[j][0..3] at
// rows g, g, g + 8, g + 8 and columns 8 j + 2 c, + 1), in the order of
// frag_b_pairs: k-index c is column 8 j + 2 c, c + 4 is 8 j + 2 c + 1
__device__ __forceinline__ void frag_a_acc(const float x[4], uint32_t b[4], uint32_t s[4]) {
  const float y[4] = {x[0], x[2], x[1], x[3]};
  split4(y, b, s);
}

// Stage rows [r0, r0 + 64) of a (n_rows, 64) fp32 slice into a [64][kRP]
// tile by cp.async (started, not waited for); rows past n_rows become zeros.
__device__ __forceinline__ void load_raw_async(float* dst, const float* src, long long row_stride,
                                               int r0, int n_rows) {
  for (int e = threadIdx.x; e < 64 * 16; e += kMmaThreads) {
    const int r = e >> 4, ch = e & 15;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + r * kRP + 4 * ch, ok ? src + (long long)(r0 + r) * row_stride + 4 * ch : src,
               ok ? 16 : 0);
  }
}

// ---- per-library launch state ----
//
// A kernel's dynamic shared-memory opt-in (cudaFuncSetAttribute), the
// device's limits and the occupancy of a launch shape are asked once and
// kept, so a launch after the first makes none of those runtime calls. The
// state has internal linkage: each kernel library (one .cu each) keeps its
// own table. A function-local static of an inline function or template
// would not do: g++ gives it STB_GNU_UNIQUE binding, and the loader then
// shares one copy among the separately loaded libraries, so one library's
// flag would stand for another library's kernel. Entries are keyed on the
// kernel's host function pointer and the device.
namespace {

struct FuncState {
  const void* fn;
  int device;
  size_t raised;          // the opt-in set so far (0: none)
  int occ_threads;        // the last occupancy query: block size, bytes,
  size_t occ_smem;        // and its answer (blocks an SM)
  int occ_blocks;
};
constexpr int kMaxFuncs = 128;
constexpr int kMaxDevices = 64;
FuncState g_funcs[kMaxFuncs];
int g_n_funcs = 0;
int g_optin[kMaxDevices];   // max opt-in shared memory a block; 0 = not read yet
int g_sms[kMaxDevices];     // streaming multiprocessors; 0 = not read yet
long long g_attribute_calls = 0;   // cudaFuncSetAttribute calls this library made
std::mutex g_state_mutex;          // ctypes drops the GIL around a launch

FuncState* func_state(const void* fn, int device) {
  for (int i = 0; i < g_n_funcs; ++i)
    if (g_funcs[i].fn == fn && g_funcs[i].device == device) return &g_funcs[i];
  if (g_n_funcs == kMaxFuncs) return nullptr;
  g_funcs[g_n_funcs] = {fn, device, 0, 0, 0, 0};
  return &g_funcs[g_n_funcs++];
}

}  // namespace

// Make ``device`` current for the launch (a kernel library links its own
// CUDA runtime): a thread-local read, and a set only when it differs.
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur == device) return cudaSuccess;
  return cudaSetDevice(device);
}

// Let ``kernel`` take ``smem`` bytes of dynamic shared memory on
// ``device`` (current): the opt-in is raised on the first launch that needs
// it, and on a later one only if it needs more.
template <typename Kernel>
inline cudaError_t prepare(Kernel kernel, size_t smem, int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_state_mutex);
  FuncState* st = func_state((const void*)kernel, device);
  if (st != nullptr && st->raised >= smem) return cudaSuccess;
  if (g_optin[device] == 0) {
    int v = 0;
    cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    g_optin[device] = v;
  }
  if ((long long)smem > g_optin[device]) return cudaErrorInvalidValue;
  ++g_attribute_calls;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && st != nullptr) st->raised = smem;
  return err;
}

// Blocks of ``threads`` threads and ``smem`` bytes that fit on one SM at
// once (0 on an error), asked once per (kernel, device, shape) in a row.
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel, int threads, size_t smem, int device) {
  std::lock_guard<std::mutex> lock(g_state_mutex);
  FuncState* st = func_state((const void*)kernel, device);
  if (st != nullptr && st->occ_threads == threads && st->occ_smem == smem) return st->occ_blocks;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess) n = 0;
  if (st != nullptr) {
    st->occ_threads = threads;
    st->occ_smem = smem;
    st->occ_blocks = n;
  }
  return n;
}

inline int sm_count(int device) {
  if (device < 0 || device >= kMaxDevices) return 0;
  std::lock_guard<std::mutex> lock(g_state_mutex);
  if (g_sms[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
    g_sms[device] = v;
  }
  return g_sms[device];
}

// A library's count of cudaFuncSetAttribute calls, exported as
// ``<prefix>_attribute_calls`` (the checks read it to show that each
// library raises its own kernels' opt-in once).
#define FLASH_EXPORT_ATTRIBUTE_CALLS(prefix) \
  long long prefix##_attribute_calls() { return flash::g_attribute_calls; }

}  // namespace flash
