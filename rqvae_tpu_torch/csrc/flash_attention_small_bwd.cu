// Short-sequence fused masked attention, backward: dq, dk, dv of
// out = softmax(q k^T / sqrt(Dh) + bias) v for an upstream gradient g, with
// Nq, Nk < 256, in ONE kernel with no atomics.
//
// Replaces the TPU kernel rqvae_tpu/ops/flash_attention.py:
// _flash_small_bwd_kernel, the one-shot backward: a program owns the whole q
// and k extent of its (batch, head) pairs, so it computes dq, dk and dv
// without a dq / dk-dv split and without cross-program accumulation. Its
// arithmetic (the flat kernels' too): with the forward's row max m and
// inv = 1 / sum(e) (0 for a row with no valid key), e = exp(s - m)
// unnormalised and dp = g v^T,
//   c  = rowsum(dp * e) * inv                  (over every key)
//   ds = e * ((dp - c) * inv)                  cast to the operand type
//   dq = ds k * scale,  dk = ds^T q * scale,  dv = e^T (g * inv)
// with e and g * inv cast to the operand type before the dv product, fp32
// accumulation, and dq, dk, dv written in the operand type. Padded query
// rows carry zero q and g and inv = 0, so their ds and g * inv rows are zero
// and leave dk and dv untouched, as the TPU kernel notes.
//
// What bounds it on an H100: at the Amazon encoder shape (B = 256, H = 8,
// N = 81, Dh = 64, bf16) it moves q, k, v, g, dq, dk and dv, 7 x 21.2 MB,
// 0.044 ms at 3.35 TB/s, against 10 B H Nq Nk Dh = 8.6 GFLOP, 0.0087 ms at
// 989 TFLOP/s: bytes. Tensor-core rate is not the limit; keeping loads in
// flight, and enough warps to hide the latency of each warp's chain of
// ldmatrix, mma and exp, is. So the bf16 Dh = 64 kernels are persistent and
// keep the next pair's copies in flight under the current pair's math
// (cp.async groups; in the rows kernel, other warps' pairs), in tiles of
// 128-byte swizzled rows small enough that two tiles CTAs fit on an SM.
//
// Five variants compute the same function (bwd_gate, then bwd_route for
// bf16, pick):
//   * small_bwd_tiles_kernel<KT>: bf16, Dh = 64, 16-byte-aligned rows, Nk <=
//     96 (KT <= 6 key tiles of 16) and more than 16 queries: the encoder's
//     81 x 81. Persistent CTAs of 6 warps, two an SM (168 registers), walk
//     the (batch, head) pairs. Query pass: a warp owns 16 query rows, takes
//     s and dp over every key in registers (mma.sync m16n8k16), c from the
//     whole row, ds, dq = ds k written from registers, and stages bf16 e
//     and ds ([q][key] tiles). Key pass: a warp owns 16 keys, dk = ds^T q
//     and dv = e^T bf16(g * inv), the g * inv rows formed as the product
//     reads them (no third copy of g). The query side (q, g, m, inv) is
//     double-buffered and the next pair's copies start with each pair; the
//     key side (k, v, key bias) is read only by the query pass, so the next
//     pair's copies refill it under the key pass. Each key's dk and dv are
//     final in its warp. (Recomputing s^T and dp^T in the key pass instead
//     of staging e and ds, to fit more pairs in shared memory, left the
//     kernel bound by its own math: 0.130 against 0.098 ms at 81 x 81 on an
//     H100, PERF.md.)
//   * small_bwd_rows_kernel<KT>: the same operands with at most 16 queries:
//     the decoder's 5 x 5, the cross attention's 5 x 81, a decode step's
//     1 x T. A warp owns whole pairs and walks them through its own stage
//     (the other warps' copies land under its math): s, dp, c, ds
//     and dq as above, then per key tile dk and dv from the same registers,
//     e and ds transposed in registers (movmatrix). No barrier but the warp's.
//   * the strips route: the same operands with Nk > 96 (the ML-32M short
//     bucket's 241 x 241 and its 5 x 241 cross attention, 255 x 255), or a
//     tiles-kernel shape whose query side does not fit shared memory (Nq >
//     208). Only live key tiles are copied and computed (the forward's rule,
//     live_mask / tile_list: a tile whose keys are all masked adds exactly
//     nothing, so its dk and dv rows are written as zeros), and a (query
//     tile, key tile) pair past the causal cut is skipped. A CTA a pair, in
//     one of two modes:
//     - small_bwd_keys_kernel (Nq <= 16): 4 warps split the pair's live
//       tiles. Each takes s, dp, e and ds of the 16 rows against its own
//       tiles in registers; the partial c sums and the dq = ds k partials
//       are reduced through shared memory in warp order; dk and dv of its
//       tiles come from the same registers, e and ds transposed there
//       (movmatrix). Nothing is recomputed and nothing but dq is staged.
//       71 KB, three CTAs an SM.
//     - small_bwd_strips_kernel (Nq > 16): 16 warps (8 up to 128 queries),
//       a warp a 16-row query tile whose q and g fragments it loads once and
//       keeps in registers (g is then rounded to bf16(g inv) in place, dv's
//       operand). Strips of four live tiles arrive through a three-stage
//       cp.async ring, so the next strip's copy lands under this strip's
//       math. When the live tiles span more than one strip, c comes from a
//       first sweep over the strips (s and dp computed, e dp summed); with
//       one strip, from that strip before its ds. Per strip the query warps
//       take s, dp, ds and dq += ds k (dq in registers across strips) and
//       stage bf16 e and ds; then the key side splits into (strip tile, dk
//       or dv, half of the dims) items over the warps. 187 KB at 241 x 241,
//       one CTA an SM (two at 128 queries or fewer).
//     What bounds the route on an H100: at 241 x 241 (B = 256, H = 8, ragged
//     keys, half of them valid) q, g, dq, dk, dv and the live keys' K and V
//     take 0.115 ms at 3.35 TB/s, the products over the allowed pairs 0.04
//     at the bf16 peak. On mma.sync every product reads its fragments from
//     shared memory with ldmatrix, and those reads (not device memory) are
//     what the kernel waits on: the design reads K and V once per (query
//     tile, strip) for s and dp and once more for dq, q and g once per
//     pair, e and ds once per (key tile, query tile, half). The strip kernel
//     it replaces computed every key tile, ran the query side of an Nq <= 16
//     pair on one warp and every strip's key side on two, and waited for
//     each 32-key strip's copy with nothing in flight.
//   * small_bwd_tf32_kernel<kWarp>: fp32 operands with Dh = 64 and 16-byte
//     aligned rows (every shipped decoder config), every product as three
//     TF32 mma.sync m16n8k8: see its note below.
//   * small_bwd_kernel<T, DP>: other head sizes (Dh <= 128) and unaligned
//     views, fp32 or bf16, FMAs on the CUDA cores, one CTA a pair: per
//     64-row query tile a pass for c and a pass for ds and dq over the key
//     tiles, then per 64-key tile dk and dv over the query tiles (the fp32
//     operands of a pair at Dh = 128 exceed shared memory, so they are
//     staged a tile at a time and s, dp recomputed three times).
#include "flash_attention_bwd.cuh"
#include "flash_attention_small.cuh"

#include <type_traits>

namespace flash {
namespace small {

constexpr int kRowKT = 6;          // the tiles / rows kernels hold a whole score row: Nk <= 96
constexpr int kTileWarps = 6;      // the tiles kernel's warps: two CTAs an SM hold 12 at <= 168 registers

// Sum over the 4 lanes that share a row of an mma C fragment.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// exp(s - m) of the score of key ``col`` for query ``row`` from its raw
// q k^T product: -inf past Nk (weighs nothing), the key bias, the causal cut.
__device__ __forceinline__ float exp_score(float dot, float scale, float bias, int row, int col,
                                           int Nk, int causal, float m) {
  if (col >= Nk) return 0.f;
  const float s = (causal && col > row) ? kNegInf : dot * scale + bias;
  return __expf(s - m);
}

// The query side of 16 rows (row0..) of a staged pair, as one warp: s and
// dp over the KT key tiles, c = rowsum(dp e) inv, ds = e ((dp - c) inv)
// packed to bf16 A fragments (keys 16 t.. in ds_a[t]); e packed likewise
// when e_a is given; bf16 e and ds stored to the [row][key] tiles Es, Ds
// (pitch ep) when they are given.
template <int KT>
__device__ __forceinline__ void query_side(const __nv_bfloat16* Qs, const __nv_bfloat16* Gs,
                                           const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                           const float* ms, const float* is, const float* bs,
                                           int row0, int Nk, int causal, float scale,
                                           uint32_t ds_a[KT][4], uint32_t (*e_a)[4],
                                           __nv_bfloat16* Es, __nv_bfloat16* Ds, int ep) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, c = lane & 3;
  float e[2 * KT][4], dp[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) e[j][x] = dp[j][x] = 0.f;
  {
    uint32_t f[4][4];
    load_a_sw(f, Qs, row0);
#pragma unroll
    for (int t = 0; t < KT; ++t) mma_nt_sw(e[2 * t], e[2 * t + 1], f, Ks, 16 * t);
    load_a_sw(f, Gs, row0);
#pragma unroll
    for (int t = 0; t < KT; ++t) mma_nt_sw(dp[2 * t], dp[2 * t + 1], f, Vs, 16 * t);
  }
  const int rows[2] = {row0 + gr, row0 + gr + 8};
  const float m[2] = {ms[rows[0]], ms[rows[1]]};
  const float inv[2] = {is[rows[0]], is[rows[1]]};
  float part[2] = {0.f, 0.f}, cr[2];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * c);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = x >> 1, col = 8 * j + 2 * c + (x & 1);
      e[j][x] = exp_score(e[j][x], scale, (x & 1) ? b.y : b.x, rows[r], col, Nk, causal, m[r]);
      part[r] = fmaf(dp[j][x], e[j][x], part[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) cr[r] = quad_sum(part[r]) * inv[r];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dp[j][x] = e[j][x] * ((dp[j][x] - cr[x >> 1]) * inv[x >> 1]);
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    pack_a(ds_a[t], dp[2 * t], dp[2 * t + 1]);
    if (e_a != nullptr) pack_a(e_a[t], e[2 * t], e[2 * t + 1]);
    if (Es != nullptr) {   // bf16 e and ds at (row, key) of [nqp][ep] tiles
      uint32_t ea[4];
      pack_a(ea, e[2 * t], e[2 * t + 1]);
#pragma unroll
      for (int x = 0; x < 4; ++x) {   // A fragment x: row + 8 (x & 1), key + 8 (x >> 1)
        const int off = (rows[x & 1]) * ep + 16 * t + 8 * (x >> 1) + 2 * c;
        *reinterpret_cast<uint32_t*>(Es + off) = ea[x];
        *reinterpret_cast<uint32_t*>(Ds + off) = ds_a[t][x];
      }
    }
  }
}

// dq rows row0.. of a pair = ds k * scale, from the packed ds, stored.
template <int KT>
__device__ __forceinline__ void store_dq(const uint32_t ds_a[KT][4], const __nv_bfloat16* Ks,
                                         __nv_bfloat16* dst, long long row_stride, int row0, int Nq,
                                         float scale) {
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
#pragma unroll
  for (int t = 0; t < KT; ++t) mma_pa_sw<false>(acc, ds_a[t], Ks, 16 * t, nullptr);
  store_rows(dst, row_stride, row0, Nq, acc, scale);
}

// One (batch, head) pair's operands in shared memory: q, g [nqp][64] and
// k, v [nkp][64] swizzled bf16, m, inv [nqp] and the key bias [nkp] fp32.
// The query side (q, g, m, inv) and the key side (k, v, bias) are fetched
// apart: the tiles kernel double-buffers the first and refills the second
// in place.
struct PairStage {
  __nv_bfloat16 *Q, *G, *K, *V;
  float *M, *I, *B;
  // every operand in one block at base: Q, G, K, V, M, I, B
  __device__ __forceinline__ PairStage(unsigned char* base, int nqp, int nkp) {
    Q = reinterpret_cast<__nv_bfloat16*>(base);
    G = Q + nqp * kMD;
    K = G + nqp * kMD;
    V = K + nkp * kMD;
    M = reinterpret_cast<float*>(V + nkp * kMD);
    I = M + nqp;
    B = I + nqp;
  }
  // the query side at qbase (Q, G, M, I), the key side at kbase (K, V, B)
  __device__ __forceinline__ PairStage(unsigned char* qbase, unsigned char* kbase, int nqp, int nkp) {
    Q = reinterpret_cast<__nv_bfloat16*>(qbase);
    G = Q + nqp * kMD;
    M = reinterpret_cast<float*>(G + nqp * kMD);
    I = M + nqp;
    K = reinterpret_cast<__nv_bfloat16*>(kbase);
    V = K + nkp * kMD;
    B = reinterpret_cast<float*>(V + nkp * kMD);
  }
  // start the copies of pair bh's query side (threads tid of n); padded
  // rows get m = inv = 0, so they weigh nothing
  __device__ __forceinline__ void fetch_q(const __nv_bfloat16* q, const __nv_bfloat16* g,
                                          const float* m_in, const float* inv_in, const Strides& sq,
                                          const Strides& sg, int bh, int H, int Nq, int nqp,
                                          int tid, int n) const {
    const int b = bh / H, h = bh % H;
    stage_rows_sw(Q, q + b * sq.b + h * sq.h, sq.n, Nq, nqp, tid, n);
    stage_rows_sw(G, g + b * sg.b + h * sg.h, sg.n, Nq, nqp, tid, n);
    stage_floats(M, m_in + (long long)bh * Nq, Nq, nqp, tid, n);
    stage_floats(I, inv_in + (long long)bh * Nq, Nq, nqp, tid, n);
  }
  // ... and its key side
  __device__ __forceinline__ void fetch_k(const __nv_bfloat16* k, const __nv_bfloat16* v,
                                          const float* bias, const Strides& sk, const Strides& sv,
                                          int bh, int H, int Nk, int nkp, int tid, int n) const {
    const int b = bh / H, h = bh % H;
    stage_rows_sw(K, k + b * sk.b + h * sk.h, sk.n, Nk, nkp, tid, n);
    stage_rows_sw(V, v + b * sv.b + h * sv.h, sv.n, Nk, nkp, tid, n);
    stage_floats(B, bias + (long long)b * Nk, Nk, nkp, tid, n);
  }
};

__host__ __device__ constexpr long long pair_stage_bytes(int nqp, int nkp) {
  return (2LL * nqp + 2LL * nkp) * kMD * 2 + (2LL * nqp + nkp) * 4;
}

#define SMALL_BWD_PARAMS                                                                        \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k,                      \
      const __nv_bfloat16 *__restrict__ v, const float *__restrict__ bias,                       \
      const __nv_bfloat16 *__restrict__ g, const float *__restrict__ m_in,                       \
      const float *__restrict__ inv_in, __nv_bfloat16 *__restrict__ dq,                          \
      __nv_bfloat16 *__restrict__ dk, __nv_bfloat16 *__restrict__ dv, Strides sq, Strides sk,    \
      Strides sv, Strides sg, Strides sdq, Strides sdk, Strides sdv, int BH, int H, int Nq,      \
      int Nk, int causal, float scale

// The tiles kernel's shared memory: two query-side stages (q, g, m, inv),
// one key side (k, v, key bias), and the bf16 e and ds tiles [nqp][ep].
__host__ __device__ constexpr long long tiles_qside_bytes(int nqp) { return nqp * (2LL * kMD * 2 + 8); }
__host__ __device__ constexpr long long tiles_kside_bytes(int nkp) { return nkp * (2LL * kMD * 2 + 4); }
__host__ __device__ constexpr long long tiles_smem_bytes(int nqp, int nkp) {
  return 2 * tiles_qside_bytes(nqp) + tiles_kside_bytes(nkp) + 2LL * nqp * (nkp + 8) * 2;
}

template <int KT>
__global__ void __launch_bounds__(kTileWarps * 32, 2)
small_bwd_tiles_kernel(SMALL_BWD_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nkp = 16 * KT;
  constexpr int ep = nkp + 8;   // an odd number of 16-byte chunks a row: conflict-free ldmatrix
  const int n_qt = (Nq + 15) / 16;
  const int nqp = 16 * n_qt;
  unsigned char* kbase = smem_raw + 2 * tiles_qside_bytes(nqp);
  __nv_bfloat16* Es = reinterpret_cast<__nv_bfloat16*>(kbase + tiles_kside_bytes(nkp));
  __nv_bfloat16* Ds = Es + nqp * ep;
  auto stage = [&](int i) {
    return PairStage(smem_raw + i * tiles_qside_bytes(nqp), kbase, nqp, nkp);
  };
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x, nt = blockDim.x;

  // Copy groups, oldest first: {q side 0, k side 0}, then per pair i
  // {q side i + 1} at its start and {k side i + 1} after its query pass.
  int bh = blockIdx.x;
  if (bh < BH) {
    stage(0).fetch_q(q, g, m_in, inv_in, sq, sg, bh, H, Nq, nqp, tid, nt);
    stage(0).fetch_k(k, v, bias, sk, sv, bh, H, Nk, nkp, tid, nt);
  }
  cp_async_commit();
  for (int it = 0; bh < BH; bh += gridDim.x, ++it) {
    const PairStage st = stage(it & 1);
    const int next = bh + gridDim.x;
    // the next pair's query side, into the stage the previous pair's key
    // pass read before its final barrier
    if (next < BH) stage((it + 1) & 1).fetch_q(q, g, m_in, inv_in, sq, sg, next, H, Nq, nqp, tid, nt);
    cp_async_commit();
    cp_async_wait<1>();   // all but that group: this pair's q and k sides (this thread's copies)
    __syncthreads();      // ... and every thread's
    const int b = bh / H, h = bh % H;

    // query pass: c, ds and dq of 16 rows a warp; bf16 e and ds staged
    for (int qt = warp; qt < n_qt; qt += nwarps) {
      uint32_t ds_a[KT][4];
      query_side<KT>(st.Q, st.G, st.K, st.V, st.M, st.I, st.B, 16 * qt, Nk, causal, scale, ds_a,
                     nullptr, Es, Ds, ep);
      store_dq<KT>(ds_a, st.K, dq + b * sdq.b + h * sdq.h, sdq.n, 16 * qt, Nq, scale);
    }
    __syncthreads();   // e and ds are staged; k, v and the key bias are read
    if (next < BH) st.fetch_k(k, v, bias, sk, sv, next, H, Nk, nkp, tid, nt);
    cp_async_commit();   // lands under the key pass

    // key pass: dk = ds^T q and dv = e^T bf16(g inv) of 16 keys a warp
    for (int kt = warp; kt < KT; kt += nwarps) {
      float dka[8][4], dva[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) dka[j][x] = dva[j][x] = 0.f;
      for (int qs = 0; qs < n_qt; ++qs) {
        if (causal && 16 * qs + 15 < 16 * kt) continue;   // no row of the tile sees these keys
        uint32_t da[4], ea[4];
        const int off = (16 * qs + (lane & 7) + 8 * (lane >> 4)) * ep + 16 * kt + 8 * ((lane >> 3) & 1);
        ldsm_x4_t(da, Ds + off);   // the A fragments of ds^T and e^T (keys x rows)
        ldsm_x4_t(ea, Es + off);
        mma_pa_sw<false>(dka, da, st.Q, 16 * qs, nullptr);
        mma_pa_sw<true>(dva, ea, st.G, 16 * qs, st.I);
      }
      store_rows(dk + b * sdk.b + h * sdk.h, sdk.n, 16 * kt, Nk, dka, scale);
      store_rows(dv + b * sdv.b + h * sdv.h, sdv.n, 16 * kt, Nk, dva, 1.f);
    }
    __syncthreads();   // e, ds and this query side are read
  }
}

template <int KT>
__global__ void __launch_bounds__(kMaxWarps * 32)
small_bwd_rows_kernel(SMALL_BWD_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nkp = 16 * KT;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const PairStage st(smem_raw + (long long)warp * pair_stage_bytes(16, nkp), 16, nkp);
  auto fetch = [&](int pair) {   // the warp's lanes copy a whole pair
    st.fetch_q(q, g, m_in, inv_in, sq, sg, pair, H, Nq, 16, lane, 32);
    st.fetch_k(k, v, bias, sk, sv, pair, H, Nk, nkp, lane, 32);
  };
  const int step = gridDim.x * nwarps;

  int bh = blockIdx.x * nwarps + warp;
  if (bh < BH)
    fetch(bh);
  cp_async_commit();
  for (; bh < BH; bh += step) {
    cp_async_wait<0>();
    __syncwarp();   // every lane's copies of this pair are visible to the warp
    const int b = bh / H, h = bh % H;
    uint32_t ds_a[KT][4], e_a[KT][4];
    query_side<KT>(st.Q, st.G, st.K, st.V, st.M, st.I, st.B, 0, Nk, causal, scale, ds_a, e_a,
                   nullptr, nullptr, 0);
    store_dq<KT>(ds_a, st.K, dq + b * sdq.b + h * sdq.h, sdq.n, 0, Nq, scale);
    // per key tile: dk = ds^T q, dv = e^T bf16(g * inv) over the 16 rows
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      uint32_t at[4];
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
      transpose_a(at, ds_a[t]);
      mma_pa_sw<false>(acc, at, st.Q, 0, nullptr);
      store_rows(dk + b * sdk.b + h * sdk.h, sdk.n, 16 * t, Nk, acc, scale);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
      transpose_a(at, e_a[t]);
      mma_pa_sw<true>(acc, at, st.G, 0, st.I);
      store_rows(dv + b * sdv.b + h * sdv.h, sdv.n, 16 * t, Nk, acc, 1.f);
    }
    __syncwarp();   // this stage is read
    if (bh + step < BH)
      fetch(bh + step);
    cp_async_commit();
  }
}

// ---- the strips route (bf16, Dh = 64, Nk > 96 or Nq > 208) ----

constexpr int kMaxKT = 16;         // key tiles of a pair: Nk <= 255
constexpr int kKeysWarps = 4;      // keys mode (Nq <= 16): warps a CTA
constexpr int kKeysTiles = kMaxKT / kKeysWarps;   // live tiles a warp holds at most
constexpr int kDqPitch = 68;       // floats a row of a warp's staged dq partial
constexpr int kStripWarps = 16;    // strips mode (Nq > 16): warps a CTA, a query tile each (8 at
                                   // Nq <= 128, so that two CTAs share an SM)
constexpr int kStripTiles = 4;     // live key tiles a strip
constexpr int kStripItems = 4 * kStripTiles;   // the key side's: a strip tile, dk or dv, a half
constexpr int kStripStages = 3;    // the K / V ring: two strips in flight
constexpr int kStripPitch = 16 * kStripTiles + 8;   // bf16 a row of the staged e / ds (odd 16-byte chunks)

// Live tile j of a tile_list.
__device__ __forceinline__ int tile_at(unsigned long long idx, int j) { return (int)((idx >> (4 * j)) & 15ull); }

// Zero the dk and dv rows of the keys in no live tile (no row attends them)
// and, when the pair has no live tile, every dq row too; threads tid of n.
__device__ __forceinline__ void zero_dead(__nv_bfloat16* dqp, __nv_bfloat16* dkp, __nv_bfloat16* dvp,
                                          const Strides& sdq, const Strides& sdk, const Strides& sdv,
                                          unsigned mask, int Nq, int Nk, int tid, int n) {
  for (int e = tid; e < Nk * 32; e += n) {
    const int key = e >> 5, d = 2 * (e & 31);
    if ((mask >> (key >> 4)) & 1u) continue;
    *reinterpret_cast<uint32_t*>(dkp + key * sdk.n + d) = 0u;
    *reinterpret_cast<uint32_t*>(dvp + key * sdv.n + d) = 0u;
  }
  if (mask == 0u)
    for (int e = tid; e < Nq * 32; e += n)
      *reinterpret_cast<uint32_t*>(dqp + (e >> 5) * sdq.n + 2 * (e & 31)) = 0u;
}

// Start the copies of live tiles j0 .. j0 + nt - 1 (keys past Nk: zeros) of
// k and v into swizzled [16 nt][64] tiles, packed; threads tid of n.
__device__ __forceinline__ void fetch_tiles(__nv_bfloat16* Kd, __nv_bfloat16* Vd, const __nv_bfloat16* kp,
                                            const __nv_bfloat16* vp, const Strides& sk, const Strides& sv,
                                            unsigned long long idx, int j0, int nt, int Nk, int tid, int n) {
  for (int e = tid; e < nt * 16 * 8; e += n) {
    const int r = e >> 3, ch = e & 7;
    const int key = 16 * tile_at(idx, j0 + (r >> 4)) + (r & 15);
    const bool ok = key < Nk;
    cp_async16(Kd + sw(r, 8 * ch), ok ? kp + key * sk.n + 8 * ch : kp, ok ? 16 : 0);
    cp_async16(Vd + sw(r, 8 * ch), ok ? vp + key * sv.n + 8 * ch : vp, ok ? 16 : 0);
  }
}

// e = exp(s - m) and dp = g v^T of 16 staged query rows (A fragments qf, gf)
// against the 16 keys of tile t staged at Kb / Vb (keys 16 t + 8 u + 2 c
// (+1) in e[u], dp[u]); the rows' m at ms[rows[r]], the key bias staged at bs.
__device__ __forceinline__ void tile_scores(const uint32_t qf[4][4], const uint32_t gf[4][4],
                                            const __nv_bfloat16* Kb, const __nv_bfloat16* Vb,
                                            const float* ms, const float* bs, const int rows[2], int t,
                                            int Nk, int causal, float scale, float e[2][4], float dp[2][4]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x) e[u][x] = dp[u][x] = 0.f;
  mma_nt_sw(e[0], e[1], qf, Kb, 0);
  mma_nt_sw(dp[0], dp[1], gf, Vb, 0);
  const float m[2] = {ms[rows[0]], ms[rows[1]]};
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int col = 16 * t + 8 * u + 2 * c + (x & 1);
      e[u][x] = exp_score(e[u][x], scale, bs[col], rows[x >> 1], col, Nk, causal, m[x >> 1]);
    }
}

// Store N n-tiles (dims d0 .. d0 + 8 N - 1) of a 16-row accumulator, times
// ``mul``, as bf16 rows row0 + g and row0 + g + 8 (those < n).
template <int N>
__device__ __forceinline__ void store_cols(__nv_bfloat16* dst, long long row_stride, int row0, int n,
                                           int d0, const float acc[N][4], float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < N; ++j)
      *reinterpret_cast<uint32_t*>(dst + (long long)row * row_stride + d0 + 8 * j + 2 * c) =
          pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

// The keys mode's shared memory (one size for every Nk > 96): q, g [16][64]
// and K, V [16 kMaxKT][64] swizzled bf16 (the dq partials [warps][16][kDqPitch]
// fp32 go over V once every dp is taken); m, inv [16], the c partials
// [warps][16] and the key bias [16 kMaxKT] fp32.
constexpr long long kKeysSmem = (2LL * 16 + 2LL * 16 * kMaxKT) * kMD * 2 + (2 + kKeysWarps + kMaxKT) * 16 * 4;
static_assert(kKeysWarps * 16 * kDqPitch * 4 <= 16LL * kMaxKT * kMD * 2, "dq partials exceed V's tiles");

__global__ void __launch_bounds__(kKeysWarps * 32, 3)
small_bwd_keys_kernel(SMALL_BWD_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + 16 * kMD;
  __nv_bfloat16* Ks = Gs + 16 * kMD;   // live tile j at rows 16 j ..
  __nv_bfloat16* Vs = Ks + 16 * kMaxKT * kMD;
  float* Ms = reinterpret_cast<float*>(Vs + 16 * kMaxKT * kMD);
  float* Is = Ms + 16;
  float* Cp = Is + 16;
  float* Bs = Cp + kKeysWarps * 16;
  float* Dq = reinterpret_cast<float*>(Vs);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;
  __nv_bfloat16* dqp = dq + b * sdq.b + h * sdq.h;
  __nv_bfloat16* dkp = dk + b * sdk.b + h * sdk.h;
  __nv_bfloat16* dvp = dv + b * sdv.b + h * sdv.h;
  const float* bias_b = bias + (long long)b * Nk;
  // the query side's copies first: they land while the live tiles are found
  stage_rows_sw(Qs, q + b * sq.b + h * sq.h, sq.n, Nq, 16, tid, nt);
  stage_rows_sw(Gs, g + b * sg.b + h * sg.h, sg.n, Nq, 16, tid, nt);
  stage_floats(Ms, m_in + (long long)bh * Nq, Nq, 16, tid, nt);   // padded rows: m = inv = 0
  stage_floats(Is, inv_in + (long long)bh * Nq, Nq, 16, tid, nt);
  stage_floats(Bs, bias_b, Nk, 16 * kMaxKT, tid, nt);
  const unsigned mask = live_mask<kMaxKT>(bias_b, Nk);   // alike in every warp
  const int nl = __popc(mask);
  const unsigned long long idx = tile_list<kMaxKT>(mask);
  fetch_tiles(Ks, Vs, kp, vp, sk, sv, idx, 0, nl, Nk, tid, nt);
  zero_dead(dqp, dkp, dvp, sdq, sdk, sdv, mask, Nq, Nk, tid, nt);   // under the copies
  cp_async_wait_all();   // (also before leaving: no copy may land after the CTA is gone)
  if (nl == 0) return;
  __syncthreads();

  // s, dp and e of the 16 rows against this warp's live tiles j = warp + kKeysWarps jj
  const int rows[2] = {gr, gr + 8};
  float e[kKeysTiles][2][4], dp[kKeysTiles][2][4];
  {
    uint32_t qf[4][4], gf[4][4];
    load_a_sw(qf, Qs, 0);
    load_a_sw(gf, Gs, 0);
#pragma unroll
    for (int jj = 0; jj < kKeysTiles; ++jj) {
      const int j = warp + kKeysWarps * jj;
      if (j < nl)
        tile_scores(qf, gf, Ks + 16 * j * kMD, Vs + 16 * j * kMD, Ms, Bs, rows, tile_at(idx, j), Nk,
                    causal, scale, e[jj], dp[jj]);
    }
  }
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < kKeysTiles; ++jj)
    if (warp + kKeysWarps * jj < nl)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x) part[x >> 1] = fmaf(dp[jj][u][x], e[jj][u][x], part[x >> 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    part[r] = quad_sum(part[r]);
    if (c == 0) Cp[warp * 16 + rows[r]] = part[r];
  }
  __syncthreads();   // every warp's c partial is staged and its dp taken: V is free
  const float inv[2] = {Is[rows[0]], Is[rows[1]]};
  float cr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kKeysWarps; ++w) sum += Cp[w * 16 + rows[r]];   // warp order
    cr[r] = sum * inv[r];
  }
  // ds, the dq partial ds k, and dk = ds^T q, dv = e^T bf16(g inv) of each tile
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
  uint32_t ds_a[kKeysTiles][4], e_a[kKeysTiles][4];
#pragma unroll
  for (int jj = 0; jj < kKeysTiles; ++jj) {
    const int j = warp + kKeysWarps * jj;
    if (j >= nl) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        dp[jj][u][x] = e[jj][u][x] * ((dp[jj][u][x] - cr[x >> 1]) * inv[x >> 1]);
    pack_a(ds_a[jj], dp[jj][0], dp[jj][1]);
    pack_a(e_a[jj], e[jj][0], e[jj][1]);
    mma_pa_sw<false>(acc, ds_a[jj], Ks + 16 * j * kMD, 0, nullptr);
  }
  float* dqw = Dq + warp * 16 * kDqPitch;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(dqw + rows[r] * kDqPitch + 8 * j + 2 * c) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
#pragma unroll
  for (int jj = 0; jj < kKeysTiles; ++jj) {
    const int j = warp + kKeysWarps * jj;
    if (j >= nl) continue;
    const int t = tile_at(idx, j);
    uint32_t at[4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;
    transpose_a(at, ds_a[jj]);
    mma_pa_sw<false>(acc, at, Qs, 0, nullptr);
    store_rows(dkp, sdk.n, 16 * t, Nk, acc, scale);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[n][x] = 0.f;
    transpose_a(at, e_a[jj]);
    mma_pa_sw<true>(acc, at, Gs, 0, Is);
    store_rows(dvp, sdv.n, 16 * t, Nk, acc, 1.f);
  }
  __syncthreads();   // every dq partial is staged
  // dq = the partials summed in warp order, times scale
  for (int i = tid; i < 16 * 32; i += nt) {
    const int row = i >> 5, d = 2 * (i & 31);
    if (row >= Nq) continue;
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kKeysWarps; ++w) {
      const float2 p = *reinterpret_cast<const float2*>(Dq + (w * 16 + row) * kDqPitch + d);
      sum.x += p.x;
      sum.y += p.y;
    }
    *reinterpret_cast<uint32_t*>(dqp + row * sdq.n + d) = pack_bf16(sum.x * scale, sum.y * scale);
  }
}

// The strips mode's shared memory: q, g [nqp][64] swizzled bf16 and m, inv
// [nqp] fp32; the key bias [nkp]; a ring of kStripStages strips' K, V
// [16 kStripTiles][64]; one strip's bf16 e, ds [nqp][kStripPitch].
__host__ __device__ constexpr long long strips_smem_bytes(int nqp, int nkp) {
  return nqp * (2LL * kMD * 2 + 8) + 4LL * nkp + kStripStages * 2LL * 16 * kStripTiles * kMD * 2 +
         2LL * nqp * kStripPitch * 2;
}
static_assert(strips_smem_bytes(256, 256) <= kOneCtaSmem, "255 x 255 exceeds a CTA's shared memory");
// The strips mode's warps for n_qt query tiles: one a tile, 8 or 16.
__host__ __device__ constexpr int strips_warps(int n_qt) { return n_qt <= 8 ? 8 : kStripWarps; }

__global__ void __launch_bounds__(kStripWarps * 32, 1)
small_bwd_strips_kernel(SMALL_BWD_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStage = 2 * 16 * kStripTiles * kMD;   // bf16 of a ring stage: K, then V
  const int n_qt = (Nq + 15) / 16, nqp = 16 * n_qt;
  const int nkp = 16 * ((Nk + 15) / 16);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + nqp * kMD;
  __nv_bfloat16* Ring = Gs + nqp * kMD;
  __nv_bfloat16* Es = Ring + kStripStages * kStage;
  __nv_bfloat16* Ds = Es + nqp * kStripPitch;
  float* Ms = reinterpret_cast<float*>(Ds + nqp * kStripPitch);
  float* Is = Ms + nqp;
  float* Bs = Is + nqp;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;
  __nv_bfloat16* dqp = dq + b * sdq.b + h * sdq.h;
  __nv_bfloat16* dkp = dk + b * sdk.b + h * sdk.h;
  __nv_bfloat16* dvp = dv + b * sdv.b + h * sdv.h;
  const float* bias_b = bias + (long long)b * Nk;
  // the query side's copies first: they land while the live tiles are found
  stage_rows_sw(Qs, q + b * sq.b + h * sq.h, sq.n, Nq, nqp, tid, nt);
  stage_rows_sw(Gs, g + b * sg.b + h * sg.h, sg.n, Nq, nqp, tid, nt);
  stage_floats(Ms, m_in + (long long)bh * Nq, Nq, nqp, tid, nt);   // padded rows: m = inv = 0
  stage_floats(Is, inv_in + (long long)bh * Nq, Nq, nqp, tid, nt);
  stage_floats(Bs, bias_b, Nk, nkp, tid, nt);
  const unsigned mask = live_mask<kMaxKT>(bias_b, Nk);   // alike in every warp
  const int nl = __popc(mask);
  const unsigned long long idx = tile_list<kMaxKT>(mask);
  if (nl == 0) {
    cp_async_wait_all();   // no copy may land in shared memory after the CTA is gone
    zero_dead(dqp, dkp, dvp, sdq, sdk, sdv, mask, Nq, Nk, tid, nt);
    return;
  }

  // ring steps: when the live tiles span more than one strip, a c sweep
  // over the strips (steps 0 .. strips - 1) before the main pass; strip
  // i % strips at step i, in stage i % kStripStages, its copies
  // kStripStages - 1 steps ahead (one copy group a step, the first with the
  // query side's)
  const int strips = (nl + kStripTiles - 1) / kStripTiles;
  const bool sweep = strips > 1;
  const int steps = sweep ? 2 * strips : strips;
  auto fetch = [&](int i) {
    if (i < steps) {
      __nv_bfloat16* Kd = Ring + (i % kStripStages) * kStage;
      const int j0 = (i % strips) * kStripTiles;
      fetch_tiles(Kd, Kd + kStage / 2, kp, vp, sk, sv, idx, j0, min(kStripTiles, nl - j0), Nk, tid,
                  nt);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStripStages - 1; ++i) fetch(i);
  zero_dead(dqp, dkp, dvp, sdq, sdk, sdv, mask, Nq, Nk, tid, nt);   // under the copies

  // the warp's query tile: its q and g A fragments stay in registers
  const int qt = warp;
  const bool mine = qt < n_qt;
  const int rows[2] = {16 * qt + gr, 16 * qt + gr + 8};
  uint32_t qf[4][4], gf[4][4];
  float dqa[8][4], cr[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dqa[j][x] = 0.f;
  const int nwarps = nt >> 5;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStripStages - 2>();   // this thread's copies of strip i
    __syncthreads();   // strip i has landed; every warp is done with step i - 1
    fetch(i + kStripStages - 1);   // into the stage step i - 1 read
    if (i == 0) {
      if (mine) {
        load_a_sw(qf, Qs, 16 * qt);
        load_a_sw(gf, Gs, 16 * qt);
        inv[0] = Is[rows[0]];
        inv[1] = Is[rows[1]];
      }
      __syncthreads();   // every warp holds its g fragments: g becomes bf16(g inv) in place
      for (int e = tid; e < nqp * 8; e += nt) {   // dv's B operand, rounded as the product reads it
        const int r = e >> 3;
        uint4* p = reinterpret_cast<uint4*>(Gs + r * kMD) + (e & 7);
        uint4 w = *p;
        const float f = Is[r];
        w.x = scale_pair(w.x, f, f);
        w.y = scale_pair(w.y, f, f);
        w.z = scale_pair(w.z, f, f);
        w.w = scale_pair(w.w, f, f);
        *p = w;
      }
    }
    const int j0 = (i % strips) * kStripTiles, ns = min(kStripTiles, nl - j0);
    const __nv_bfloat16* Kb = Ring + (i % kStripStages) * kStage;
    const __nv_bfloat16* Vb = Kb + kStage / 2;
    const bool main_pass = !sweep || i >= strips;
    if (mine) {
      if (sweep && i == strips)   // the sweep is done: c of the tile's rows
#pragma unroll
        for (int r = 0; r < 2; ++r) cr[r] = quad_sum(cr[r]) * inv[r];
      // e and dp of the strip's tiles the rows see; kDs: ds, dq and the
      // staged e, ds from them; else their sum e dp (the sweep's, or one
      // strip's c before its ds)
      auto strip_pass = [&](auto kDs, float part[2]) {
#pragma unroll
        for (int jj = 0; jj < kStripTiles; ++jj) {
          const int t = jj < ns ? tile_at(idx, j0 + jj) : 0;
          if (jj >= ns || (causal && 16 * qt + 15 < 16 * t)) continue;   // no row sees these keys
          float e[2][4], dp[2][4];
          tile_scores(qf, gf, Kb + 16 * jj * kMD, Vb + 16 * jj * kMD, Ms, Bs, rows, t, Nk, causal,
                      scale, e, dp);
          if constexpr (!decltype(kDs)::value) {
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int x = 0; x < 4; ++x) part[x >> 1] = fmaf(dp[u][x], e[u][x], part[x >> 1]);
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int x = 0; x < 4; ++x)
                dp[u][x] = e[u][x] * ((dp[u][x] - cr[x >> 1]) * inv[x >> 1]);
            uint32_t da[4], ea[4];
            pack_a(da, dp[0], dp[1]);
            pack_a(ea, e[0], e[1]);
            mma_pa_sw<false>(dqa, da, Kb + 16 * jj * kMD, 0, nullptr);
#pragma unroll
            for (int x = 0; x < 4; ++x) {   // A fragment x: row + 8 (x & 1), key + 8 (x >> 1)
              const int off = rows[x & 1] * kStripPitch + 16 * jj + 8 * (x >> 1) + 2 * c;
              *reinterpret_cast<uint32_t*>(Es + off) = ea[x];
              *reinterpret_cast<uint32_t*>(Ds + off) = da[x];
            }
          }
        }
      };
      if (!main_pass) {
        strip_pass(std::false_type{}, cr);
      } else {
        if (!sweep) {   // one strip: its c first, from the staged strip
          float part[2] = {0.f, 0.f};
          strip_pass(std::false_type{}, part);
#pragma unroll
          for (int r = 0; r < 2; ++r) cr[r] = quad_sum(part[r]) * inv[r];
        }
        strip_pass(std::true_type{}, nullptr);
      }
    }
    if (!main_pass) continue;
    __syncthreads();   // the strip's e and ds are staged
    // key side: dk = ds^T q or dv = e^T bf16(g inv) (staged in place of g) of strip tile
    // ij, dims 32 hf .., over every query tile
    for (int item = warp; item < kStripItems; item += nwarps) {
      const int ij = (item >> 1) & 3, hf = item & 1;   // strip tile, half of the dims
      const bool item_dk = item >= kStripItems / 2;
      if (ij >= ns) continue;
      const int t = tile_at(idx, j0 + ij);
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
      const __nv_bfloat16* S = (item_dk ? Ds : Es) + 16 * ij;
      for (int qs = 0; qs < n_qt; ++qs) {
        if (causal && 16 * qs + 15 < 16 * t) continue;
        uint32_t a[4];   // the A fragment of ds^T or e^T (keys x rows)
        ldsm_x4_t(a, S + (16 * qs + (lane & 7) + 8 * (lane >> 4)) * kStripPitch + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int u = 0; u < 2; ++u)
          mma_pa_sw_n16<false>(acc[2 * u], acc[2 * u + 1], a, item_dk ? Qs : Gs, 16 * qs, nullptr,
                               2 * hf + u);
      }
      if (item_dk)
        store_cols<4>(dkp, sdk.n, 16 * t, Nk, 32 * hf, acc, scale);
      else
        store_cols<4>(dvp, sdv.n, 16 * t, Nk, 32 * hf, acc, 1.f);
    }
  }
  if (mine) store_rows(dqp, sdq.n, 16 * qt, Nq, dqa, scale);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
small_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const T* __restrict__ g,
                 const float* __restrict__ m_in, const float* __restrict__ inv_in,
                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, Strides sq,
                 Strides sk, Strides sv, Strides sg, Strides sdq, Strides sdk, Strides sdv, int H,
                 int Nq, int Nk, int Dh, int causal, float scale) {
  constexpr int QP = DP + 1;
  constexpr int DPT = DP / 16;
  constexpr int kRows = kMaxLen + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][QP]
  float* Gs = Qs + kBQ * QP;     // [kBQ][QP]  g, then g * inv cast to T
  float* Ks = Gs + kBQ * QP;     // [kBK][QP]
  float* Vs = Ks + kBK * QP;     // [kBK][QP]
  float* Es = Vs + kBK * QP;     // [kBQ][kSP] e cast to T
  float* Ds = Es + kBQ * kSP;    // [kBQ][kSP] ds cast to T
  float* Ms = Ds + kBQ * kSP;    // [kRows] m, inv, c of every query row; the key bias
  float* Is = Ms + kRows;
  float* Cs = Is + kRows;
  float* bs = Cs + kRows;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int b = bh / H;
  const T* qp = q + b * sq.b + h * sq.h;
  const T* gp = g + b * sg.b + h * sg.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  for (int j = threadIdx.x; j < kRows; j += kThreads) {
    const bool ok = j < Nq;   // padded rows: m = inv = 0, so they weigh nothing
    Ms[j] = ok ? m_in[(long long)bh * Nq + j] : 0.f;
    Is[j] = ok ? inv_in[(long long)bh * Nq + j] : 0.f;
    bs[j] = j < Nk ? bias[(long long)b * Nk + j] : 0.f;
  }

  auto e_of = [&](float s, int row, int col) {
    return expf(score(s, scale, bs, row, col, Nk, causal) - Ms[row]);
  };

  // 1. per query tile: c over the key tiles, then ds and dq
  for (int q0 = 0; q0 < Nq; q0 += kBQ) {
    __syncthreads();
    load_tile<T, DP>(Qs, QP, qp, sq.n, q0, Nq, Dh);
    load_tile<T, DP>(Gs, QP, gp, sg.n, q0, Nq, Dh);
    float cr[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < Nk; k0 += kBK) {
      __syncthreads();
      load_tile<T, DP>(Ks, QP, kp, sk.n, k0, Nk, Dh);
      load_tile<T, DP>(Vs, QP, vp, sv.n, k0, Nk, Dh);
      __syncthreads();
      float s[4][4], dp[4][4];
      scores_and_dp<DP>(Qs, Gs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cr[i] = fmaf(dp[i][j], e_of(s[i][j], q0 + ty + 16 * i, k0 + tx + 16 * j), cr[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      cr[i] = row_sum16(cr[i]) * Is[row];
      if (tx == 0) Cs[row] = cr[i];
    }
    float acc[4][DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < Nk; k0 += kBK) {
      __syncthreads();
      load_tile<T, DP>(Ks, QP, kp, sk.n, k0, Nk, Dh);
      load_tile<T, DP>(Vs, QP, vp, sv.n, k0, Nk, Dh);
      __syncthreads();
      float s[4][4], dp[4][4];
      scores_and_dp<DP>(Qs, Gs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rl = ty + 16 * i, cl = tx + 16 * j;
          Ds[rl * kSP + cl] = round_to<T>(e_of(s[i][j], q0 + rl, k0 + cl) *
                                          ((dp[i][j] - cr[i]) * Is[q0 + rl]));
        }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < kBK; ++cc) {
        float dsv[4], kv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = Ds[(ty + 16 * i) * kSP + cc];
#pragma unroll
        for (int j = 0; j < DPT; ++j) kv[j] = Ks[cc * QP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
      }
    }
    T* dqp = dq + b * sdq.b + h * sdq.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row >= Nq) continue;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < Dh) dqp[(long long)row * sdq.n + d] = from_f<T>(acc[i][j] * scale);
      }
    }
  }

  // 2. per key tile: dk and dv over every query tile (c is in Cs)
  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    __syncthreads();
    load_tile<T, DP>(Ks, QP, kp, sk.n, k0, Nk, Dh);
    load_tile<T, DP>(Vs, QP, vp, sv.n, k0, Nk, Dh);
    float dk_acc[4][DPT], dv_acc[4][DPT];   // keys ty + 16 i, dimensions tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
    for (int q0 = 0; q0 < Nq; q0 += kBQ) {
      __syncthreads();   // the previous query tile's reads are done
      load_tile<T, DP>(Qs, QP, qp, sq.n, q0, Nq, Dh);
      load_tile<T, DP>(Gs, QP, gp, sg.n, q0, Nq, Dh);
      __syncthreads();
      float s[4][4], dp[4][4];   // rows ty + 16 i, keys tx + 16 j
      scores_and_dp<DP>(Qs, Gs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, cl = tx + 16 * j;
          const float e = e_of(s[i][j], q0 + r, k0 + cl);
          Es[r * kSP + cl] = round_to<T>(e);
          Ds[r * kSP + cl] = round_to<T>(e * ((dp[i][j] - Cs[q0 + r]) * Is[q0 + r]));
        }
      __syncthreads();   // every thread's dp is computed: g may be overwritten
      for (int e = threadIdx.x; e < kBQ * DP; e += kThreads) {
        const int r = e / DP;
        const int d = e - r * DP;
        Gs[r * QP + d] = round_to<T>(Gs[r * QP + d] * Is[q0 + r]);
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float ev[4], dsv[4], gv[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ev[i] = Es[r * kSP + ty + 16 * i];
          dsv[i] = Ds[r * kSP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          gv[j] = Gs[r * QP + tx + 16 * j];
          qv[j] = Qs[r * QP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            dv_acc[i][j] = fmaf(ev[i], gv[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
    T* dkp = dk + b * sdk.b + h * sdk.h;
    T* dvp = dv + b * sdv.b + h * sdv.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
      if (key >= Nk) continue;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        if (d < Dh) {
          dkp[(long long)key * sdk.n + d] = from_f<T>(dk_acc[i][j] * scale);
          dvp[(long long)key * sdv.n + d] = from_f<T>(dv_acc[i][j]);
        }
      }
    }
  }
}

// ---- fp32, Dh = 64: three TF32 products on mma.sync m16n8k8 ----
//
// small_bwd_tf32_kernel: a CTA a (batch, head) pair, kTf32BwdWarps warps,
// two CTAs an SM. The pair's query rows go in chunks of kTf32Chunk (a query
// tile a warp): a chunk's q and g rows, m and inv are staged in shared
// memory (cp.async, fp32 rows of pitch kTf32Pitch). The live key tiles are
// the forward's; a strip is up to kTf32Strip of them, packed, and its K and
// V rows are staged too (read through L1 instead, they missed it: two CTAs'
// staging leaves L1 ~40 KB, and each of six warps read them again from L2;
// staged, the 81 x 81 backward took half the time on an H100, PERF.md).
// Query side (each warp its tile): s and dp over the strip's tiles in
// registers (flash_attention_small.cuh's permuted float4 fragments), c =
// rowsum(dp e) inv, ds, dq = ds k; once every warp is done with K and V, e
// and ds are written over them, [chunk rows][strip keys] (a pitch of 4 mod
// 8 puts the key side's transposed reads in distinct banks). Key side (a
// warp a (live tile, dk or dv, half of the dims) item): dk = ds^T q, dv =
// e^T (g inv) over the chunk's rows. No atomics: a row's dq and a key's dk,
// dv stay with one warp across strips and chunks (the later ones add to what
// the first stored), and keys in no live tile get dk = dv = 0. Where a
// row's live tiles span several strips, its c comes from a first sweep over
// all of them. At Nq <= 16 the pair is one query tile, so a warp takes a
// pair over its own slice of shared memory (one chunk, K and V read from
// global memory: a slice has no room for them).
constexpr int kTf32Strip = 4;      // live key tiles a strip
constexpr int kTf32Chunk = 96;     // query rows a chunk
constexpr int kTf32Pitch = 68;     // floats a staged row (q, g, e, ds)
constexpr int kTf32BwdWarps = 6;
constexpr long long kTf32BwdSmem = (4LL * kTf32Chunk * kTf32Pitch + 3 * kTf32Chunk) * 4;
constexpr int kTf32WarpSlice = 4 * 16 * kTf32Pitch + 3 * 16;   // floats: a warp's 16-row chunk
static_assert(kTf32BwdWarps * kTf32WarpSlice * 4LL <= kTf32BwdSmem, "warp slices exceed the CTA's");
static_assert(kTf32Chunk == 16 * kTf32BwdWarps, "a warp owns one query tile of a chunk");
static_assert(2 * 16 * kTf32Strip <= 2 * kTf32Chunk, "a strip's K and V fit where e and ds go");

// acc (16 query rows of chunk tile qt x the strip's keys) = A B^T for A the
// staged rows ``As`` (q or g) and B key rows (k or v): staged (kStaged: the
// strip's live tiles packed at ``Kb``, rows past Nk zeros) or strided in
// global memory (row stride kn); live-list tiles j0 .. j0 + ns - 1, keys
// 16 t + 8 u + 2 c (+1) in acc[2 jj + u] (the accumulator layout)
template <bool kStaged>
__device__ __forceinline__ void tf32_rows_keys(const float* As, const float* Kb, long long kn,
                                               int qt, int Nk, unsigned long long idx, int j0,
                                               int ns, float acc[2 * kTf32Strip][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int r0 = (16 * qt + g) * kTf32Pitch, r1 = r0 + 8 * kTf32Pitch;
#pragma unroll
  for (int j = 0; j < 2 * kTf32Strip; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int d = 16 * kk + 4 * c;
    uint32_t ab[2][4], as[2][4];
    frag_a_dims(*reinterpret_cast<const float4*>(As + r0 + d),
                *reinterpret_cast<const float4*>(As + r1 + d), ab, as);
#pragma unroll
    for (int jj = 0; jj < kTf32Strip; ++jj)
      if (jj < ns) {
        const int t = (int)((idx >> (4 * (j0 + jj))) & 15ull);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = 16 * t + 8 * u + g;
          mma_dims(acc[2 * jj + u], ab, as,
                   kStaged ? *reinterpret_cast<const float4*>(Kb + (16 * jj + 8 * u + g) * kTf32Pitch + d)
                           : ldg4(Kb + key * kn + d, key < Nk));
        }
      }
  }
}

template <bool kWarp>
__device__ __forceinline__ void group_sync() {
  if constexpr (kWarp) __syncwarp(); else __syncthreads();
}

// The backward of pair bh by a group: the CTA (kWarp false: kTf32BwdWarps
// warps, chunks of kTf32Chunk query rows, each strip's K and V staged) or
// one warp (kWarp true, Nq <= 16: one chunk of 16 rows, K and V read from
// global memory), over ``sm``, its shared memory. A warp owns one query
// tile of a chunk (``warp``), so it keeps e and ds in registers while the
// group reads the strip's K / V, then writes them over it. gtid / gthreads:
// the thread's index in the group and the group's size.
template <bool kWarp>
__device__ __forceinline__ void tf32_bwd_pair(float* sm, int warp, int gtid, int gthreads, int bh,
                                              const float* __restrict__ q,
                                              const float* __restrict__ k,
                                              const float* __restrict__ v,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ g,
                                              const float* __restrict__ m_in,
                                              const float* __restrict__ inv_in,
                                              float* __restrict__ dq, float* __restrict__ dk,
                                              float* __restrict__ dv, const Strides& sq,
                                              const Strides& sk, const Strides& sv,
                                              const Strides& sg, const Strides& sdq,
                                              const Strides& sdk, const Strides& sdv, int H, int Nq,
                                              int Nk, int causal, float scale) {
  constexpr bool kStaged = !kWarp;
  constexpr int chunk = kWarp ? 16 : kTf32Chunk;
  float* Qs = sm;                         // [chunk][kTf32Pitch] the chunk's q rows
  float* Gs = Qs + chunk * kTf32Pitch;    // g rows
  float* Us = Gs + chunk * kTf32Pitch;    // the strip's K, V [64][kTf32Pitch] each (CTA),
  float* Es = Us;                         // then e and ds of its keys [chunk][kTf32Pitch]
  float* Ds = Es + chunk * kTf32Pitch;
  float* Ms = Ds + chunk * kTf32Pitch;    // [chunk] m, inv, c of the chunk's rows
  float* Is = Ms + chunk;
  float* Cs = Is + chunk;
  const float* Ks = Us;
  const float* Vs = Us + 16 * kTf32Strip * kTf32Pitch;
  const int lane = threadIdx.x & 31, gr = lane >> 2, c = lane & 3;
  const int b = bh / H, h = bh % H;
  const float* qp = q + b * sq.b + h * sq.h;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
  const float* gp = g + b * sg.b + h * sg.h;
  float* dqp = dq + b * sdq.b + h * sdq.h;
  float* dkp = dk + b * sdk.b + h * sdk.h;
  float* dvp = dv + b * sdv.b + h * sdv.h;
  const float* bs = bias + (long long)b * Nk;
  const unsigned mask = live_mask<16>(bs, Nk);   // alike in every warp
  const int nl = __popc(mask);
  const unsigned long long idx = tile_list<16>(mask);
  const int strips = (nl + kTf32Strip - 1) / kTf32Strip;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // keys in no live tile: no row attends them
  for (int e = gtid; e < Nk * 16; e += gthreads) {
    const int key = e >> 4, d = 4 * (e & 15);
    if ((mask >> (key >> 4)) & 1u) continue;
    *reinterpret_cast<float4*>(dkp + key * sdk.n + d) = zero;
    *reinterpret_cast<float4*>(dvp + key * sdv.n + d) = zero;
  }
  if (strips == 0) {   // no valid key: every gradient of the pair is 0
    for (int e = gtid; e < Nq * 16; e += gthreads)
      *reinterpret_cast<float4*>(dqp + (e >> 4) * sdq.n + 4 * (e & 15)) = zero;
    return;
  }
  // the strip's K and V rows, packed (CTA), once the group is done with
  // what the region held
  auto stage_kv = [&](int j0, int ns) {
    if constexpr (kStaged) {
      group_sync<kWarp>();
      for (int e = gtid; e < ns * 16 * 16; e += gthreads) {
        const int r = e >> 4, d = 4 * (e & 15);
        const int key = 16 * (int)((idx >> (4 * (j0 + (r >> 4)))) & 15ull) + (r & 15);
        const bool ok = key < Nk;
        cp_async16(Us + r * kTf32Pitch + d, ok ? kp + key * sk.n + d : kp, ok ? 16 : 0);
        cp_async16(Us + (16 * kTf32Strip + r) * kTf32Pitch + d, ok ? vp + key * sv.n + d : vp,
                   ok ? 16 : 0);
      }
      cp_async_wait_all();
      group_sync<kWarp>();
    }
  };
  const float* kb = kStaged ? Ks : kp;
  const float* vb = kStaged ? Vs : vp;
  float s[2 * kTf32Strip][4], dp[2 * kTf32Strip][4];

  for (int c0 = 0; c0 < Nq; c0 += chunk) {
    const int nqc = min(chunk, Nq - c0), n_qt = (nqc + 15) / 16;
    const int qt = warp;   // this warp's query tile of the chunk
    const bool mine = qt < n_qt;
    // stage the chunk (rows past Nq: zeros, and m = inv = 0, so they weigh
    // nothing) once the previous chunk's key side has read it
    group_sync<kWarp>();
    for (int e = gtid; e < 16 * n_qt * 16; e += gthreads) {
      const int r = e >> 4, d = 4 * (e & 15);
      const bool ok = r < nqc;
      cp_async16(Qs + r * kTf32Pitch + d, ok ? qp + (c0 + r) * sq.n + d : qp, ok ? 16 : 0);
      cp_async16(Gs + r * kTf32Pitch + d, ok ? gp + (c0 + r) * sg.n + d : gp, ok ? 16 : 0);
    }
    for (int r = gtid; r < 16 * n_qt; r += gthreads) {
      Ms[r] = r < nqc ? m_in[(long long)bh * Nq + c0 + r] : 0.f;
      Is[r] = r < nqc ? inv_in[(long long)bh * Nq + c0 + r] : 0.f;
    }
    cp_async_wait_all();
    group_sync<kWarp>();

    // e = exp(s - m) of an element of the warp's tile accumulator
    auto e_of = [&](float dot, int x, int col) {
      const int r = 16 * qt + gr + 8 * (x >> 1);
      return exp_score(dot, scale, col < Nk ? bs[col] : 0.f, c0 + r, col, Nk, causal, Ms[r]);
    };
    if (strips > 1) {   // each row's c over every strip first
      float cr[2] = {0.f, 0.f};
      for (int st = 0; st < strips; ++st) {
        const int j0 = st * kTf32Strip, ns = min(kTf32Strip, nl - j0);
        stage_kv(j0, ns);
        if (!mine) continue;
        tf32_rows_keys<kStaged>(Qs, kb, sk.n, qt, Nk, idx, j0, ns, s);
        tf32_rows_keys<kStaged>(Gs, vb, sv.n, qt, Nk, idx, j0, ns, dp);
#pragma unroll
        for (int jj = 0; jj < kTf32Strip; ++jj)
          if (jj < ns) {
            const int t = (int)((idx >> (4 * (j0 + jj))) & 15ull);
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int x = 0; x < 4; ++x)
                cr[x >> 1] += dp[2 * jj + u][x] * e_of(s[2 * jj + u][x], x, 16 * t + 8 * u + 2 * c + (x & 1));
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        cr[r] = quad_sum(cr[r]);
        if (mine && c == 0) Cs[16 * qt + gr + 8 * r] = cr[r] * Is[16 * qt + gr + 8 * r];
      }
      __syncwarp();   // a warp reads back only its own rows' c
    }

    for (int st = 0; st < strips; ++st) {
      const int j0 = st * kTf32Strip, ns = min(kTf32Strip, nl - j0);
      stage_kv(j0, ns);
      // query side: s, dp, c, ds and dq = ds k, e and ds kept in registers
      if (mine) {
        tf32_rows_keys<kStaged>(Qs, kb, sk.n, qt, Nk, idx, j0, ns, s);
        tf32_rows_keys<kStaged>(Gs, vb, sv.n, qt, Nk, idx, j0, ns, dp);
        const float is[2] = {Is[16 * qt + gr], Is[16 * qt + gr + 8]};
        float cr[2] = {0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < kTf32Strip; ++jj)
          if (jj < ns) {
            const int t = (int)((idx >> (4 * (j0 + jj))) & 15ull);
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                s[2 * jj + u][x] = e_of(s[2 * jj + u][x], x, 16 * t + 8 * u + 2 * c + (x & 1));
                cr[x >> 1] += dp[2 * jj + u][x] * s[2 * jj + u][x];
              }
          }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          cr[r] = strips == 1 ? quad_sum(cr[r]) * is[r] : Cs[16 * qt + gr + 8 * r];
#pragma unroll
        for (int jj = 0; jj < kTf32Strip; ++jj)
          if (jj < ns)
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int x = 0; x < 4; ++x)
                dp[2 * jj + u][x] = s[2 * jj + u][x] * ((dp[2 * jj + u][x] - cr[x >> 1]) * is[x >> 1]);
        float acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
#pragma unroll
        for (int jj = 0; jj < kTf32Strip; ++jj)
          if (jj < ns) {
            const int t = (int)((idx >> (4 * (j0 + jj))) & 15ull);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              uint32_t ab[4], as[4];
              frag_a_acc(dp[2 * jj + u], ab, as);
              float r0[8], r1[8];
              if constexpr (kStaged) {
                const float* k0 = Ks + (16 * jj + 8 * u + 2 * c) * kTf32Pitch + 8 * gr;
#pragma unroll
                for (int i = 0; i < 8; ++i) r0[i] = k0[i], r1[i] = k0[kTf32Pitch + i];
              } else {
                const int k0 = 16 * t + 8 * u + 2 * c;
                load8(r0, kp + k0 * sk.n, k0 < Nk);
                load8(r1, kp + (k0 + 1) * sk.n, k0 + 1 < Nk);
              }
              mma_rows<8>(acc, ab, as, r0, r1);
            }
          }
        float mul[2] = {scale, scale};
        float* dqc = dqp + c0 * sdq.n;
        if (st > 0) {   // add the earlier strips' dq, stored by this warp
          mul[0] = mul[1] = 1.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = min(16 * qt + gr + 8 * r, nqc - 1);   // a padded row's sum is not stored
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int n4 = 0; n4 < 8; n4 += 4) {
                const float4 pv = *reinterpret_cast<const float4*>(dqc + row * sdq.n + 16 * c + 8 * hh + n4);
                acc[n4][2 * r + hh] = fmaf(acc[n4][2 * r + hh], scale, pv.x);
                acc[n4 + 1][2 * r + hh] = fmaf(acc[n4 + 1][2 * r + hh], scale, pv.y);
                acc[n4 + 2][2 * r + hh] = fmaf(acc[n4 + 2][2 * r + hh], scale, pv.z);
                acc[n4 + 3][2 * r + hh] = fmaf(acc[n4 + 3][2 * r + hh], scale, pv.w);
              }
          }
        }
        store_dims<8>(dqc, sdq.n, 16 * qt, nqc, 0, acc, mul);
      }
      group_sync<kWarp>();   // every warp is done with the strip's K and V
      if (mine) {
#pragma unroll
        for (int jj = 0; jj < kTf32Strip; ++jj)
          if (jj < ns)
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int at = (16 * qt + gr + 8 * r) * kTf32Pitch + 16 * jj + 8 * u + 2 * c;
                *reinterpret_cast<float2*>(Es + at) = make_float2(s[2 * jj + u][2 * r], s[2 * jj + u][2 * r + 1]);
                *reinterpret_cast<float2*>(Ds + at) = make_float2(dp[2 * jj + u][2 * r], dp[2 * jj + u][2 * r + 1]);
              }
      }
      group_sync<kWarp>();   // e and ds staged

      // key side: items (strip tile jj, dv or dk, dims half) over the warps
      for (int item = warp; item < 4 * ns; item += (kWarp ? 1 : kTf32BwdWarps)) {
        const int jj = item >> 2, is_dk = (item >> 1) & 1, hf = item & 1;
        const int t = (int)((idx >> (4 * (j0 + jj))) & 15ull);
        const float* S = is_dk ? Ds : Es;
        const float* B = is_dk ? Qs : Gs;
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
        for (int qq = 0; qq < n_qt; ++qq) {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int q0 = 16 * qq + 8 * ks + 2 * c;   // k index c: row q0, c + 4: row q0 + 1
            const float* e0 = S + q0 * kTf32Pitch + 16 * jj + gr;
            const float a[4] = {e0[0], e0[8], e0[kTf32Pitch], e0[kTf32Pitch + 8]};
            uint32_t ab[4], as[4];
            split4(a, ab, as);
            const float w0 = is_dk ? 1.f : Is[q0], w1 = is_dk ? 1.f : Is[q0 + 1];
            const float4 x = *reinterpret_cast<const float4*>(B + q0 * kTf32Pitch + 8 * gr + 4 * hf);
            const float4 y = *reinterpret_cast<const float4*>(B + (q0 + 1) * kTf32Pitch + 8 * gr + 4 * hf);
            const float r0[4] = {x.x * w0, x.y * w0, x.z * w0, x.w * w0};
            const float r1[4] = {y.x * w1, y.y * w1, y.z * w1, y.w * w1};
            mma_rows<4>(acc, ab, as, r0, r1);
          }
        }
        float* dst = is_dk ? dkp : dvp;
        const long long dn = is_dk ? sdk.n : sdv.n;
        float mul[2] = {is_dk ? scale : 1.f, is_dk ? scale : 1.f};
        if (c0 > 0) {   // add the earlier chunks' sums, stored by this warp
          mul[0] = mul[1] = 1.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = min(16 * t + gr + 8 * r, Nk - 1);   // a key past Nk is not stored
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float4 pv = *reinterpret_cast<const float4*>(dst + key * dn + 16 * c + 8 * hh + 4 * hf);
              const float w = is_dk ? scale : 1.f;
              acc[0][2 * r + hh] = fmaf(acc[0][2 * r + hh], w, pv.x);
              acc[1][2 * r + hh] = fmaf(acc[1][2 * r + hh], w, pv.y);
              acc[2][2 * r + hh] = fmaf(acc[2][2 * r + hh], w, pv.z);
              acc[3][2 * r + hh] = fmaf(acc[3][2 * r + hh], w, pv.w);
            }
          }
        }
        store_dims<4>(dst, dn, 16 * t, Nk, 4 * hf, acc, mul);
      }
    }
  }
}


// The backward's kernel: a CTA a pair (kWarp false) or, for Nq <= 16, a warp
// a pair, each warp over its own slice of the CTA's shared memory (the
// query side of such a pair is one tile: one warp would compute it while
// the CTA's others waited).
template <bool kWarp>
__global__ void __launch_bounds__(kTf32BwdWarps * 32, 2)
small_bwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ g, const float* __restrict__ m_in,
                      const float* __restrict__ inv_in, float* __restrict__ dq,
                      float* __restrict__ dk, float* __restrict__ dv, Strides sq, Strides sk,
                      Strides sv, Strides sg, Strides sdq, Strides sdk, Strides sdv, int BH, int H,
                      int Nq, int Nk, int causal, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int warp = threadIdx.x >> 5;
  if constexpr (kWarp) {
    const int bh = blockIdx.x * kTf32BwdWarps + warp;
    if (bh < BH)
      tf32_bwd_pair<true>(smem_f + warp * kTf32WarpSlice, 0, threadIdx.x & 31, 32, bh, q, k, v,
                          bias, g, m_in, inv_in, dq, dk, dv, sq, sk, sv, sg, sdq, sdk, sdv, H, Nq,
                          Nk, causal, scale);
  } else {
    tf32_bwd_pair<false>(smem_f, warp, threadIdx.x, blockDim.x, blockIdx.x, q, k, v, bias, g,
                         m_in, inv_in, dq, dk, dv, sq, sk, sv, sg, sdq, sdk, sdv, H, Nq, Nk,
                         causal, scale);
  }
}

inline int launch_bwd_tf32(const void* q, const void* k, const void* v, const float* bias,
                           const void* g, const float* m, const float* inv, void* dq, void* dk,
                           void* dv, const Strides* st, int B, int H, int Nq, int Nk, int causal,
                           float scale, int device, cudaStream_t stream) {
  const int BH = B * H;
  const bool by_warp = Nq <= 16;
  auto kernel = by_warp ? small_bwd_tf32_kernel<true> : small_bwd_tf32_kernel<false>;
  cudaError_t err = prepare(kernel, (size_t)kTf32BwdSmem, device);
  if (err != cudaSuccess) return (int)err;
  typedef const float* P;
  const unsigned grid = (unsigned)(by_warp ? (BH + kTf32BwdWarps - 1) / kTf32BwdWarps : BH);
  kernel<<<grid, kTf32BwdWarps * 32, (size_t)kTf32BwdSmem, stream>>>(
      (P)q, (P)k, (P)v, bias, (P)g, m, inv, (float*)dq, (float*)dk, (float*)dv, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], BH, H, Nq, Nk, causal, scale);
  return (int)cudaGetLastError();
}

// The kernel family that operands of ``dtype`` take at Dh = 64 (Route,
// flash_attention_small.cuh): fp32 the TF32 kernel when q, k, v, g, dq, dk
// and dv all have 16-byte aligned rows (float4 reads and stores); bf16 the
// mma.sync kernels when q, k, v and g have 16-byte aligned rows and dq, dk,
// dv 4-byte aligned pairs; else the CUDA-core kernel. The one place this
// gate lives: the launcher takes it and flash_small_bwd_gate exports it.
inline int bwd_gate(int dtype, const void* const ops[7], const long long* strides) {
  bool ok = true;
  for (int i = 0; i < 7; ++i) {
    const long long* st = strides + 3 * i;
    if (dtype == 0)
      ok = ok && tf32_aligned(ops[i], st);
    else if (i < 4)
      ok = ok && mma_aligned(ops[i], st);
    else
      ok = ok && (uintptr_t)ops[i] % 4 == 0 && st[0] % 2 == 0 && st[1] % 2 == 0 && st[2] % 2 == 0;
  }
  return ok ? (dtype == 0 ? kRouteTf32x3 : kRouteMmaBf16) : kRouteCudaCores;
}

// The bf16 Dh = 64 kernel of a shape: a warp a pair (rows), a CTA a pair
// at a time (tiles) or a CTA a pair over its live key tiles (strips: the
// keys mode at Nq <= 16, else strips of one tile). The one place this rule
// lives: flash_small_bwd_route exports it.
enum BwdRoute { kRouteRows = 0, kRouteTiles = 1, kRouteStrips = 2 };
inline int bwd_route(int Nq, int Nk) {
  const int KT = (Nk + 15) / 16, n_qt = (Nq + 15) / 16;
  if (KT > kRowKT) return kRouteStrips;
  if (n_qt == 1) return kRouteRows;
  return tiles_smem_bytes(16 * n_qt, 16 * KT) <= kOneCtaSmem ? kRouteTiles : kRouteStrips;
}

inline int launch_bwd_mma(const void* q, const void* k, const void* v, const float* bias,
                          const void* g, const float* m, const float* inv, void* dq, void* dk,
                          void* dv, const Strides* st, int B, int H, int Nq, int Nk, int causal,
                          float scale, int device, cudaStream_t stream) {
  const int KT = (Nk + 15) / 16;
  const int n_qt = (Nq + 15) / 16;
  const int BH = B * H;
  typedef const __nv_bfloat16* P;
  typedef __nv_bfloat16* O;
#define SMALL_BWD_ARGS                                                                        \
  (P)q, (P)k, (P)v, bias, (P)g, m, inv, (O)dq, (O)dk, (O)dv, st[0], st[1], st[2], st[3], st[4], \
      st[5], st[6], BH, H, Nq, Nk, causal, scale
  const int route = bwd_route(Nq, Nk);
  if (route == kRouteRows) {   // a warp a pair, one stage a warp
    const long long stage = pair_stage_bytes(16, 16 * KT);
    const int warps = (int)std::min<long long>(kOneCtaSmem / stage, kMaxWarps);
    const long long smem = warps * stage;
    const int units = (BH + warps - 1) / warps;
    switch (KT) {
#define SMALL_BWD_ROWS(n)                                                                     \
  case n:                                                                                     \
    return launch_persistent(small_bwd_rows_kernel<n>, warps, smem, units, device, stream,    \
                             SMALL_BWD_ARGS);
      SMALL_BWD_ROWS(1) SMALL_BWD_ROWS(2) SMALL_BWD_ROWS(3)
      SMALL_BWD_ROWS(4) SMALL_BWD_ROWS(5) SMALL_BWD_ROWS(6)
#undef SMALL_BWD_ROWS
    }
  }
  if (route == kRouteTiles) {   // a CTA a pair at a time
    const int warps = std::min(kTileWarps, std::max(n_qt, KT));
    const long long smem = tiles_smem_bytes(16 * n_qt, 16 * KT);
    switch (KT) {
#define SMALL_BWD_TILES(n)                                                                    \
  case n:                                                                                     \
    return launch_persistent(small_bwd_tiles_kernel<n>, warps, smem, BH, device, stream,      \
                             SMALL_BWD_ARGS);
      SMALL_BWD_TILES(1) SMALL_BWD_TILES(2) SMALL_BWD_TILES(3)
      SMALL_BWD_TILES(4) SMALL_BWD_TILES(5) SMALL_BWD_TILES(6)
#undef SMALL_BWD_TILES
    }
  }
  // the live key tiles, a CTA a pair: split over 4 warps (Nq <= 16) or in strips of one
  if (n_qt == 1) {
    cudaError_t err = prepare(small_bwd_keys_kernel, (size_t)kKeysSmem, device);
    if (err != cudaSuccess) return (int)err;
    small_bwd_keys_kernel<<<(unsigned)BH, 32 * kKeysWarps, (size_t)kKeysSmem, stream>>>(SMALL_BWD_ARGS);
  } else {
    const size_t smem = (size_t)strips_smem_bytes(16 * n_qt, 16 * KT);
    cudaError_t err = prepare(small_bwd_strips_kernel, smem, device);
    if (err != cudaSuccess) return (int)err;
    small_bwd_strips_kernel<<<(unsigned)BH, 32 * strips_warps(n_qt), smem, stream>>>(SMALL_BWD_ARGS);
  }
#undef SMALL_BWD_ARGS
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_bwd(const void* q, const void* k, const void* v, const float* bias, const void* g,
               const float* m, const float* inv, void* dq, void* dk, void* dv, const Strides* st,
               int B, int H, int Nq, int Nk, int Dh, int causal, float scale, int device,
               cudaStream_t stream) {
  auto kernel = small_bwd_kernel<T, DP>;
  const size_t smem =
      sizeof(float) * (size_t)(4 * kBQ * (DP + 1) + 2 * kBQ * kSP + 4 * (kMaxLen + 1));
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(B * H), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (const T*)g, m, inv, (T*)dq, (T*)dk, (T*)dv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], H, Nq, Nk, Dh, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dp(int DP, const void* q, const void* k, const void* v, const float* bias,
                  const void* g, const float* m, const float* inv, void* dq, void* dk, void* dv,
                  const Strides* st, int B, int H, int Nq, int Nk, int Dh, int causal, float scale,
                  int device, cudaStream_t stream) {
  switch (DP) {
    case 32: return launch_bwd<T, 32>(q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, Dh, causal, scale, device, stream);
    case 64: return launch_bwd<T, 64>(q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, Dh, causal, scale, device, stream);
    case 128: return launch_bwd<T, 128>(q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, Dh, causal, scale, device, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace small
}  // namespace flash

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dq, dk, dv share it).
// strides: 21 element strides, (batch, head, seq) of q, k, v, g, dq, dk, dv.
// bias: (B, Nk) fp32, contiguous. m, inv: the forward's (B, H, Nq) row
// statistics, fp32, contiguous. Nq, Nk in [1, 255], Dh <= 128. One launch;
// returns its CUDA error code (0 = ok).
int flash_small_bwd_launch(int dtype, const void* q, const void* k, const void* v,
                           const float* bias, const void* g, const float* m, const float* inv,
                           void* dq, void* dk, void* dv, const long long* strides, int B, int H,
                           int Nq, int Nk, int Dh, int causal, float scale, int device,
                           void* stream) {
  using namespace flash;
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return 0;
  const int DP = dp_for(Dh);
  if (Nq > small::kMaxLen || Nk > small::kMaxLen || Dh <= 0 || DP == 0 ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  Strides st[7];
  for (int i = 0; i < 7; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const void* ops[7] = {q, k, v, g, dq, dk, dv};
  const int route = Dh == kMD ? small::bwd_gate(dtype, ops, strides) : small::kRouteCudaCores;
  if (route == small::kRouteTf32x3)
    return small::launch_bwd_tf32(q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, causal, scale, device, s);
  if (route == small::kRouteMmaBf16)
    return small::launch_bwd_mma(q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, causal, scale, device, s);
  if (dtype == 0)
    return small::launch_bwd_dp<float>(DP, q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, Dh, causal, scale, device, s);
  return small::launch_bwd_dp<__nv_bfloat16>(DP, q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, Dh, causal, scale, device, s);
}

// The kernel family that operands of ``dtype`` at these addresses and
// strides (21, as the launch takes them) take at Dh = 64: 0 = the CUDA-core
// kernel, 1 = the bf16 mma.sync kernels (flash_small_bwd_route picks
// among them), 2 = small_bwd_tf32_kernel (fp32).
int flash_small_bwd_gate(int dtype, const void* q, const void* k, const void* v, const void* g,
                         const void* dq, const void* dk, const void* dv, const long long* strides,
                         int Dh) {
  using namespace flash::small;
  const void* ops[7] = {q, k, v, g, dq, dk, dv};
  return Dh == flash::kMD ? bwd_gate(dtype, ops, strides) : kRouteCudaCores;
}

// The fp32 Dh = 64 kernel's launch on ``device`` (one for every shape):
// out[0] warps a CTA, out[1] shared memory a CTA in bytes, out[2] CTAs an SM
// (0 on an error).
void flash_small_bwd_tf32_plan(int device, long long* out) {
  using namespace flash;
  const long long smem = small::kTf32BwdSmem;
  int per_sm = 0;
  if (use_device(device) == cudaSuccess &&
      prepare(small::small_bwd_tf32_kernel<false>, (size_t)smem, device) == cudaSuccess)
    per_sm = blocks_per_sm(small::small_bwd_tf32_kernel<false>, 32 * small::kTf32BwdWarps,
                           (size_t)smem, device);
  const long long vals[3] = {small::kTf32BwdWarps, smem, per_sm};
  for (int i = 0; i < 3; ++i) out[i] = vals[i];
}

// The bf16 Dh = 64 kernel that takes an (Nq, Nk) shape of aligned operands:
// 0 = small_bwd_rows_kernel, 1 = small_bwd_tiles_kernel, 2 = the strips
// route (small_bwd_keys_kernel at Nq <= 16, else small_bwd_strips_kernel).
int flash_small_bwd_route(int Nq, int Nk) { return flash::small::bwd_route(Nq, Nk); }

// The strips route's launch at (Nq, Nk) on ``device``: out[0] warps a CTA,
// out[1] shared memory a CTA in bytes, out[2] CTAs an SM (0 on an error),
// out[3] 1 for the keys mode; all -1 when the shape takes another route.
void flash_small_bwd_strips_plan(int Nq, int Nk, int device, long long* out) {
  using namespace flash;
  using namespace flash::small;
  for (int i = 0; i < 4; ++i) out[i] = -1;
  if (Nq < 1 || Nk < 1 || Nq > kMaxLen || Nk > kMaxLen || bwd_route(Nq, Nk) != kRouteStrips) return;
  const bool keys = Nq <= 16;
  const int warps = keys ? kKeysWarps : strips_warps((Nq + 15) / 16);
  const long long smem = keys ? kKeysSmem : strips_smem_bytes(16 * ((Nq + 15) / 16), 16 * ((Nk + 15) / 16));
  int per_sm = 0;
  if (use_device(device) == cudaSuccess) {
    if (keys && prepare(small_bwd_keys_kernel, (size_t)smem, device) == cudaSuccess)
      per_sm = blocks_per_sm(small_bwd_keys_kernel, 32 * warps, (size_t)smem, device);
    if (!keys && prepare(small_bwd_strips_kernel, (size_t)smem, device) == cudaSuccess)
      per_sm = blocks_per_sm(small_bwd_strips_kernel, 32 * warps, (size_t)smem, device);
  }
  const long long vals[4] = {warps, smem, per_sm, keys ? 1 : 0};
  for (int i = 0; i < 4; ++i) out[i] = vals[i];
}

const char* flash_small_bwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

FLASH_EXPORT_ATTRIBUTE_CALLS(flash_small_bwd)

}  // extern "C"
