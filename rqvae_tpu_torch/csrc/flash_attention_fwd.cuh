// Fused masked attention, forward, templated on a mask policy
// (flash_attention_common.cuh): out = softmax(masked(q k^T / sqrt(Dh))) v,
// plus the row statistics the backward reads. flash_attention_fwd.cu binds
// it to the key-bias mask and replaces the TPU kernel
// rqvae_tpu/ops/flash_attention.py:_flash_kernel; flash_attention_spans_fwd.cu
// binds it to the span mask and replaces :_flash_span_kernel.
//
// Same function as the TPU kernels: scores in fp32, the mask applied as its
// policy says, the unnormalised e = exp(s - m) cast to the operand type
// before the PV product, and inv = (m > -5e29 ? 1 / sum(e) : 0) folded into
// the output, so a row with no allowed key gives zeros.
//
// What differs from the TPU kernels, and why: they hold all of K and V of
// one (batch, head) in VMEM and take one softmax over the whole row. At
// Nk = 801, Dh = 64 that is 200 KB in bf16 (400 KB staged as fp32), beyond
// the 227 KB of shared memory an H100 block may use, so this kernel tiles
// keys (64 per tile) with an online softmax: a running max m and sum l per
// row, the accumulator rescaled by exp(m_old - m_new) when the max grows. A
// row whose first tiles are all masked carries m = -1e30 and e = 1 until an
// allowed key arrives, whose exp(-1e30 - m) factor then wipes that state; a
// row that never sees one keeps m = -1e30 (or -inf, when the policy skipped
// every tile) and gets inv = 0. Keys past Nk are -inf and weigh nothing.
// Query rows past Nq are computed on zeros and not stored (no padding copy,
// unlike the TPU wrappers).
//
// Three variants compute the same function:
//   * flash_fwd_wg_kernel, for bf16 operands with Dh = 64 whose rows can be
//     copied 16 bytes at a time (the model's case). Its bound on an H100 is
//     the largest of three: 4 Dh tensor flops a computed score over 989
//     TFLOP/s, one exp a score over the special-function units (16 ex2 a
//     clock an SM, ~4.2e12 a second at 1.98 GHz), and the operand bytes
//     over 3.35 TB/s. At Dh = 64 the first two are equal (256 flops a
//     score), so the exp and mask work must shrink and run beside the
//     products. On the model's operands, whose masks leave a share of the
//     pairs to compute, the bytes (K and V read for the keys attended)
//     bound both instances, the operations 1.2x (spans) to 1.5x (key bias)
//     below them; the .cu files give the counts. The design: two
//     warpgroups of 64 query rows a block share every K / V tile, which a
//     3-stage ring brings in by cp.async into the 128-byte swizzle while
//     the block computes (the next needed tile's copies are in flight
//     during the current one); s = q k^T and o += e v run on wgmma
//     (m64n64k16, e from registers, rounded to bf16 where it enters, the
//     sum taking the unrounded values); the softmax is in log2
//     units, scale log2 e folded into one FMA before ex2.approx; a warp
//     whose rows need no mask on a tile (the policy says when) skips the
//     per-score work; a key tile no row of the block attends is not loaded
//     (under the key mask: a tile of masked keys). The schedule is the
//     policy's: the key-bias mask overlaps a tile's e v product with the
//     next tile's softmax, the span mask waits for it and lets each
//     warpgroup skip the tiles its rows do not attend. The stored m is in
//     natural units (m2 ln 2, once in the epilogue; -1e30 for a row that met
//     no allowed key), inv = 0 exactly where m <= -5e29. ptxas (sm_90a): 128
//     registers (key bias) / 122 (spans), no spills, 2 blocks an SM by
//     registers, 67 KB of shared memory a block.
//   * flash_fwd_tf32_kernel, for fp32 operands with Dh = 64 whose rows can
//     be copied 16 bytes at a time (every shipped decoder config trains in
//     fp32). One TF32 product misses the fp32 bound of 1e-4 against the
//     twin, so each product is three (flash_attention_common.cuh:
//     split_tf32): 12 Dh tensor flops a computed score over 495 TFLOP/s,
//     the bound on the model's operands (the bytes and the exp are below
//     it). TF32 wgmma takes both shared-memory operands K-major, so V is
//     staged transposed, which neither cp.async nor TMA can do: each
//     thread loads its chunks of the next key tile's K and V into
//     registers while the current tile's products run and writes their
//     TF32 halves itself (K as it stands, V^T with keys in key_pos order,
//     so the score accumulator is e V's register A operand as it stands).
//     One warpgroup a block, the serial schedule, 96 KB of split tiles,
//     two blocks an SM (ptxas: 254 registers, no spills).
//   * flash_fwd_kernel, for other head sizes (Dh <= 128) and unaligned
//     views: fp32 FMAs on the CUDA cores (67 TFLOP/s) from shared-memory
//     tiles, bound by fp32 operations and shared-memory bandwidth.
#pragma once

#include "flash_attention_common.cuh"

namespace flash {

template <typename Mask, typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const Mask mask, T* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ inv_out, Strides sq, Strides sk, Strides sv, Strides so,
                 int H, int Nq, int Nk, int Dh, float scale) {
  constexpr int QP = DP + 1;
  constexpr int DPT = DP / 16;  // output dimensions per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][QP]
  float* Ks = Qs + kBQ * QP;     // [kBK][QP]
  float* Vs = Ks + kBK * QP;     // [kBK][DP]
  float* Ps = Vs + kBK * DP;     // [kBQ][kSP]
  __shared__ typename Mask::Smem msm;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int n_qt = (Nq + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qt * kBQ;
  Mask mk = mask.at(b);  // tile() keeps per-thread state

  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;

  load_tile<T, DP>(Qs, QP, qp, sq.n, q0, Nq, Dh);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    if (!mk.tile(msm, q0, k0)) continue;  // also: the previous tile's reads are done
    load_tile<T, DP>(Ks, QP, kp, sk.n, k0, Nk, Dh);
    load_tile<T, DP>(Vs, DP, vp, sv.n, k0, Nk, Dh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = mk.score(msm, s[i][j], scale, rl, c, q0 + rl, k0 + c);
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(tmax));  // finite: every tile has a key < Nk
      const float alpha = expf(m[i] - m_new);            // 0 on the first tile (m = -inf)
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        Ps[rl * kSP + tx + 16 * j] = round_to<T>(e);
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kSP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* op = o + b * so.b + h * so.h;
  const long long stat0 = ((long long)b * H + h) * Nq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Nq) continue;
    const float inv = m[i] > 0.5f * kNegInf ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < Dh) op[(long long)row * so.n + d] = from_f<T>(acc[i][j] * inv);
    }
    if (tx == 0 && m_out != nullptr) {
      m_out[stat0 + row] = stored_max(m[i]);
      inv_out[stat0 + row] = inv;
    }
  }
}

// ---- tensor-core variant: bf16, Dh = 64, wgmma (see the header) ----

constexpr int kFwdWG = 2;                          // warpgroups a block, 64 query rows each
constexpr int kFwdThreads = kFwdWG * kMmaThreads;
constexpr int kFwdBQ = kFwdWG * kBQ;               // query rows a block
constexpr int kFwdStages = 3;                      // the K / V ring
constexpr int kFwdBlocks = 2;                      // blocks an SM (launch bounds)

// Shared memory of flash_fwd_wg_kernel: a Q tile per warpgroup, the ring of
// K and V tiles (swizzled), the block's tile words, the mask's ring stages.
template <typename Mask>
constexpr size_t fwd_wg_smem_bytes() {
  return sizeof(__nv_bfloat16) * (kFwdWG + 2 * kFwdStages) * kSwTile +
         sizeof(unsigned) * (2 + kFwdWG) + kFwdStages * sizeof(typename Mask::Stage) + kSmemSlack;
}

// The schedule is the mask policy's (Mask::kFwdOverlap): overlapped, a
// tile's e V product is issued with the next tile's s and runs under its
// softmax, and a warpgroup computes every tile the block loads; serial, the
// product is waited for at once and a warpgroup skips the tiles none of its
// rows attends. Overlapped wins on the key-bias mask, whose warpgroups
// need the same tiles (experiments/torch_flash_fwd_schedules.py times both
// there), serial on packed spans (PERF.md, row 3a).
template <typename Mask>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocks)
flash_fwd_wg_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const Mask mask,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ inv_out, Strides sq, Strides sk, Strides sv, Strides so,
                    int H, int Nq, int Nk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_base(smem_raw));  // [kFwdWG]
  __nv_bfloat16* Ks = Qs + kFwdWG * kSwTile;        // [kFwdStages]
  __nv_bfloat16* Vs = Ks + kFwdStages * kSwTile;    // [kFwdStages]
  // the key tiles of one 32-tile word: with a key to attend, mixed, and
  // attended by the rows of warpgroup w (2 + w)
  unsigned* words = reinterpret_cast<unsigned*>(Vs + kFwdStages * kSwTile);
  typename Mask::Stage* mst = reinterpret_cast<typename Mask::Stage*>(words + 2 + kFwdWG);

  const int tid = threadIdx.x;
  const int wg = tid / kMmaThreads;
  const int warp = (tid % kMmaThreads) >> 5;
  const int lane = tid & 31;
  const int c = lane & 3;
  const int n_qt = (Nq + kFwdBQ - 1) / kFwdBQ;
  const int n_kt = (Nk + kBK - 1) / kBK;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qt * kFwdBQ;
  const int w0 = q0 + wg * kBQ + warp * 16;  // the warp's first row
  const int row[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};
  const Mask mk = mask.at(b);
  const typename Mask::Rows rw = mk.rows(row[0], row[1], Nq);
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;

#pragma unroll
  for (int i = 0; i < kFwdWG; ++i)
    load_tile_sw_async(Qs + i * kSwTile, q + b * sq.b + h * sq.h, sq.n, q0 + i * kBQ, Nq, tid,
                       kFwdThreads);
  cp_async_commit();

  // this thread's copy of the current word: the tiles the block computes
  // (those of any warpgroup), its warpgroup's, the mixed ones
  unsigned need_blk = 0u, need_wg = 0u, mixed = 0u;
  int word_end = 0;
  auto load_words = [&](int t0) {  // alike in every thread of the block
    __syncthreads();               // the previous word has been read
    if (tid < 2 + kFwdWG) words[tid] = 0u;
    __syncthreads();
    unsigned mix;
    const unsigned kn = __reduce_or_sync(kFull, mk.key_need(t0, tid, kFwdThreads, mix));
    mix = __reduce_or_sync(kFull, mix);
    const unsigned rn = __reduce_or_sync(kFull, mk.row_need(rw, t0));
    if (lane == 0) {
      atomicOr(&words[0], kn);
      atomicOr(&words[1], mix);
      atomicOr(&words[2 + wg], rn);
    }
    __syncthreads();
    unsigned any_rows = 0u;
#pragma unroll
    for (int i = 0; i < kFwdWG; ++i) any_rows |= words[2 + i];
    need_blk = words[0] & any_rows;
    need_wg = words[0] & words[2 + wg];
    mixed = words[1];
    word_end = t0 + 32;
  };
  auto next_needed = [&](int t) {  // the first key tile from t on that the block computes
    while (t < n_kt) {
      if (t >= word_end) load_words(t & ~31);
      const unsigned rest = need_blk >> (t & 31);
      if (rest) return t + __ffs(rest) - 1;
      t = word_end;
    }
    return n_kt;
  };
  auto fetch = [&](int t, int st) {  // key tile t's K, V and mask stage into ring stage st
    load_tile_sw_async(Ks + st * kSwTile, kp, sk.n, t * kBK, Nk, tid, kFwdThreads);
    load_tile_sw_async(Vs + st * kSwTile, vp, sv.n, t * kBK, Nk, tid, kFwdThreads);
    mk.fetch(mst[st], t * kBK, tid);
    cp_async_commit();
  };
  struct Tile {
    int t;
    bool mine, mix;  // this warpgroup's rows attend it; its scores may need the mask
  };
  auto next_tile = [&](int from) {  // read before the word moves on
    const int t = next_needed(from);
    return Tile{t, t < n_kt && ((need_wg >> (t & 31)) & 1u), t < n_kt && ((mixed >> (t & 31)) & 1u)};
  };
  constexpr bool kOverlap = Mask::kFwdOverlap;

  const float sl2 = scale * kLog2e;
  // the warp's 16 rows: acc (16 x 64 output dims), the running max m2 in
  // log2 units, and this thread's part of the running sum l
  float acc[8][4], m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
  // e of the last computed tile as bf16 A fragments, and the V tile it
  // multiplies; overlapped, that product is issued with the next tile's
  // s, so every wgmma is issued on every path (ptxas serialises wgmma behind
  // a branch it cannot prove uniform): before the first tile pa = 0 against
  // the (finite) Q tile, which adds exactly 0
  uint32_t pa[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[t][x] = 0u;
  const __nv_bfloat16* pv = Qs;

  fetch(0, 0);  // at once, before the words: key tile 0 is the one a block needs first
  Tile cur = next_tile(0);
  if (cur.t != 0 && cur.t < n_kt) {
    cp_async_wait_all();
    fetch(cur.t, 0);
  }
  for (int st = 0; cur.t < n_kt; st = (st + 1) % kFwdStages) {
    const Tile me = cur;
    const int k0 = me.t * kBK;
    cur = next_tile(me.t + 1);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile me has landed; every warpgroup is done with stage st + 1
    if (cur.t < n_kt) fetch(cur.t, (st + 1) % kFwdStages);
    if (!kOverlap && !me.mine) continue;  // no row of this warpgroup attends a key of it
    float s[8][4];
    wgmma_fence();
    wg_rows_nt(s, Qs + wg * kSwTile, Ks + st * kSwTile);
    wgmma_commit();
    if constexpr (kOverlap) {  // the previous tile's e V, behind s
      wg_regs_nn(acc, pa, pv);
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_acc(s);

    const bool raw = mk.scores(rw, mst[st], me.mix, s, k0, w0, sl2, c);
    if (!raw && k0 + kBK > Nk) {  // the ragged tail weighs nothing
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (k0 + 8 * j + 2 * c + (x & 1) >= Nk) s[j][x] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, alpha[2], nm[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) mx[x >> 1] = fmaxf(mx[x >> 1], s[j][x]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      // finite: every computed tile has a key < Nk; 2^(-inf) = 0 on the first
      const float mn = fmaxf(m2[r], raw ? mx[r] * sl2 : mx[r]);
      alpha[r] = ex2(m2[r] - mn);
      m2[r] = mn;
      nm[r] = -mn;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        s[j][x] = ex2(raw ? fmaf(s[j][x], sl2, nm[x >> 1]) : s[j][x] + nm[x >> 1]);
        rs[x >> 1] += s[j][x];
      }
    if constexpr (kOverlap) {
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frags(pa);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[j][x] *= alpha[x >> 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    pack_a_frags(pa, s);  // e rounded to bf16 where it enters the product
    pv = Vs + st * kSwTile;
    if constexpr (!kOverlap) {
      wgmma_fence();
      wg_regs_nn(acc, pa, pv);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
  }
  cp_async_wait_all();  // a block that computed no tile still has copies in flight
  if constexpr (kOverlap) {  // the last tile's e V (with no tile: 0 against the landed Q tile)
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
    wg_regs_nn(acc, pa, pv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }

  __nv_bfloat16* op = o + b * so.b + h * so.h;
  const long long stat0 = ((long long)b * H + h) * Nq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Nq) continue;
    const bool any = m2[r] > 0.5f * kNegInf2;  // the row met an allowed key
    const float inv = any ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(op + (long long)row[r] * so.n + 8 * j + 2 * c) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    if (c == 0 && m_out != nullptr) {
      m_out[stat0 + row[r]] = any ? m2[r] * kLn2 : kNegInf;
      inv_out[stat0 + row[r]] = inv;
    }
  }
}

// ---- fp32 variant: Dh = 64, three TF32 products on wgmma (see the header) ----

constexpr int kF32Blocks = 2;   // blocks an SM (launch bounds)

// Shared memory of flash_fwd_tf32_kernel: Q, K and V^T, each as its big
// and small TF32 halves (swizzled, K-major), the tile words, two mask stages.
template <typename Mask>
constexpr size_t fwd_tf32_smem_bytes() {
  return sizeof(float) * 6 * kF32Tile + sizeof(unsigned) * 4 + 2 * sizeof(typename Mask::Stage) +
         kSmemSlack;
}

// 16-byte chunk e (row e / 16, columns 4 (e % 16)..) of rows [r0, r0 + 64)
// of a (n_rows, 64) fp32 slice; zeros past n_rows
__device__ __forceinline__ float4 ld_chunk(const float* src, long long row_stride, int r0,
                                           int n_rows, int e) {
  if (r0 + (e >> 4) >= n_rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  return __ldg(reinterpret_cast<const float4*>(src + (long long)(r0 + (e >> 4)) * row_stride +
                                               4 * (e & 15)));
}
// chunk e's big and small parts into two K-major tiles of the same rows
__device__ __forceinline__ void st_split_chunk(float* big, float* small, int e, float4 x) {
  uint4 b, s;
  split_tf32(x.x, b.x, s.x);
  split_tf32(x.y, b.y, s.y);
  split_tf32(x.z, b.z, s.z);
  split_tf32(x.w, b.w, s.w);
  const uint32_t off = sw32_offset(e >> 4, 4 * (e & 15));
  *reinterpret_cast<uint4*>(reinterpret_cast<char*>(big) + off) = b;
  *reinterpret_cast<uint4*>(reinterpret_cast<char*>(small) + off) = s;
}

// One warpgroup a block, 64 query rows; two blocks an SM. Q is split into
// TF32 halves once. For each key tile the block computes, every thread
// holds the raw K and V of 8 chunks each in registers, loaded while the
// previous tile's products ran, and writes their halves: K as it stands,
// V transposed (V^T, keys in key_pos order, so that the score accumulator
// is the A operand of e V). s = q k^T is 3 x 8 wgmma (m64n64k8) from
// shared memory, o += e V 3 x 8 with e from registers; the softmax is the
// bf16 kernel's, in log2 units. Key tiles are skipped as there (the mask
// policy's words, one warpgroup's), in the serial schedule.
template <typename Mask>
__global__ void __launch_bounds__(kMmaThreads, kF32Blocks)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const Mask mask, float* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ inv_out, Strides sq,
                      Strides sk, Strides sv, Strides so, int H, int Nq, int Nk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qb = reinterpret_cast<float*>(smem_base(smem_raw));
  float* Qs = Qb + kF32Tile;
  float* Kb = Qs + kF32Tile;
  float* Ks = Kb + kF32Tile;
  float* Vb = Ks + kF32Tile;   // V^T
  float* Vs = Vb + kF32Tile;
  unsigned* words = reinterpret_cast<unsigned*>(Vs + kF32Tile);   // need, mixed, rows
  typename Mask::Stage* mst = reinterpret_cast<typename Mask::Stage*>(words + 4);   // [2]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane & 3;
  const int n_qt = (Nq + kBQ - 1) / kBQ;
  const int n_kt = (Nk + kBK - 1) / kBK;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qt * kBQ;
  const int w0 = q0 + warp * 16;   // the warp's first row
  const int row[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};
  const Mask mk = mask.at(b);
  const typename Mask::Rows rw = mk.rows(row[0], row[1], Nq);
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;

  {
    const float* qp = q + b * sq.b + h * sq.h;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + kMmaThreads * i;
      st_split_chunk(Qb, Qs, e, ld_chunk(qp, sq.n, q0, Nq, e));
    }
  }

  unsigned need = 0u, mixed = 0u;
  int word_end = 0;
  auto load_words = [&](int t0) {   // alike in every thread
    __syncthreads();                // the previous word has been read
    if (tid < 3) words[tid] = 0u;
    __syncthreads();
    unsigned mix;
    const unsigned kn = __reduce_or_sync(kFull, mk.key_need(t0, tid, kMmaThreads, mix));
    mix = __reduce_or_sync(kFull, mix);
    const unsigned rn = __reduce_or_sync(kFull, mk.row_need(rw, t0));
    if (lane == 0) {
      atomicOr(&words[0], kn);
      atomicOr(&words[1], mix);
      atomicOr(&words[2], rn);
    }
    __syncthreads();
    need = words[0] & words[2];
    mixed = words[1];
    word_end = t0 + 32;
  };
  auto next_needed = [&](int t) {   // the first key tile from t on that the block computes
    while (t < n_kt) {
      if (t >= word_end) load_words(t & ~31);
      const unsigned rest = need >> (t & 31);
      if (rest) return t + __ffs(rest) - 1;
      t = word_end;
    }
    return n_kt;
  };

  // key tile t's raw K (chunks tid + 128 i) and V (key tid % 64, 8 columns
  // from 8 (tid / 64 + 2 i)) into registers, its mask stage by cp.async
  float4 rk[8], rv[8];
  auto fetch = [&](int t, int st) {
    const int k0 = t * kBK;
#pragma unroll
    for (int i = 0; i < 8; ++i) rk[i] = ld_chunk(kp, sk.n, k0, Nk, tid + kMmaThreads * i);
    const int key = tid & 63;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 8 * ((tid >> 6) + 2 * i);
      if (k0 + key < Nk) {
        const float4* p = reinterpret_cast<const float4*>(vp + (long long)(k0 + key) * sv.n + d);
        rv[2 * i] = __ldg(p);
        rv[2 * i + 1] = __ldg(p + 1);
      } else {
        rv[2 * i] = rv[2 * i + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    mk.fetch(mst[st], k0, tid);
    cp_async_commit();
  };
  // the registers' halves into the K and V^T tiles (a warp's 32 keys of one
  // V column fill one 128-byte row of the swizzle: no bank conflict)
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) st_split_chunk(Kb, Ks, tid + kMmaThreads * i, rk[i]);
    const int col = key_pos(tid & 63);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 8 * ((tid >> 6) + 2 * i);
      const float x[8] = {rv[2 * i].x, rv[2 * i].y, rv[2 * i].z, rv[2 * i].w,
                          rv[2 * i + 1].x, rv[2 * i + 1].y, rv[2 * i + 1].z, rv[2 * i + 1].w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t hb, hs;
        split_tf32(x[j], hb, hs);
        const uint32_t off = sw32_offset(d + j, col);
        *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(Vb) + off) = hb;
        *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(Vs) + off) = hs;
      }
    }
  };

  const float sl2 = scale * kLog2e;
  float acc[8][4], m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;

  int t = next_needed(0);
  if (t < n_kt) fetch(t, 0);
  for (int st = 0; t < n_kt; st ^= 1) {
    const int k0 = t * kBK;
    const bool mix = (mixed >> (t & 31)) & 1u;   // read before the word moves on
    const int tn = next_needed(t + 1);
    __syncthreads();   // the previous tile's products are done (each warp waited for them)
    stage();
    cp_async_wait_all();   // tile t's mask stage
    if (tn < n_kt) fetch(tn, st ^ 1);   // its loads run under this tile's products
    fence_proxy_async();
    __syncthreads();   // the tiles and the mask stage are complete

    float s[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = tf32_kstep(kk);
      wgmma_tf32_ss(s, sw_desc(Qs, off), sw_desc(Kb, off), kk > 0);
      wgmma_tf32_ss(s, sw_desc(Qb, off), sw_desc(Ks, off), 1);
      wgmma_tf32_ss(s, sw_desc(Qb, off), sw_desc(Kb, off), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    const bool raw = mk.scores(rw, mst[st], mix, s, k0, w0, sl2, c);
    if (!raw && k0 + kBK > Nk) {   // the ragged tail weighs nothing
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (k0 + 8 * j + 2 * c + (x & 1) >= Nk) s[j][x] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, alpha[2], nm[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) mx[x >> 1] = fmaxf(mx[x >> 1], s[j][x]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float mn = fmaxf(m2[r], raw ? mx[r] * sl2 : mx[r]);
      alpha[r] = ex2(m2[r] - mn);
      m2[r] = mn;
      nm[r] = -mn;
    }
    uint32_t eb[8][4], es[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        s[j][x] = ex2(raw ? fmaf(s[j][x], sl2, nm[x >> 1]) : s[j][x] + nm[x >> 1]);
        rs[x >> 1] += s[j][x];
      }
      frag_a_acc(s[j], eb[j], es[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[j][x] *= alpha[x >> 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t off = tf32_kstep(j);
      wgmma_tf32_rs(acc, es[j], sw_desc(Vb, off));
      wgmma_tf32_rs(acc, eb[j], sw_desc(Vs, off));
      wgmma_tf32_rs(acc, eb[j], sw_desc(Vb, off));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frags<8>(eb);
    fence_frags<8>(es);
    t = tn;
  }
  cp_async_wait_all();   // a block that computed no tile still has copies in flight

  float* op = o + b * so.b + h * so.h;
  const long long stat0 = ((long long)b * H + h) * Nq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Nq) continue;
    const bool any = m2[r] > 0.5f * kNegInf2;   // the row met an allowed key
    const float inv = any ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(op + (long long)row[r] * so.n + 8 * j + 2 * c) =
          make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    if (c == 0 && m_out != nullptr) {
      m_out[stat0 + row[r]] = any ? m2[r] * kLn2 : kNegInf;
      inv_out[stat0 + row[r]] = inv;
    }
  }
}

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (size_t)(kBQ * (DP + 1) + kBK * (DP + 1) + kBK * DP + kBQ * kSP);
}

template <typename Mask, typename T, int DP>
int launch_fwd(const Mask& mask, const void* q, const void* k, const void* v, void* o, float* m,
               float* inv, const long long* st, int B, int H, int Nq, int Nk, int Dh, float scale,
               int device, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<Mask, T, DP>;
  const size_t smem = fwd_smem_bytes<DP>();
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((Nq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (T*)o, m, inv, sq, sk, sv, so, H, Nq, Nk, Dh,
      scale);
  return (int)cudaGetLastError();
}

template <typename Mask, typename T>
int launch_fwd_dp(int DP, const Mask& mask, const void* q, const void* k, const void* v, void* o,
                  float* m, float* inv, const long long* st, int B, int H, int Nq, int Nk, int Dh,
                  float scale, int device, cudaStream_t stream) {
  switch (DP) {
    case 32: return launch_fwd<Mask, T, 32>(mask, q, k, v, o, m, inv, st, B, H, Nq, Nk, Dh, scale, device, stream);
    case 64: return launch_fwd<Mask, T, 64>(mask, q, k, v, o, m, inv, st, B, H, Nq, Nk, Dh, scale, device, stream);
    case 128: return launch_fwd<Mask, T, 128>(mask, q, k, v, o, m, inv, st, B, H, Nq, Nk, Dh, scale, device, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Mask>
int launch_fwd_wg(const Mask& mask, const void* q, const void* k, const void* v, void* o, float* m,
                  float* inv, const long long* st, int B, int H, int Nq, int Nk, float scale,
                  int device, cudaStream_t stream) {
  const long long blocks = (long long)B * H * ((Nq + kFwdBQ - 1) / kFwdBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wg_kernel<Mask>;
  constexpr size_t smem = fwd_wg_smem_bytes<Mask>();
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  kernel<<<(unsigned)blocks, kFwdThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, mask,
      (__nv_bfloat16*)o, m, inv, sq, sk, sv, so, H, Nq, Nk, scale);
  return (int)cudaGetLastError();
}

template <typename Mask>
int launch_fwd_tf32(const Mask& mask, const void* q, const void* k, const void* v, void* o,
                    float* m, float* inv, const long long* st, int B, int H, int Nq, int Nk,
                    float scale, int device, cudaStream_t stream) {
  const long long blocks = (long long)B * H * ((Nq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_tf32_kernel<Mask>;
  constexpr size_t smem = fwd_tf32_smem_bytes<Mask>();
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  kernel<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, mask, (float*)o, m, inv, sq, sk, sv, so,
      H, Nq, Nk, scale);
  return (int)cudaGetLastError();
}

// The kernel fwd_dispatch takes (Route), the one place the rule lives; the
// *_fwd_route exports hand it to the caller. Dh = 64 with q, k, v rows
// 16-byte aligned: bf16 on wgmma (o in 4-byte pairs), fp32 as three TF32
// products (o in 8-byte pairs); anything else on the CUDA cores.
inline int fwd_route(int dtype, const void* q, const void* k, const void* v, const void* o,
                     const long long* st, int Dh) {
  if (Dh != kMD) return kRouteCudaCores;
  if (dtype == 1 && mma_aligned(q, st) && mma_aligned(k, st + 3) && mma_aligned(v, st + 6) &&
      st[9] % 2 == 0 && st[10] % 2 == 0 && st[11] % 2 == 0 && (uintptr_t)o % 4 == 0)
    return kRouteWgmmaBf16;
  if (dtype == 0 && tf32_aligned(q, st) && tf32_aligned(k, st + 3) && tf32_aligned(v, st + 6) &&
      pair_aligned(o, st + 9))
    return kRouteTf32x3;
  return kRouteCudaCores;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). strides: 12
// element strides, (batch, head, seq) of q, k, v, o. m, inv: (B, H, Nq) fp32
// or both null. Returns the CUDA error code of the launch (0 = ok). The
// library links its own CUDA runtime, so the device is set here rather than
// inherited from the caller's runtime.
template <typename Mask>
int fwd_dispatch(const Mask& mask, int dtype, const void* q, const void* k, const void* v, void* o,
                 float* m, float* inv, const long long* strides, int B, int H, int Nq, int Nk,
                 int Dh, float scale, int device, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0) return 0;
  const int DP = dp_for(Dh);
  if (Nk <= 0 || Dh <= 0 || DP == 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (fwd_route(dtype, q, k, v, o, strides, Dh)) {
    case kRouteWgmmaBf16:
      return launch_fwd_wg<Mask>(mask, q, k, v, o, m, inv, strides, B, H, Nq, Nk, scale, device, s);
    case kRouteTf32x3:
      return launch_fwd_tf32<Mask>(mask, q, k, v, o, m, inv, strides, B, H, Nq, Nk, scale, device, s);
  }
  if (dtype == 0)
    return launch_fwd_dp<Mask, float>(DP, mask, q, k, v, o, m, inv, strides, B, H, Nq, Nk, Dh, scale, device, s);
  return launch_fwd_dp<Mask, __nv_bfloat16>(DP, mask, q, k, v, o, m, inv, strides, B, H, Nq, Nk, Dh, scale, device, s);
}

}  // namespace flash
