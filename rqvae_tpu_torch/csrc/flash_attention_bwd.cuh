// Fused masked attention, backward, templated on a mask policy
// (flash_attention_common.cuh): dq, dk, dv of out = softmax(masked(q k^T /
// sqrt(Dh))) v for an upstream gradient g. flash_attention_bwd.cu binds it
// to the key-bias mask, flash_attention_spans_bwd.cu to the span mask.
//
// The TPU kernels' arithmetic. With the forward's row max m and
// inv = 1 / sum(e) (0 for a row with no allowed key), e = exp(s - m)
// unnormalised and dp = g v^T:
//   c  = rowsum(dp * e) * inv                 (exactly, over every key)
//   ds = e * ((dp - c) * inv)                 cast to the operand type
//   dq = ds k * scale,  dk = ds^T q * scale,  dv = e^T (g * inv)
// with e and g * inv cast to the operand type before the dv product, fp32
// accumulation everywhere, and dq, dk, dv written in the operand type.
//
// What differs from the TPU kernels, and why: they walk q-blocks as a
// sequential grid axis and accumulate dk / dv in place across it. CUDA
// blocks run in parallel, in no order.
//
// The tensor-core path (bf16, Dh = 64, 16-byte-aligned rows; the model's
// case) does 14 flops per (q, k, Dh) element where the TPU cost estimate
// counts 10 (the parent design did 18, on mma.sync with synchronous loads).
// Every product is a warpgroup wgmma (m64n64k16, fp32 accumulate) reading
// 64 x 64 bf16 tiles in the 128-byte swizzle that cp.async double-buffers
// (flash_attention_common.cuh), so a tile is read from shared memory once
// per product, not once per warp as ldmatrix fragments were:
//   flash_bwd_c_mma_kernel  c, exactly (4 flops): one warpgroup per (b, h,
//                           64-row q tile) walking the key tiles, s = q k^T
//                           and dp = g v^T; it also zeroes the tile's rows
//                           of a (B, H, Nq, 64) fp32 dq accumulator.
//   flash_bwd_mma_kernel    one pass over the (key tile, q tile) pairs (10
//                           flops): one warpgroup per (b, h, 64-key tile)
//                           walking the q tiles. s^T = k q^T and dp^T = v g^T
//                           once; e and ds in registers (warp w: keys
//                           16 w .. 16 w + 15); dv += e^T (g inv) and
//                           dk += ds^T q with e and ds as register A
//                           operands; ds^T staged in shared memory for
//                           dq = ds k, added to the accumulator with 8-byte
//                           fp32 atomics. The next q tile's Q, G and row
//                           statistics load while the current one computes.
//                           Blocks of one (b, h) start their walk at
//                           different q tiles, so their atomics spread.
//   flash_bwd_dq_cast_kernel  dq = accumulator * scale, cast to bf16.
// Three blocks an SM (168 registers a thread). The atomics make dq's fp32
// sum order over the key tiles vary from run to run (dk and dv are summed in
// one block, in order). A dq kernel that recomputes s and dp instead
// (deterministic, 18 flops) was slower in the same call (PERF.md, row 3b).
//
// c stays exact. rowsum(g * out) from the forward's output is the same
// number in exact arithmetic and would save the c kernel, but out is rounded
// to bf16, and at the trained model's magnitudes (|v| ~ 10) that moves dq
// and dk past the 2e-2 bound the kernels are held to against their twins
// (tests/test_torch_flash_bwd_c.py; chip_smoke.py's causal case on the
// ML-32M step's operands failed by 0.125). In the one-pass kernel no block
// sees a whole row, so c takes a sweep of its own.
//
// fp32, other head sizes (<= 128) and unaligned views take fp32 FMAs on the
// CUDA cores: a dq kernel (one block per 64-row q tile; pass 1 over the key
// tiles sums c into a (B, H, Nq) fp32 scratch, pass 2 recomputes s and dp
// and accumulates dq) and a dk / dv kernel (one block per 64-key tile,
// walking the q tiles), no atomics, 18 flops per element.
//
// A (q tile, key tile) pair that the mask policy rejects is skipped: its e is
// exactly 0 for a row with a finite max and its ds and g * inv are 0 for a
// row with inv = 0, so it adds nothing.
#pragma once

#include "flash_attention_common.cuh"

namespace flash {

// ---- CUDA-core variants: fp32, or bf16 at other head sizes ----

// Scores s and dp = g v^T of a thread's 4 x 4 (row, key) cells.
template <int DP>
__device__ __forceinline__ void scores_and_dp(const float* Qs, const float* Gs, const float* Ks,
                                              const float* Vs, int ty, int tx, float s[4][4],
                                              float dp[4][4]) {
  constexpr int QP = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * QP + d];
      gv[i] = Gs[(ty + 16 * i) * QP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * QP + d];
      vv[j] = Vs[(tx + 16 * j) * QP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

template <typename Mask, typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const Mask mask, const T* __restrict__ g, const float* __restrict__ m_in,
                    const float* __restrict__ inv_in, float* __restrict__ c_out,
                    T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sg,
                    Strides sdq, int H, int Nq, int Nk, int Dh, float scale) {
  constexpr int QP = DP + 1;
  constexpr int DPT = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][QP]
  float* Gs = Qs + kBQ * QP;     // [kBQ][QP]
  float* Ks = Gs + kBQ * QP;     // [kBK][QP]
  float* Vs = Ks + kBK * QP;     // [kBK][QP]
  float* Ds = Vs + kBK * QP;     // [kBQ][kSP]  ds
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

  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  const long long stat0 = ((long long)b * H + h) * Nq;

  load_tile<T, DP>(Qs, QP, q + b * sq.b + h * sq.h, sq.n, q0, Nq, Dh);
  load_tile<T, DP>(Gs, QP, g + b * sg.b + h * sg.h, sg.n, q0, Nq, Dh);
  float m[4], inv[4], c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    m[i] = row < Nq ? m_in[stat0 + row] : 0.f;
    inv[i] = row < Nq ? inv_in[stat0 + row] : 0.f;
    c[i] = 0.f;
  }

  // pass 1: c = rowsum(dp * e) * inv
  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    if (!mk.tile(msm, q0, k0)) continue;
    load_tile<T, DP>(Ks, QP, kp, sk.n, k0, Nk, Dh);
    load_tile<T, DP>(Vs, QP, vp, sv.n, k0, Nk, Dh);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores_and_dp<DP>(Qs, Gs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = ty + 16 * i;
        const int col = tx + 16 * j;
        const float e = expf(mk.score(msm, s[i][j], scale, rl, col, q0 + rl, k0 + col) - m[i]);
        c[i] = fmaf(dp[i][j], e, c[i]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] = row_sum16(c[i]) * inv[i];
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < Nq) c_out[stat0 + row] = c[i];
  }

  // pass 2: ds = e * ((dp - c) * inv); dq += ds k
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    if (!mk.tile(msm, q0, k0)) continue;
    load_tile<T, DP>(Ks, QP, kp, sk.n, k0, Nk, Dh);
    load_tile<T, DP>(Vs, QP, vp, sv.n, k0, Nk, Dh);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores_and_dp<DP>(Qs, Gs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = ty + 16 * i;
        const int col = tx + 16 * j;
        const float e = expf(mk.score(msm, s[i][j], scale, rl, col, q0 + rl, k0 + col) - m[i]);
        Ds[rl * kSP + col] = round_to<T>(e * ((dp[i][j] - c[i]) * inv[i]));
      }
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < kBK; ++cc) {
      float dv_[4], kv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv_[i] = Ds[(ty + 16 * i) * kSP + cc];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = Ks[cc * QP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(dv_[i], kv[j], acc[i][j]);
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

template <typename Mask, typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const Mask mask, const T* __restrict__ g, const float* __restrict__ m_in,
                      const float* __restrict__ inv_in, const float* __restrict__ c_in,
                      T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                      Strides sg, Strides sdk, Strides sdv, int H, int Nq, int Nk, int Dh,
                      float scale) {
  constexpr int QP = DP + 1;
  constexpr int DPT = DP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [kBK][QP]
  float* Vs = Ks + kBK * QP;     // [kBK][QP]
  float* Qs = Vs + kBK * QP;     // [kBQ][QP]
  float* Gs = Qs + kBQ * QP;     // [kBQ][QP]  g, then g * inv cast to T
  float* Es = Gs + kBQ * QP;     // [kBQ][kSP] e cast to T
  float* Ds = Es + kBQ * kSP;    // [kBQ][kSP] ds
  float* Ms = Ds + kBQ * kSP;    // [kBQ] m, inv, c of the q tile's rows
  float* Is = Ms + kBQ;
  float* Cs = Is + kBQ;
  __shared__ typename Mask::Smem msm;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int n_kt = (Nk + kBK - 1) / kBK;
  const int kt = blockIdx.x % n_kt;
  const int bh = blockIdx.x / n_kt;
  const int h = bh % H;
  const int b = bh / H;
  const int k0 = kt * kBK;
  Mask mk = mask.at(b);  // tile() keeps per-thread state

  const T* qp = q + b * sq.b + h * sq.h;
  const T* gp = g + b * sg.b + h * sg.h;
  const long long stat0 = ((long long)b * H + h) * Nq;

  load_tile<T, DP>(Ks, QP, k + b * sk.b + h * sk.h, sk.n, k0, Nk, Dh);
  load_tile<T, DP>(Vs, QP, v + b * sv.b + h * sv.h, sv.n, k0, Nk, Dh);

  float dk_acc[4][DPT], dv_acc[4][DPT];  // keys ty + 16 i, dimensions tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Nq; q0 += kBQ) {
    if (!mk.tile(msm, q0, k0)) continue;  // also: the previous q tile's reads are done
    load_tile<T, DP>(Qs, QP, qp, sq.n, q0, Nq, Dh);
    load_tile<T, DP>(Gs, QP, gp, sg.n, q0, Nq, Dh);
    if (threadIdx.x < kBQ) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < Nq;
      Ms[threadIdx.x] = ok ? m_in[stat0 + row] : 0.f;
      Is[threadIdx.x] = ok ? inv_in[stat0 + row] : 0.f;  // rows past Nq weigh nothing
      Cs[threadIdx.x] = ok ? c_in[stat0 + row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // rows ty + 16 i, keys tx + 16 j
    scores_and_dp<DP>(Qs, Gs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float mi = Ms[r], ii = Is[r], ci = Cs[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float e = expf(mk.score(msm, s[i][j], scale, r, col, q0 + r, k0 + col) - mi);
        Es[r * kSP + col] = round_to<T>(e);
        Ds[r * kSP + col] = round_to<T>(e * ((dp[i][j] - ci) * ii));
      }
    }
    __syncthreads();  // every thread's dp is computed: g may be overwritten
    for (int e = threadIdx.x; e < kBQ * DP; e += kThreads) {
      const int r = e / DP;
      const int d = e - r * DP;
      Gs[r * QP + d] = round_to<T>(Gs[r * QP + d] * Is[r]);
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

// ---- tensor-core variant: bf16, Dh = 64, wgmma ----

// Shared memory of flash_bwd_c_mma_kernel: Q, G, two buffers of K and V
// (swizzled tiles), two of the mask policy's per-pair state.
template <typename Mask>
constexpr size_t c_smem_bytes() {
  return sizeof(__nv_bfloat16) * 6 * kSwTile + 2 * sizeof(typename Mask::Smem) + kSmemSlack;
}

// c = rowsum(dp * e) * inv of a 64-row q tile over every key tile the mask
// needs, and the tile's rows of the dq accumulator zeroed (see the header).
template <typename Mask>
__global__ void __launch_bounds__(kMmaThreads, 3)
flash_bwd_c_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const Mask mask,
                       const __nv_bfloat16* __restrict__ g, const float* __restrict__ m_in,
                       const float* __restrict__ inv_in, float* __restrict__ c_out,
                       float* __restrict__ dq_acc, Strides sq, Strides sk, Strides sv, Strides sg,
                       int H, int Nq, int Nk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_base(smem_raw));
  __nv_bfloat16* Gs = Qs + kSwTile;
  __nv_bfloat16* Ks = Gs + kSwTile;       // [2]
  __nv_bfloat16* Vs = Ks + 2 * kSwTile;   // [2]
  typename Mask::Smem* msm = reinterpret_cast<typename Mask::Smem*>(Vs + 2 * kSwTile);  // [2]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int n_qt = (Nq + kBQ - 1) / kBQ;
  const int n_kt = (Nk + kBK - 1) / kBK;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qt * kBQ;
  const Mask mk = mask.at(b);
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;
  const long long stat0 = ((long long)b * H + h) * Nq;

  auto next_needed = [&](int t) {  // the first key tile from t on that the mask needs
    for (; t < n_kt; ++t)
      if (mk.need(q0, t * kBK)) break;
    return t;
  };
  auto fetch = [&](int t, int buf) {  // key tile t's K and V into buf
    load_tile_sw_async(Ks + buf * kSwTile, kp, sk.n, t * kBK, Nk);
    load_tile_sw_async(Vs + buf * kSwTile, vp, sv.n, t * kBK, Nk);
    cp_async_commit();
  };

  load_tile_sw_async(Qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq);
  load_tile_sw_async(Gs, g + b * sg.b + h * sg.h, sg.n, q0, Nq);
  cp_async_commit();
  int t = next_needed(0);
  if (t < n_kt) fetch(t, 0);
  for (int e = threadIdx.x; e < kBQ * kMD / 4; e += kMmaThreads) {
    const int row = q0 + e / (kMD / 4);
    if (row < Nq)
      *reinterpret_cast<float4*>(dq_acc + (stat0 + row) * kMD + 4 * (e % (kMD / 4))) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int rl[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int row[2] = {q0 + rl[0], q0 + rl[1]};
  float m[2], cr[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = row[r] < Nq ? m_in[stat0 + row[r]] : 0.f;

  for (int buf = 0; t < n_kt; buf ^= 1) {
    const int k0 = t * kBK;
    mk.stage(msm[buf], q0, k0);     // msm[buf] was last read two tiles ago
    const int tn = next_needed(t + 1);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();                // tile t has landed; the previous tile is done
    if (tn < n_kt) fetch(tn, buf ^ 1);
    float s[8][4], dp[8][4];
    wgmma_fence();
    wg_rows_nt(s, Qs, Ks + buf * kSwTile);
    wg_rows_nt(dp, Gs, Vs + buf * kSwTile);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = 8 * j + 2 * c + (x & 1);
        const int r = x >> 1;
        const float e =
            __expf(mk.score(msm[buf], s[j][x], scale, rl[r], col, row[r], k0 + col) - m[r]);
        cr[r] = fmaf(dp[j][x], e, cr[r]);
      }
    t = tn;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cr[r] += __shfl_xor_sync(kFull, cr[r], 1);
    cr[r] += __shfl_xor_sync(kFull, cr[r], 2);
    if (c == 0 && row[r] < Nq) c_out[stat0 + row[r]] = cr[r] * inv_in[stat0 + row[r]];
  }
}

// Shared memory of flash_bwd_mma_kernel: K, V, g * inv, ds^T, two buffers
// of Q and G (swizzled tiles), two of the q tile's m / inv / c, two of the
// mask policy's per-pair state.
template <typename Mask>
constexpr size_t mma_bwd_smem_bytes() {
  return sizeof(__nv_bfloat16) * 8 * kSwTile + sizeof(float) * 2 * 3 * kBQ +
         2 * sizeof(typename Mask::Smem) + kSmemSlack;
}

// Blocks an SM holds of the one-pass kernel: three (168 registers a thread)
// beat two in the same call (PERF.md, row 3b).
constexpr int kBwdBlocks = 3;

// The one pass over (key tile, q tile) pairs (see the header).
template <typename Mask>
__global__ void __launch_bounds__(kMmaThreads, kBwdBlocks)
flash_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const Mask mask,
                     const __nv_bfloat16* __restrict__ g, const float* __restrict__ m_in,
                     const float* __restrict__ inv_in, const float* __restrict__ c_in,
                     float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                     Strides sg, Strides sdk, Strides sdv, int H, int Nq, int Nk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_base(smem_raw));
  __nv_bfloat16* Vs = Ks + kSwTile;
  __nv_bfloat16* Ns = Vs + kSwTile;       // g * inv of the current q tile
  __nv_bfloat16* Ds = Ns + kSwTile;       // ds^T: [key][q]
  __nv_bfloat16* Qs = Ds + kSwTile;       // [2]
  __nv_bfloat16* Gs = Qs + 2 * kSwTile;   // [2]
  float* Ss = reinterpret_cast<float*>(Gs + 2 * kSwTile);  // [2][m, inv, c][kBQ]
  typename Mask::Smem* msm = reinterpret_cast<typename Mask::Smem*>(Ss + 2 * 3 * kBQ);  // [2]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int n_kt = (Nk + kBK - 1) / kBK;
  const int n_qt = (Nq + kBQ - 1) / kBQ;
  const int kt = blockIdx.x % n_kt;
  const int bh = blockIdx.x / n_kt;
  const int h = bh % H;
  const int b = bh / H;
  const int k0 = kt * kBK;
  const Mask mk = mask.at(b);
  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* gp = g + b * sg.b + h * sg.h;
  const long long stat0 = ((long long)b * H + h) * Nq;

  // the q tiles in walking order: this key tile's own index first
  auto qtile = [&](int t) { return (t + kt) % n_qt; };
  auto next_needed = [&](int t) {  // the first walked q tile from t on that the mask needs
    for (; t < n_qt; ++t)
      if (mk.need(qtile(t) * kBQ, k0)) break;
    return t;
  };
  auto fetch = [&](int t, int buf) {  // Q, G and the statistics of walked tile t into buf
    const int q0 = qtile(t) * kBQ;
    load_tile_sw_async(Qs + buf * kSwTile, qp, sq.n, q0, Nq);
    load_tile_sw_async(Gs + buf * kSwTile, gp, sg.n, q0, Nq);
    for (int i = threadIdx.x; i < 3 * kBQ; i += kMmaThreads) {
      const int which = i / kBQ;
      const int row = q0 + i % kBQ;
      const float* src = which == 0 ? m_in : (which == 1 ? inv_in : c_in);
      const bool ok = row < Nq;  // rows past Nq: m = inv = c = 0, they weigh nothing
      cp_async4(Ss + buf * 3 * kBQ + i, ok ? src + stat0 + row : src, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  load_tile_sw_async(Ks, k + b * sk.b + h * sk.h, sk.n, k0, Nk);
  load_tile_sw_async(Vs, v + b * sv.b + h * sv.h, sv.n, k0, Nk);
  cp_async_commit();
  int t = next_needed(0);
  if (t < n_qt) fetch(t, 0);

  const int kl[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int key[2] = {k0 + kl[0], k0 + kl[1]};
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dk_acc[j][x] = dv_acc[j][x] = 0.f;

  for (int buf = 0; t < n_qt; buf ^= 1) {
    const int q0 = qtile(t) * kBQ;
    mk.stage(msm[buf], q0, k0);     // msm[buf] was last read two tiles ago
    const int tn = next_needed(t + 1);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();                // tile t has landed; the previous tile is done
    if (tn < n_qt) fetch(tn, buf ^ 1);
    const __nv_bfloat16* Qb = Qs + buf * kSwTile;
    const __nv_bfloat16* Gb = Gs + buf * kSwTile;
    const float* Mb = Ss + buf * 3 * kBQ;
    const float* Ib = Mb + kBQ;
    const float* Cb = Ib + kBQ;

    // s^T and dp^T: the block's 64 keys x the tile's 64 queries
    float st[8][4], dpt[8][4];
    wgmma_fence();
    wg_rows_nt(st, Ks, Qb);
    wg_rows_nt(dpt, Vs, Gb);
    wgmma_commit();

    // meanwhile g * inv, cast to bf16, for dv (a row's 16-byte chunks stay
    // in place under the swizzle: the scale is the row's)
    for (int e = threadIdx.x; e < 64 * 8; e += kMmaThreads) {
      const int r = e >> 3;
      const float ir = Ib[r];
      uint4 w = *reinterpret_cast<const uint4*>(Gb + 8 * e);
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&u[p]);
        u[p] = pack_bf16(__low2float(x) * ir, __high2float(x) * ir);
      }
      *reinterpret_cast<uint4*>(Ns + 8 * e) = w;
    }
    wgmma_wait_all();
    fence_acc(st);
    fence_acc(dpt);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = 8 * j + 2 * c;
      const float2 mq = *reinterpret_cast<const float2*>(Mb + qc);
      const float2 iq = *reinterpret_cast<const float2*>(Ib + qc);
      const float2 cq = *reinterpret_cast<const float2*>(Cb + qc);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int o = x & 1;
        const float ev = __expf(mk.score(msm[buf], st[j][x], scale, qc + o, kl[x >> 1], q0 + qc + o,
                                         key[x >> 1]) - (o ? mq.y : mq.x));
        st[j][x] = ev;
        dpt[j][x] = ev * ((dpt[j][x] - (o ? cq.y : cq.x)) * (o ? iq.y : iq.x));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)  // ds^T for dq: rows kl, columns qc, qc + 1
        *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(Ds) + sw_offset(kl[r], qc)) =
            pack_bf16(dpt[j][2 * r], dpt[j][2 * r + 1]);
    }
    uint32_t ea[4][4], da[4][4];
    pack_a_frags(ea, st);
    pack_a_frags(da, dpt);
    fence_proxy_async();
    __syncthreads();  // g * inv and ds^T are complete
    wgmma_fence();
    wg_regs_nn(dv_acc, ea, Ns);
    wg_regs_nn(dk_acc, da, Qb);
    wgmma_commit();
    wgmma_wait_all();  // before dq: the packed e and ds and dq's accumulator do not overlap
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    // dq of the warp's 16 q rows over this key tile, added to the
    // accumulator (8-byte atomics: two adjacent dimensions a lane)
    float dq[8][4];
    wgmma_fence();
    wg_tn(dq, Ds, Ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(dq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row >= Nq) continue;
      float* dst = dq_acc + (stat0 + row) * kMD + 2 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                  make_float2(dq[j][2 * r], dq[j][2 * r + 1]));
    }
    t = tn;
  }

  __nv_bfloat16* dkp = dk + b * sdk.b + h * sdk.h;
  __nv_bfloat16* dvp = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Nk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkp + (long long)key[r] * sdk.n + 8 * j + 2 * c) =
          pack_bf16(dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvp + (long long)key[r] * sdv.n + 8 * j + 2 * c) =
          pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// dq = acc * scale in bf16, two dimensions a thread.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_cast_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq, Strides sdq,
                         int H, int Nq, float scale, long long pairs) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= pairs) return;
  const long long r = p / (kMD / 2);
  const int d = 2 * (int)(p % (kMD / 2));
  const int i = (int)(r % Nq);
  const long long bh = r / Nq;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  const float2 a = *reinterpret_cast<const float2*>(acc + r * kMD + d);
  *reinterpret_cast<uint32_t*>(dq + b * sdq.b + h * sdq.h + (long long)i * sdq.n + d) =
      pack_bf16(a.x * scale, a.y * scale);
}


// strides: 21 element strides, (batch, head, seq) of q, k, v, g, dq, dk, dv
struct BwdStrides {
  Strides q, k, v, g, dq, dk, dv;
  explicit BwdStrides(const long long* st)
      : q{st[0], st[1], st[2]}, k{st[3], st[4], st[5]}, v{st[6], st[7], st[8]},
        g{st[9], st[10], st[11]}, dq{st[12], st[13], st[14]}, dk{st[15], st[16], st[17]},
        dv{st[18], st[19], st[20]} {}
};

template <typename Mask>
int launch_bwd_mma(const Mask& mask, const void* q, const void* k, const void* v, const void* g,
                   const float* m, const float* inv, float* c, float* dq_acc, void* dq, void* dk,
                   void* dv, const BwdStrides& s, int B, int H, int Nq, int Nk, float scale,
                   int device, cudaStream_t stream) {
  const long long c_blocks = (long long)B * H * ((Nq + kBQ - 1) / kBQ);
  const long long kv_blocks = (long long)B * H * ((Nk + kBK - 1) / kBK);
  const long long pairs = (long long)B * H * Nq * (kMD / 2);
  if (c_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      (pairs + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  typedef const __nv_bfloat16* P;
  auto c_kernel = flash_bwd_c_mma_kernel<Mask>;
  cudaError_t e = prepare(c_kernel, c_smem_bytes<Mask>(), device);
  if (e != cudaSuccess) return (int)e;
  c_kernel<<<(unsigned)c_blocks, kMmaThreads, c_smem_bytes<Mask>(), stream>>>(
      (P)q, (P)k, (P)v, mask, (P)g, m, inv, c, dq_acc, s.q, s.k, s.v, s.g, H, Nq, Nk, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = flash_bwd_mma_kernel<Mask>;
  e = prepare(kernel, mma_bwd_smem_bytes<Mask>(), device);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)kv_blocks, kMmaThreads, mma_bwd_smem_bytes<Mask>(), stream>>>(
      (P)q, (P)k, (P)v, mask, (P)g, m, inv, c, dq_acc, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, s.q,
      s.k, s.v, s.g, s.dk, s.dv, H, Nq, Nk, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_cast_kernel<<<(unsigned)((pairs + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      dq_acc, (__nv_bfloat16*)dq, s.dq, H, Nq, scale, pairs);
  return (int)cudaGetLastError();
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kBQ * (DP + 1) + kBQ * kSP);
}
template <int DP>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * kBQ * (DP + 1) + 2 * kBQ * kSP + 3 * kBQ);
}

template <typename Mask, typename T, int DP>
int launch_bwd(const Mask& mask, const void* q, const void* k, const void* v, const void* g,
               const float* m, const float* inv, float* c, void* dq, void* dk, void* dv,
               const BwdStrides& s, int B, int H, int Nq, int Nk, int Dh, float scale, int device,
               cudaStream_t stream) {
  const long long dq_blocks = (long long)B * H * ((Nq + kBQ - 1) / kBQ);
  const long long kv_blocks = (long long)B * H * ((Nk + kBK - 1) / kBK);
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  auto dq_kernel = flash_bwd_dq_kernel<Mask, T, DP>;
  cudaError_t err = prepare(dq_kernel, dq_smem_bytes<DP>(), device);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<(unsigned)dq_blocks, kThreads, dq_smem_bytes<DP>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (const T*)g, m, inv, c, (T*)dq, s.q, s.k, s.v,
      s.g, s.dq, H, Nq, Nk, Dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kv_kernel = flash_bwd_dkdv_kernel<Mask, T, DP>;
  err = prepare(kv_kernel, dkdv_smem_bytes<DP>(), device);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<(unsigned)kv_blocks, kThreads, dkdv_smem_bytes<DP>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (const T*)g, m, inv, c, (T*)dk, (T*)dv, s.q,
      s.k, s.v, s.g, s.dk, s.dv, H, Nq, Nk, Dh, scale);
  return (int)cudaGetLastError();
}

template <typename Mask, typename T>
int launch_bwd_dp(int DP, const Mask& mask, const void* q, const void* k, const void* v,
                  const void* g, const float* m, const float* inv, float* c, void* dq, void* dk,
                  void* dv, const BwdStrides& st, int B, int H, int Nq, int Nk, int Dh, float scale,
                  int device, cudaStream_t stream) {
  switch (DP) {
    case 32: return launch_bwd<Mask, T, 32>(mask, q, k, v, g, m, inv, c, dq, dk, dv, st, B, H, Nq, Nk, Dh, scale, device, stream);
    case 64: return launch_bwd<Mask, T, 64>(mask, q, k, v, g, m, inv, c, dq, dk, dv, st, B, H, Nq, Nk, Dh, scale, device, stream);
    case 128: return launch_bwd<Mask, T, 128>(mask, q, k, v, g, m, inv, c, dq, dk, dv, st, B, H, Nq, Nk, Dh, scale, device, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Whether bwd_dispatch takes the tensor-core path: bf16, Dh = 64, the rows
// of q, k, v, g 16-byte aligned (strides: their 12 element strides). The one
// place this rule lives: the *_bwd_mma_path exports hand it to the caller,
// which allocates the path's dq accumulator exactly when it holds.
inline bool bwd_mma_path(int dtype, const void* q, const void* k, const void* v, const void* g,
                         const long long* strides, int Dh) {
  if (dtype != 1 || Dh != kMD) return false;
  const void* in[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i)
    if (!mma_aligned(in[i], strides + 3 * i)) return false;
  return true;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dq, dk, dv share it).
// strides: 21 element strides, (batch, head, seq) of q, k, v, g, dq, dk, dv.
// m, inv: the forward's (B, H, Nq) row statistics; c: (B, H, Nq) fp32
// scratch; dq_acc: a (B, H, Nq, 64) fp32 scratch, given exactly when
// bwd_mma_path holds. That path writes dq, dk, dv in bf16 pairs, so their
// rows must be 4-byte aligned; it returns an error without dq_acc or with
// unaligned outputs. Launches the path's kernels on ``stream``; returns the
// first CUDA error code (0 = ok).
template <typename Mask>
int bwd_dispatch(const Mask& mask, int dtype, const void* q, const void* k, const void* v,
                 const void* g, const float* m, const float* inv, float* c, float* dq_acc,
                 void* dq, void* dk, void* dv, const long long* strides, int B, int H, int Nq,
                 int Nk, int Dh, float scale, int device, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return 0;
  const int DP = dp_for(Dh);
  if (Dh <= 0 || DP == 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const BwdStrides s(strides);
  if (bwd_mma_path(dtype, q, k, v, g, strides, Dh)) {
    const void* out[3] = {dq, dk, dv};
    for (int i = 0; i < 3; ++i)
      if ((uintptr_t)out[i] % 4 != 0 || strides[12 + 3 * i] % 2 != 0 ||
          strides[13 + 3 * i] % 2 != 0 || strides[14 + 3 * i] % 2 != 0)
        return (int)cudaErrorInvalidValue;
    if (dq_acc == nullptr) return (int)cudaErrorInvalidValue;
    return launch_bwd_mma<Mask>(mask, q, k, v, g, m, inv, c, dq_acc, dq, dk, dv, s, B, H, Nq, Nk, scale, device, st);
  }
  if (dtype == 0)
    return launch_bwd_dp<Mask, float>(DP, mask, q, k, v, g, m, inv, c, dq, dk, dv, s, B, H, Nq, Nk, Dh, scale, device, st);
  return launch_bwd_dp<Mask, __nv_bfloat16>(DP, mask, q, k, v, g, m, inv, c, dq, dk, dv, s, B, H, Nq, Nk, Dh, scale, device, st);
}

}  // namespace flash
