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
// blocks run in parallel, so the work is split in two kernels launched back
// to back on one stream:
//   1. flash_bwd_dq: one block per (b, h, 64-row q tile). Pass 1 over the key
//      tiles sums rowsum(dp * e) into c (written to a (B, H, Nq) fp32
//      scratch); pass 2 recomputes s and dp, forms ds and accumulates dq in
//      registers.
//   2. flash_bwd_dkdv: one block per (b, h, 64-key tile), looping over every
//      q tile and accumulating dk and dv in registers; no atomics.
// c is taken over the keys exactly as the TPU kernels do, not as
// rowsum(g * out) from the rounded forward output. A (q tile, key tile)
// pair that the mask policy rejects is skipped in both kernels: its e is
// exactly 0 for a row with a finite max and its ds and g * inv are 0 for a
// row with inv = 0, so it adds nothing.
//
// This design recomputes s and dp in both kernels and takes c in an extra
// pass, 18 flops per (q, k, Dh) element in all where the TPU cost estimate
// counts 10. bf16 operands with Dh = 64 and 16-byte-aligned rows take
// tensor-core variants (mma.sync, four warps of 16 rows, ~250 registers a
// thread, so two blocks per SM); fp32, other head sizes and unaligned views
// take fp32 FMAs on the CUDA cores. Taking c as rowsum(g * out) would drop
// the extra pass; it is not the TPU kernels' arithmetic, so it waits for a
// measured reason.
#pragma once

#include "flash_attention_common.cuh"

namespace flash {

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

// ---- tensor-core variants: bf16, Dh = 64 ----
//
// The same two kernels on mma.sync. Each warp owns 16 rows of its block's
// tile (query rows in the dq kernel, keys in the dk / dv kernel); the
// 16 x 64 score and dp blocks and the 16 x 64 accumulators live in
// registers in the mma C layout. The operands the TPU kernels cast (ds, e,
// g * inv) are rounded to bf16 where they are packed into A fragments or
// staged.

// e and dp of a warp's 16 query rows (local rows rl, global rows row)
// against a staged key tile, masked.
template <typename Mask>
__device__ __forceinline__ void dq_tile_scores(const Mask& mk, const typename Mask::Smem& msm,
                                               const uint32_t qf[4][4], const uint32_t gf[4][4],
                                               const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                               const int rl[2], const int row[2],
                                               const float m[2], int k0, float scale,
                                               float e[8][4], float dp[8][4]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) e[j][x] = dp[j][x] = 0.f;
  mma_rows_nt(e, qf, Ks);
  mma_rows_nt(dp, gf, Vs);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int col = 8 * j + 2 * c + (x & 1);
      e[j][x] = expf(mk.score(msm, e[j][x], scale, rl[x >> 1], col, row[x >> 1], k0 + col) -
                     m[x >> 1]);
    }
}

template <typename Mask>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const Mask mask,
                        const __nv_bfloat16* __restrict__ g, const float* __restrict__ m_in,
                        const float* __restrict__ inv_in, float* __restrict__ c_out,
                        __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                        Strides sg, Strides sdq, int H, int Nq, int Nk, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[64 * kMP];
  __shared__ __align__(16) __nv_bfloat16 Gs[64 * kMP];
  __shared__ __align__(16) __nv_bfloat16 Ks[64 * kMP];
  __shared__ __align__(16) __nv_bfloat16 Vs[64 * kMP];
  __shared__ typename Mask::Smem msm;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int n_qt = (Nq + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qt * kBQ;
  Mask mk = mask.at(b);  // tile() keeps per-thread state
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;
  const long long stat0 = ((long long)b * H + h) * Nq;

  load_tile_mma(Qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq);
  load_tile_mma(Gs, g + b * sg.b + h * sg.h, sg.n, q0, Nq);
  __syncthreads();
  uint32_t qf[4][4], gf[4][4];
  load_a_frags(qf, Qs, warp * 16);
  load_a_frags(gf, Gs, warp * 16);
  const int rl[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int row[2] = {q0 + rl[0], q0 + rl[1]};
  float m[2], inv[2], cr[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = row[r] < Nq ? m_in[stat0 + row[r]] : 0.f;
    inv[r] = row[r] < Nq ? inv_in[stat0 + row[r]] : 0.f;
  }

  float e[8][4], dp[8][4];
  // pass 1: c = rowsum(dp * e) * inv
  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    if (!mk.tile(msm, q0, k0)) continue;
    load_tile_mma(Ks, kp, sk.n, k0, Nk);
    load_tile_mma(Vs, vp, sv.n, k0, Nk);
    __syncthreads();
    dq_tile_scores(mk, msm, qf, gf, Ks, Vs, rl, row, m, k0, scale, e, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) cr[x >> 1] = fmaf(dp[j][x], e[j][x], cr[x >> 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    cr[r] += __shfl_xor_sync(kFull, cr[r], 1);
    cr[r] += __shfl_xor_sync(kFull, cr[r], 2);
    cr[r] *= inv[r];
    if (c == 0 && row[r] < Nq) c_out[stat0 + row[r]] = cr[r];
  }

  // pass 2: ds = e * ((dp - c) * inv); dq += ds k
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    if (!mk.tile(msm, q0, k0)) continue;
    load_tile_mma(Ks, kp, sk.n, k0, Nk);
    load_tile_mma(Vs, vp, sv.n, k0, Nk);
    __syncthreads();
    dq_tile_scores(mk, msm, qf, gf, Ks, Vs, rl, row, m, k0, scale, e, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) e[j][x] = e[j][x] * ((dp[j][x] - cr[x >> 1]) * inv[x >> 1]);
    mma_rows_nn(acc, e, Ks);
  }

  __nv_bfloat16* dqp = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Nq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dqp + (long long)row[r] * sdq.n + 8 * j + 2 * c) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <typename Mask>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const Mask mask,
                          const __nv_bfloat16* __restrict__ g, const float* __restrict__ m_in,
                          const float* __restrict__ inv_in, const float* __restrict__ c_in,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          Strides sq, Strides sk, Strides sv, Strides sg, Strides sdk, Strides sdv,
                          int H, int Nq, int Nk, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ts[64 * kMP];   // K, then V (fragments only)
  __shared__ __align__(16) __nv_bfloat16 Qs[64 * kMP];
  __shared__ __align__(16) __nv_bfloat16 Gs[64 * kMP];
  __shared__ __align__(16) __nv_bfloat16 Ns[64 * kMP];   // g * inv, cast to bf16
  __shared__ float Ms[kBQ], Is[kBQ], Cs[kBQ];
  __shared__ typename Mask::Smem msm;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int n_kt = (Nk + kBK - 1) / kBK;
  const int kt = blockIdx.x % n_kt;
  const int bh = blockIdx.x / n_kt;
  const int h = bh % H;
  const int b = bh / H;
  const int k0 = kt * kBK;
  Mask mk = mask.at(b);  // tile() keeps per-thread state
  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* gp = g + b * sg.b + h * sg.h;
  const long long stat0 = ((long long)b * H + h) * Nq;

  uint32_t kf[4][4], vf[4][4];
  load_tile_mma(Ts, k + b * sk.b + h * sk.h, sk.n, k0, Nk);
  __syncthreads();
  load_a_frags(kf, Ts, warp * 16);
  __syncthreads();
  load_tile_mma(Ts, v + b * sv.b + h * sv.h, sv.n, k0, Nk);
  __syncthreads();
  load_a_frags(vf, Ts, warp * 16);
  const int kl[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int key[2] = {k0 + kl[0], k0 + kl[1]};

  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dk_acc[j][x] = dv_acc[j][x] = 0.f;

  for (int q0 = 0; q0 < Nq; q0 += kBQ) {
    if (!mk.tile(msm, q0, k0)) continue;
    load_tile_mma(Qs, qp, sq.n, q0, Nq);
    load_tile_mma(Gs, gp, sg.n, q0, Nq);
    if (threadIdx.x < kBQ) {
      const int r = q0 + threadIdx.x;
      const bool ok = r < Nq;
      Ms[threadIdx.x] = ok ? m_in[stat0 + r] : 0.f;
      Is[threadIdx.x] = ok ? inv_in[stat0 + r] : 0.f;  // rows past Nq weigh nothing
      Cs[threadIdx.x] = ok ? c_in[stat0 + r] : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 64 * kMD; e += kMmaThreads) {
      const int r = e / kMD;
      const int d = e % kMD;
      Ns[r * kMP + d] = __float2bfloat16(__bfloat162float(Gs[r * kMP + d]) * Is[r]);
    }

    // s^T and dp^T: the warp's 16 keys x the tile's 64 queries
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) st[j][x] = dpt[j][x] = 0.f;
    mma_rows_nt(st, kf, Qs);
    mma_rows_nt(dpt, vf, Gs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int qc = 8 * j + 2 * c + (x & 1);
        const float ev = expf(mk.score(msm, st[j][x], scale, qc, kl[x >> 1], q0 + qc, key[x >> 1]) -
                              Ms[qc]);
        st[j][x] = ev;
        dpt[j][x] = ev * ((dpt[j][x] - Cs[qc]) * Is[qc]);
      }
    __syncthreads();  // Ns is complete
    mma_rows_nn(dv_acc, st, Ns);
    mma_rows_nn(dk_acc, dpt, Qs);
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

template <typename Mask>
int launch_bwd_mma(const Mask& mask, const void* q, const void* k, const void* v, const void* g,
                   const float* m, const float* inv, float* c, void* dq, void* dk, void* dv,
                   const long long* st, int B, int H, int Nq, int Nk, float scale, int device,
                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      sg{st[9], st[10], st[11]}, sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const long long dq_blocks = (long long)B * H * ((Nq + kBQ - 1) / kBQ);
  const long long kv_blocks = (long long)B * H * ((Nk + kBK - 1) / kBK);
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  typedef const __nv_bfloat16* P;
  flash_bwd_dq_mma_kernel<Mask><<<(unsigned)dq_blocks, kMmaThreads, 0, stream>>>(
      (P)q, (P)k, (P)v, mask, (P)g, m, inv, c, (__nv_bfloat16*)dq, sq, sk, sv, sg, sdq, H, Nq, Nk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_mma_kernel<Mask><<<(unsigned)kv_blocks, kMmaThreads, 0, stream>>>(
      (P)q, (P)k, (P)v, mask, (P)g, m, inv, c, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, sq, sk, sv,
      sg, sdk, sdv, H, Nq, Nk, scale);
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
               const long long* st, int B, int H, int Nq, int Nk, int Dh, float scale, int device,
               cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      sg{st[9], st[10], st[11]}, sdq{st[12], st[13], st[14]}, sdk{st[15], st[16], st[17]},
      sdv{st[18], st[19], st[20]};
  const long long dq_blocks = (long long)B * H * ((Nq + kBQ - 1) / kBQ);
  const long long kv_blocks = (long long)B * H * ((Nk + kBK - 1) / kBK);
  if (dq_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  auto dq_kernel = flash_bwd_dq_kernel<Mask, T, DP>;
  cudaError_t err = prepare(dq_kernel, dq_smem_bytes<DP>(), device);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<(unsigned)dq_blocks, kThreads, dq_smem_bytes<DP>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (const T*)g, m, inv, c, (T*)dq, sq, sk, sv, sg,
      sdq, H, Nq, Nk, Dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kv_kernel = flash_bwd_dkdv_kernel<Mask, T, DP>;
  err = prepare(kv_kernel, dkdv_smem_bytes<DP>(), device);
  if (err != cudaSuccess) return (int)err;
  kv_kernel<<<(unsigned)kv_blocks, kThreads, dkdv_smem_bytes<DP>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (const T*)g, m, inv, c, (T*)dk, (T*)dv, sq, sk,
      sv, sg, sdk, sdv, H, Nq, Nk, Dh, scale);
  return (int)cudaGetLastError();
}

template <typename Mask, typename T>
int launch_bwd_dp(int DP, const Mask& mask, const void* q, const void* k, const void* v,
                  const void* g, const float* m, const float* inv, float* c, void* dq, void* dk,
                  void* dv, const long long* st, int B, int H, int Nq, int Nk, int Dh, float scale,
                  int device, cudaStream_t stream) {
  switch (DP) {
    case 32: return launch_bwd<Mask, T, 32>(mask, q, k, v, g, m, inv, c, dq, dk, dv, st, B, H, Nq, Nk, Dh, scale, device, stream);
    case 64: return launch_bwd<Mask, T, 64>(mask, q, k, v, g, m, inv, c, dq, dk, dv, st, B, H, Nq, Nk, Dh, scale, device, stream);
    case 128: return launch_bwd<Mask, T, 128>(mask, q, k, v, g, m, inv, c, dq, dk, dv, st, B, H, Nq, Nk, Dh, scale, device, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dq, dk, dv share it).
// strides: 21 element strides, (batch, head, seq) of q, k, v, g, dq, dk, dv.
// m, inv: the forward's (B, H, Nq) row statistics; c: (B, H, Nq) fp32
// scratch. Launches the dq kernel then the dk / dv kernel on ``stream``;
// returns the first CUDA error code (0 = ok).
template <typename Mask>
int bwd_dispatch(const Mask& mask, int dtype, const void* q, const void* k, const void* v,
                 const void* g, const float* m, const float* inv, float* c, void* dq, void* dk,
                 void* dv, const long long* strides, int B, int H, int Nq, int Nk, int Dh,
                 float scale, int device, void* stream) {
  if (B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0) return 0;
  const int DP = dp_for(Dh);
  if (Dh <= 0 || DP == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd_dp<Mask, float>(DP, mask, q, k, v, g, m, inv, c, dq, dk, dv, strides, B, H, Nq, Nk, Dh, scale, device, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  bool mma = Dh == kMD;
  const void* in[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i) mma = mma && mma_aligned(in[i], strides + 3 * i);
  void* out[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i)
    mma = mma && (uintptr_t)out[i] % 4 == 0 && strides[12 + 3 * i] % 2 == 0 &&
          strides[13 + 3 * i] % 2 == 0 && strides[14 + 3 * i] % 2 == 0;
  if (mma)
    return launch_bwd_mma<Mask>(mask, q, k, v, g, m, inv, c, dq, dk, dv, strides, B, H, Nq, Nk, scale, device, s);
  return launch_bwd_dp<Mask, __nv_bfloat16>(DP, mask, q, k, v, g, m, inv, c, dq, dk, dv, strides, B, H, Nq, Nk, Dh, scale, device, s);
}

}  // namespace flash
