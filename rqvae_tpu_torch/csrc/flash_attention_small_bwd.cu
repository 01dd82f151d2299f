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
// 989 TFLOP/s: bytes. So, as the forward, a CTA stages its pairs' q, k, v
// and g once (16-byte cp.async) and does everything from shared memory.
//
// Two variants compute the same function:
//   * small_bwd_mma_kernel<SKT, QPW>: bf16, Dh = 64, 16-byte-aligned rows
//     (the model's case), mma.sync m16n8k16 with fp32 accumulate. Keys are
//     taken in strips of SKT tiles of 16. Per strip: each warp owns 16
//     query rows (QPW such tiles at most), computes s and dp for the strip
//     in registers, forms ds, accumulates dq (ds k) in registers and stages
//     bf16(e) and bf16(ds) in shared memory; after a barrier each warp owns
//     16 keys of the strip and takes dk = ds^T q and dv = e^T (g inv) over
//     every query row of the pair, then writes them: each key's dk and dv
//     are final within its strip, so nothing is accumulated across CTAs or
//     strips. When one strip holds every key (Nk <= 96, Nq <= 128: every
//     Amazon shape) c is taken in the same pass from the whole row, so the
//     kernel recomputes nothing. Wider shapes (the 241-token ML-32M bucket,
//     255 x 255) do not fit one strip in 227 KB of shared memory (q, g,
//     g * inv and the e / ds tiles of 256 rows): they walk strips of 32 keys
//     and take c in a first pass over the strips, which recomputes s and dp
//     once.
//   * small_bwd_kernel<T, DP>: fp32 operands, other head sizes (Dh <= 128)
//     and unaligned views, fp32 FMAs on the CUDA cores, one CTA a pair: per
//     64-row query tile a pass for c and a pass for ds and dq over the key
//     tiles, then per 64-key tile dk and dv over the query tiles (the fp32
//     operands of a pair at Dh = 128 exceed shared memory, so they are
//     staged a tile at a time and s, dp recomputed three times).
#include "flash_attention_bwd.cuh"
#include "flash_attention_small.cuh"

namespace flash {
namespace small {

constexpr int kSingleStripKT = 6;   // one strip when KT <= 6 and n_qt <= 8
constexpr int kMultiStripKT = 2;    // else strips of 2 key tiles (32 keys)

// e (masked, exponentiated against the stored row max) and dp = g v^T of a
// warp's 16 query rows (tile qt) against key strip st staged in Ks / Vs.
template <int SKT>
__device__ __forceinline__ void strip_scores(const __nv_bfloat16* Qs, const __nv_bfloat16* Gs,
                                             const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                             const float* ms, const float* bs, int qt, int st,
                                             int KT, int Nk, int causal, float scale,
                                             float e[2 * SKT][4], float dp[2 * SKT][4]) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, c = lane & 3;
  uint32_t qf[4][4], gf[4][4];
  load_a_frags(qf, Qs, 16 * qt);
  load_a_frags(gf, Gs, 16 * qt);
#pragma unroll
  for (int j = 0; j < 2 * SKT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) e[j][x] = dp[j][x] = 0.f;
#pragma unroll
  for (int jj = 0; jj < SKT; ++jj)
    if (st * SKT + jj < KT) {
      mma_nt16(e[2 * jj], e[2 * jj + 1], qf, Ks, 16 * jj);
      mma_nt16(dp[2 * jj], dp[2 * jj + 1], gf, Vs, 16 * jj);
    }
#pragma unroll
  for (int j = 0; j < 2 * SKT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = 16 * qt + gr + 8 * (x >> 1);
      const int col = st * 16 * SKT + 8 * j + 2 * c + (x & 1);
      e[j][x] = expf(score(e[j][x], scale, bs, row, col, Nk, causal) - ms[row]);   // -inf past Nk: 0
    }
}

// Sum over the 4 lanes that share a row of an mma C fragment.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

template <int SKT, int QPW>
__global__ void __launch_bounds__(kMaxWarps * 32)
small_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ g, const float* __restrict__ m_in,
                     const float* __restrict__ inv_in, __nv_bfloat16* __restrict__ dq,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Strides sq,
                     Strides sk, Strides sv, Strides sg, Strides sdq, Strides sdk, Strides sdv,
                     int BH, int H, int Nq, int Nk, int G, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int skp = 16 * SKT;   // keys of a strip
  constexpr int ep = skp + 8;     // pitch of the e / ds tiles
  const int n_qt = (Nq + 15) / 16;
  const int nqp = 16 * n_qt;
  const int KT = (Nk + 15) / 16;
  const int nkp = 16 * KT;
  const int n_strips = (KT + SKT - 1) / SKT;
  // per pair: Q, G, N (= g * inv) [nqp][kMP]; K, V [skp][kMP]; E, D [nqp][ep]
  const int pair_elems = 3 * nqp * kMP + 2 * skp * kMP + 2 * nqp * ep;
  const int pair_floats = 2 * nqp + nkp;   // m, inv per row; the key bias
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* fbase = reinterpret_cast<float*>(base + G * pair_elems);
  auto Qs = [&](int p) { return base + p * pair_elems; };
  auto Gs = [&](int p) { return Qs(p) + nqp * kMP; };
  auto Ns = [&](int p) { return Gs(p) + nqp * kMP; };
  auto Ks = [&](int p) { return Ns(p) + nqp * kMP; };
  auto Vs = [&](int p) { return Ks(p) + skp * kMP; };
  auto Es = [&](int p) { return Vs(p) + skp * kMP; };
  auto Ds = [&](int p) { return Es(p) + nqp * ep; };
  auto Ms = [&](int p) { return fbase + p * pair_floats; };
  auto Is = [&](int p) { return Ms(p) + nqp; };
  auto Bs = [&](int p) { return Is(p) + nqp; };

  const int pair0 = blockIdx.x * G;
  const int npairs = min(G, BH - pair0);
  auto stage_strip = [&](int st) {
    for (int p = 0; p < npairs; ++p) {
      const int bh = pair0 + p, b = bh / H, h = bh % H;
      stage_rows(Ks(p), k + b * sk.b + h * sk.h, sk.n, st * skp, Nk, skp);
      stage_rows(Vs(p), v + b * sv.b + h * sv.h, sv.n, st * skp, Nk, skp);
    }
  };
  for (int p = 0; p < npairs; ++p) {
    const int bh = pair0 + p, b = bh / H, h = bh % H;
    stage_rows(Qs(p), q + b * sq.b + h * sq.h, sq.n, 0, Nq, nqp);
    stage_rows(Gs(p), g + b * sg.b + h * sg.h, sg.n, 0, Nq, nqp);
    for (int j = threadIdx.x; j < nqp; j += blockDim.x) {
      const bool ok = j < Nq;   // padded rows: m = inv = 0, so they weigh nothing
      Ms(p)[j] = ok ? m_in[(long long)bh * Nq + j] : 0.f;
      Is(p)[j] = ok ? inv_in[(long long)bh * Nq + j] : 0.f;
    }
    for (int j = threadIdx.x; j < nkp; j += blockDim.x)
      Bs(p)[j] = j < Nk ? bias[(long long)b * Nk + j] : 0.f;
  }
  if (n_strips == 1) stage_strip(0);
  cp_async_wait_all();
  __syncthreads();
  for (int p = 0; p < npairs; ++p)   // g * inv cast to bf16, read after the next barrier
    for (int e = threadIdx.x; e < nqp * kMD; e += blockDim.x) {
      const int r = e / kMD, d = e % kMD;
      Ns(p)[r * kMP + d] = __float2bfloat16(__bfloat162float(Gs(p)[r * kMP + d]) * Is(p)[r]);
    }

  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int c = lane & 3;
  const int n_items = npairs * n_qt;

  float cr[QPW][2];
#pragma unroll
  for (int s = 0; s < QPW; ++s) cr[s][0] = cr[s][1] = 0.f;
  if (n_strips > 1) {   // c first, over every strip (a recompute; wide shapes only)
    for (int st = 0; st < n_strips; ++st) {
      __syncthreads();   // the previous strip's reads are done
      stage_strip(st);
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int s = 0; s < QPW; ++s) {
        const int item = warp + s * nwarps;
        if (item >= n_items) continue;
        const int p = item / n_qt;
        float e[2 * SKT][4], dp[2 * SKT][4];
        strip_scores<SKT>(Qs(p), Gs(p), Ks(p), Vs(p), Ms(p), Bs(p), item % n_qt, st, KT, Nk,
                          causal, scale, e, dp);
#pragma unroll
        for (int j = 0; j < 2 * SKT; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) cr[s][x >> 1] = fmaf(dp[j][x], e[j][x], cr[s][x >> 1]);
      }
    }
#pragma unroll
    for (int s = 0; s < QPW; ++s) {
      const int item = warp + s * nwarps;
      if (item >= n_items) continue;
      const float* is = Is(item / n_qt);
      const int qt = item % n_qt;
#pragma unroll
      for (int r = 0; r < 2; ++r) cr[s][r] = quad_sum(cr[s][r]) * is[16 * qt + gr + 8 * r];
    }
  }

  float dqa[QPW][8][4];
#pragma unroll
  for (int s = 0; s < QPW; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) dqa[s][j][x] = 0.f;

  for (int st = 0; st < n_strips; ++st) {
    if (n_strips > 1) {
      __syncthreads();   // the previous strip's reads (dq, dk, dv) are done
      stage_strip(st);
      cp_async_wait_all();
    }
    __syncthreads();   // the strip is staged and N complete

    // query side: ds, dq += ds k, and bf16(e), bf16(ds) staged for dk / dv
#pragma unroll
    for (int s = 0; s < QPW; ++s) {
      const int item = warp + s * nwarps;
      if (item >= n_items) continue;
      const int p = item / n_qt, qt = item % n_qt;
      float e[2 * SKT][4], dp[2 * SKT][4];
      strip_scores<SKT>(Qs(p), Gs(p), Ks(p), Vs(p), Ms(p), Bs(p), qt, st, KT, Nk, causal, scale,
                        e, dp);
      const float inv[2] = {Is(p)[16 * qt + gr], Is(p)[16 * qt + gr + 8]};
      if (n_strips == 1) {   // the whole row is here: c in the same pass
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2 * SKT; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) part[x >> 1] = fmaf(dp[j][x], e[j][x], part[x >> 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) cr[s][r] = quad_sum(part[r]) * inv[r];
      }
#pragma unroll
      for (int j = 0; j < 2 * SKT; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          dp[j][x] = e[j][x] * ((dp[j][x] - cr[s][x >> 1]) * inv[x >> 1]);   // ds
#pragma unroll
      for (int t = 0; t < SKT; ++t)
        if (st * SKT + t < KT) mma_nn16(dqa[s], dp[2 * t], dp[2 * t + 1], Ks(p), 16 * t);
      __nv_bfloat16* es = Es(p);
      __nv_bfloat16* ds = Ds(p);
#pragma unroll
      for (int j = 0; j < 2 * SKT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (16 * qt + gr + 8 * r) * ep + 8 * j + 2 * c;
          *reinterpret_cast<uint32_t*>(es + off) = pack_bf16(e[j][2 * r], e[j][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(ds + off) = pack_bf16(dp[j][2 * r], dp[j][2 * r + 1]);
        }
    }
    __syncthreads();   // e and ds of every query row of the strip are staged

    // key side: each warp owns 16 keys of the strip; dk, dv over all rows
    for (int item = warp; item < npairs * SKT; item += nwarps) {
      const int p = item / SKT, jj = item % SKT;
      const int kt = st * SKT + jj;
      if (kt >= KT) continue;
      float dka[8][4], dva[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) dka[j][x] = dva[j][x] = 0.f;
      for (int qs = 0; qs < n_qt; ++qs) {
        mma_tn16(dka, Ds(p), ep, 16 * jj, 16 * qs, Qs(p));
        mma_tn16(dva, Es(p), ep, 16 * jj, 16 * qs, Ns(p));
      }
      const int bh = pair0 + p, b = bh / H, h = bh % H;
      store_rows(dk + b * sdk.b + h * sdk.h, sdk.n, 16 * kt, Nk, dka, scale);
      store_rows(dv + b * sdv.b + h * sdv.h, sdv.n, 16 * kt, Nk, dva, 1.f);
    }
  }

#pragma unroll
  for (int s = 0; s < QPW; ++s) {
    const int item = warp + s * nwarps;
    if (item >= n_items) continue;
    const int bh = pair0 + item / n_qt, b = bh / H, h = bh % H;
    store_rows(dq + b * sdq.b + h * sdq.h, sdq.n, 16 * (item % n_qt), Nq, dqa[s], scale);
  }
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

inline long long bwd_pair_smem(int nqp, int nkp, int skt) {
  return (long long)(3 * nqp + 2 * 16 * skt) * kMP * 2 + 2LL * nqp * (16 * skt + 8) * 2 +
         (2LL * nqp + nkp) * 4;
}

inline int launch_bwd_mma(const void* q, const void* k, const void* v, const float* bias,
                          const void* g, const float* m, const float* inv, void* dq, void* dk,
                          void* dv, const Strides* st, int B, int H, int Nq, int Nk, int causal,
                          float scale, int device, cudaStream_t stream) {
  const int KT = (Nk + 15) / 16;
  const int n_qt = (Nq + 15) / 16;
  const int BH = B * H;
  int skt, qpw, G, warps;
  if (KT <= kSingleStripKT && n_qt <= kMaxWarps) {   // one strip: every key at once
    skt = KT;
    qpw = 1;
    G = pick_group(BH, n_qt, bwd_pair_smem(16 * n_qt, 16 * KT, skt), kMaxWarps);
    warps = min(kMaxWarps, G * max(n_qt, KT));
  } else {
    skt = kMultiStripKT;
    G = 1;
    warps = kMaxWarps;
    qpw = (n_qt + warps - 1) / warps;
  }
  const size_t smem = (size_t)(G * bwd_pair_smem(16 * n_qt, 16 * KT, skt));
  decltype(&small_bwd_mma_kernel<1, 1>) kernel = nullptr;
  if (qpw == 1) {
    switch (skt) {
      case 1: kernel = small_bwd_mma_kernel<1, 1>; break;
      case 2: kernel = small_bwd_mma_kernel<2, 1>; break;
      case 3: kernel = small_bwd_mma_kernel<3, 1>; break;
      case 4: kernel = small_bwd_mma_kernel<4, 1>; break;
      case 5: kernel = small_bwd_mma_kernel<5, 1>; break;
      case 6: kernel = small_bwd_mma_kernel<6, 1>; break;
    }
  } else if (qpw == 2 && skt == kMultiStripKT) {
    kernel = small_bwd_mma_kernel<kMultiStripKT, 2>;
  }
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  typedef const __nv_bfloat16* P;
  kernel<<<(unsigned)((BH + G - 1) / G), 32 * warps, smem, stream>>>(
      (P)q, (P)k, (P)v, bias, (P)g, m, inv, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], BH, H, Nq, Nk, G,
      causal, scale);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Strides st[7];
  for (int i = 0; i < 7; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return small::launch_bwd_dp<float>(DP, q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, Dh, causal, scale, device, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  bool mma = Dh == kMD;
  const void* in[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i) mma = mma && mma_aligned(in[i], strides + 3 * i);
  void* out[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i)
    mma = mma && (uintptr_t)out[i] % 4 == 0 && strides[12 + 3 * i] % 2 == 0 &&
          strides[13 + 3 * i] % 2 == 0 && strides[14 + 3 * i] % 2 == 0;
  if (mma)
    return small::launch_bwd_mma(q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, causal, scale, device, s);
  return small::launch_bwd_dp<__nv_bfloat16>(DP, q, k, v, bias, g, m, inv, dq, dk, dv, st, B, H, Nq, Nk, Dh, causal, scale, device, s);
}

const char* flash_small_bwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
