// Fused masked attention, forward, templated on a mask policy
// (flash_attention_common.cuh): out = softmax(masked(q k^T / sqrt(Dh))) v,
// plus the row statistics the backward reads. flash_attention_fwd.cu binds
// it to the key-bias mask, flash_attention_spans_fwd.cu to the span mask.
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
// Two variants compute the same function:
//   * flash_fwd_mma_kernel, for bf16 operands with Dh = 64 whose rows can be
//     copied 16 bytes at a time (the model's case): q k^T and p v on the
//     tensor cores (mma.sync m16n8k16, fp32 accumulate), four warps of 16
//     query rows each. Tile loads are synchronous and the exp / mask work
//     runs on the CUDA cores, so it stays well above its bound; cp.async or
//     TMA pipelining and wgmma are the next steps.
//   * flash_fwd_kernel, for fp32 operands, other head sizes (Dh <= 128) and
//     unaligned views: fp32 FMAs on the CUDA cores (67 TFLOP/s) from
//     shared-memory tiles, bound by fp32 operations and shared-memory
//     bandwidth.
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

// Tensor-core variant for bf16 at Dh = 64 (the model's shape): the same
// function and tiling, with q k^T and p v on mma.sync. Each warp owns 16 of
// the tile's 64 query rows; its score block (16 x 64 keys) and output
// (16 x 64 dims) live in registers in the mma C layout, so the row max and
// sum reduce over the 4 lanes that share a row. e is rounded to bf16 when
// packed into the A fragments of the p v product, as the TPU kernel casts
// it; the running sum adds the unrounded values.
template <typename Mask>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const Mask mask,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ inv_out, Strides sq, Strides sk, Strides sv, Strides so,
                     int H, int Nq, int Nk, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[64 * kMP];
  __shared__ __align__(16) __nv_bfloat16 Ks[64 * kMP];
  __shared__ __align__(16) __nv_bfloat16 Vs[64 * kMP];
  __shared__ typename Mask::Smem msm;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
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

  load_tile_mma(Qs, q + b * sq.b + h * sq.h, sq.n, q0, Nq);
  __syncthreads();
  uint32_t qf[4][4];
  load_a_frags(qf, Qs, warp * 16);

  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int row[2] = {q0 + rl[0], q0 + rl[1]};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    if (!mk.tile(msm, q0, k0)) continue;
    load_tile_mma(Ks, kp, sk.n, k0, Nk);
    load_tile_mma(Vs, vp, sv.n, k0, Nk);
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    mma_rows_nt(sc, qf, Ks);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + (e & 1);
        sc[j][e] = mk.score(msm, sc[j][e], scale, rl[e >> 1], col, row[e >> 1], k0 + col);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile has a key < Nk
      alpha[r] = expf(m[r] - m_new);            // 0 on the first tile (m = -inf)
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - m[e >> 1]);
        rs[e >> 1] += sc[j][e];
        acc[j][e] *= alpha[e >> 1];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
      rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
    mma_rows_nn(acc, sc, Vs);
  }

  __nv_bfloat16* op = o + b * so.b + h * so.h;
  const long long stat0 = ((long long)b * H + h) * Nq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Nq) continue;
    const float inv = m[r] > 0.5f * kNegInf ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(op + (long long)row[r] * so.n + 8 * j + 2 * c) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    if (c == 0 && m_out != nullptr) {
      m_out[stat0 + row[r]] = stored_max(m[r]);
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
int launch_fwd_mma(const Mask& mask, const void* q, const void* k, const void* v, void* o,
                   float* m, float* inv, const long long* st, int B, int H, int Nq, int Nk,
                   float scale, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((Nq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  flash_fwd_mma_kernel<Mask><<<(unsigned)blocks, kMmaThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, mask,
      (__nv_bfloat16*)o, m, inv, sq, sk, sv, so, H, Nq, Nk, scale);
  return (int)cudaGetLastError();
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
  if (Nk <= 0 || Dh <= 0 || DP == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd_dp<Mask, float>(DP, mask, q, k, v, o, m, inv, strides, B, H, Nq, Nk, Dh, scale, device, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (Dh == kMD && mma_aligned(q, strides) && mma_aligned(k, strides + 3) &&
      mma_aligned(v, strides + 6) && strides[9] % 2 == 0 && strides[10] % 2 == 0 &&
      strides[11] % 2 == 0 && (uintptr_t)o % 4 == 0)
    return launch_fwd_mma<Mask>(mask, q, k, v, o, m, inv, strides, B, H, Nq, Nk, scale, device, s);
  return launch_fwd_dp<Mask, __nv_bfloat16>(DP, mask, q, k, v, o, m, inv, strides, B, H, Nq, Nk, Dh, scale, device, s);
}

}  // namespace flash
