// Short-sequence fused masked attention, forward:
// out = softmax(q k^T / sqrt(Dh) + bias) v for Nq, Nk < 256, plus the row
// statistics the backward reads (m, the row max, and inv, each (B, H, Nq)
// fp32).
//
// Replaces the TPU kernel rqvae_tpu/ops/flash_attention.py:_flash_small_kernel
// (flash_attention_small's forward). Its arithmetic: scores in fp32 with the
// key bias and the causal cut, one max / exp / sum over the whole row,
// e = exp(s - m) cast to the operand type before the PV product, and
// inv = (m > -5e29 ? 1 / sum(e) : 0) folded into the output, so a row with no
// valid key gives zeros.
//
// What bounds it on an H100: at the Amazon encoder shape (B = 256, H = 8,
// N = 81, Dh = 64, bf16) q, k, v and out are 4 x 21.2 MB, 0.025 ms at
// 3.35 TB/s, against 4 B H Nq Nk Dh = 3.4 GFLOP, 0.0035 ms at 989 TFLOP/s:
// bytes. So the design reads each operand once: a CTA owns G whole (batch,
// head) pairs, stages their q, k and v in shared memory with 16-byte
// cp.async copies (all in flight at once) and computes everything from
// there. The TPU kernel groups pairs to amortise its grid steps under a VMEM
// budget (its default_group); here G gives a CTA up to 4 warps of work on
// short query sides (the decoder's 5 x 5, a decode step's 1 x T) within a
// shared-memory budget that keeps two CTAs on an SM, and stays 1 where one
// pair already has enough rows. There is no online softmax: with Nk <= 255,
// a warp holds its 16 query rows' whole score row in registers (at most 16
// key tiles of 16), takes the max, the exponentials and the sum in one pass
// and multiplies by v.
//
// Two variants compute the same function:
//   * small_fwd_mma_kernel<KT>: bf16 operands with Dh = 64 whose rows can be
//     copied 16 bytes at a time (the model's case). q k^T and p v on the
//     tensor cores (mma.sync m16n8k16, fp32 accumulate); KT = ceil(Nk / 16)
//     key tiles of 16, a template constant so the score row stays in
//     registers. Each warp owns one (pair, 16-row query tile) at a time.
//   * small_fwd_kernel<T, DP>: fp32 operands, other head sizes (Dh <= 128)
//     and unaligned views: a CTA owns one pair's 64-row query tile, stages
//     key tiles of 64 in shared memory as fp32 and writes every score of its
//     rows to a shared-memory row of up to 256 (the fp32 K and V of a whole
//     pair at Dh = 128 would exceed 227 KB), then the same one-pass softmax
//     and p v on the CUDA cores.
#include "flash_attention_small.cuh"

namespace flash {
namespace small {

template <int KT>
__global__ void __launch_bounds__(kMaxWarps * 32)
small_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ inv_out, Strides sq, Strides sk, Strides sv, Strides so,
                     int BH, int H, int Nq, int Nk, int G, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nkp = 16 * KT;
  const int n_qt = (Nq + 15) / 16;
  const int nqp = 16 * n_qt;
  const int pair_elems = (nqp + 2 * nkp) * kMP;   // Q, K, V of one pair
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* bias_s = reinterpret_cast<float*>(base + G * pair_elems);   // [G][nkp]

  const int pair0 = blockIdx.x * G;
  const int npairs = min(G, BH - pair0);
  for (int p = 0; p < npairs; ++p) {
    const int bh = pair0 + p, b = bh / H, h = bh % H;
    __nv_bfloat16* Qs = base + p * pair_elems;
    stage_rows(Qs, q + b * sq.b + h * sq.h, sq.n, 0, Nq, nqp);
    stage_rows(Qs + nqp * kMP, k + b * sk.b + h * sk.h, sk.n, 0, Nk, nkp);
    stage_rows(Qs + (nqp + nkp) * kMP, v + b * sv.b + h * sv.h, sv.n, 0, Nk, nkp);
    for (int j = threadIdx.x; j < nkp; j += blockDim.x)
      bias_s[p * nkp + j] = j < Nk ? bias[(long long)b * Nk + j] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  for (int item = warp; item < npairs * n_qt; item += nwarps) {
    const int p = item / n_qt, qt = item % n_qt;
    const int bh = pair0 + p, b = bh / H, h = bh % H;
    const __nv_bfloat16* Qs = base + p * pair_elems;
    const __nv_bfloat16* Ks = Qs + nqp * kMP;
    const __nv_bfloat16* Vs = Ks + nkp * kMP;
    const float* bs = bias_s + p * nkp;
    const int row[2] = {16 * qt + g, 16 * qt + g + 8};

    uint32_t qf[4][4];
    load_a_frags(qf, Qs, 16 * qt);
    float sc[2 * KT][4];
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int jj = 0; jj < KT; ++jj) mma_nt16(sc[2 * jj], sc[2 * jj + 1], qf, Ks, 16 * jj);

    // the whole row: max, exp, sum in one pass (no online carry)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = score(sc[j][e], scale, bs, row[e >> 1], 8 * j + 2 * c + (e & 1), Nk, causal);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));   // finite: key 0 < Nk
    }
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - mx[e >> 1]);
        rs[e >> 1] += sc[j][e];
      }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
      rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
      inv[r] = mx[r] > 0.5f * kNegInf ? 1.f / rs[r] : 0.f;
    }

    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int t = 0; t < KT; ++t) mma_nn16(acc, sc[2 * t], sc[2 * t + 1], Vs, 16 * t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];

    store_rows(o + b * so.b + h * so.h, so.n, 16 * qt, Nq, acc, 1.f);
    const long long stat0 = (long long)bh * Nq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (c == 0 && row[r] < Nq) {
        m_out[stat0 + row[r]] = mx[r];
        inv_out[stat0 + row[r]] = inv[r];
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
small_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ inv_out, Strides sq, Strides sk, Strides sv, Strides so,
                 int H, int Nq, int Nk, int Dh, int causal, float scale) {
  constexpr int QP = DP + 1;
  constexpr int DPT = DP / 16;  // output dimensions per thread
  extern __shared__ float smem[];
  const int nkp = ((Nk + kBK - 1) / kBK) * kBK;
  const int sp = nkp + 1;
  float* Qs = smem;              // [kBQ][QP]
  float* KV = Qs + kBQ * QP;     // [kBK][QP]: a key tile, then a value tile
  float* S = KV + kBK * QP;      // [kBQ][sp]: the scores, then e cast to T
  float* bs = S + kBQ * sp;      // [nkp] the key bias

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int n_qt = (Nq + kBQ - 1) / kBQ;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H;
  const int b = bh / H;
  const int q0 = qt * kBQ;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;

  load_tile<T, DP>(Qs, QP, q + b * sq.b + h * sq.h, sq.n, q0, Nq, Dh);
  for (int j = threadIdx.x; j < nkp; j += kThreads) bs[j] = j < Nk ? bias[(long long)b * Nk + j] : 0.f;

  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    __syncthreads();   // the previous tile's reads are done (and Qs, bs are staged)
    load_tile<T, DP>(KV, QP, kp, sk.n, k0, Nk, Dh);
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
      for (int j = 0; j < 4; ++j) kv[j] = KV[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = ty + 16 * i, col = k0 + tx + 16 * j;
        S[rl * sp + col] = score(s[i][j], scale, bs, q0 + rl, col, Nk, causal);
      }
  }
  __syncthreads();

  // the whole row: the 16 threads of a row share it; max, exp, sum once
  float m[4], inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* srow = S + (ty + 16 * i) * sp;
    float mx = -INFINITY;
    for (int col = tx; col < nkp; col += 16) mx = fmaxf(mx, srow[col]);
    mx = row_max16(mx);   // finite: key 0 < Nk
    float rs = 0.f;
    for (int col = tx; col < nkp; col += 16) {
      const float e = expf(srow[col] - mx);
      rs += e;
      srow[col] = round_to<T>(e);
    }
    rs = row_sum16(rs);
    m[i] = mx;
    inv[i] = mx > 0.5f * kNegInf ? 1.f / rs : 0.f;
  }

  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    __syncthreads();   // e is complete; the previous value tile's reads are done
    load_tile<T, DP>(KV, QP, vp, sv.n, k0, Nk, Dh);
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < kBK; ++cc) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = S[(ty + 16 * i) * sp + k0 + cc];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = KV[cc * QP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* op = o + b * so.b + h * so.h;
  const long long stat0 = (long long)bh * Nq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Nq) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < Dh) op[(long long)row * so.n + d] = from_f<T>(acc[i][j] * inv[i]);
    }
    if (tx == 0) {
      m_out[stat0 + row] = m[i];
      inv_out[stat0 + row] = inv[i];
    }
  }
}

inline int launch_fwd_mma(const void* q, const void* k, const void* v, const float* bias, void* o,
                          float* m, float* inv, const Strides* st, int B, int H, int Nq, int Nk,
                          int causal, float scale, int device, cudaStream_t stream) {
  const int KT = (Nk + 15) / 16;
  const int n_qt = (Nq + 15) / 16;
  const long long pair_smem = (long long)(16 * n_qt + 2 * 16 * KT) * kMP * 2 + 16 * KT * 4;
  const int BH = B * H;
  const int G = pick_group(BH, n_qt, pair_smem, 4);
  const int warps = min(kMaxWarps, G * n_qt);
  const size_t smem = (size_t)(G * pair_smem);
  decltype(&small_fwd_mma_kernel<1>) kernel = nullptr;
  switch (KT) {
#define FLASH_SMALL_KT(n) \
  case n: kernel = small_fwd_mma_kernel<n>; break;
    FLASH_SMALL_KT(1) FLASH_SMALL_KT(2) FLASH_SMALL_KT(3) FLASH_SMALL_KT(4)
    FLASH_SMALL_KT(5) FLASH_SMALL_KT(6) FLASH_SMALL_KT(7) FLASH_SMALL_KT(8)
    FLASH_SMALL_KT(9) FLASH_SMALL_KT(10) FLASH_SMALL_KT(11) FLASH_SMALL_KT(12)
    FLASH_SMALL_KT(13) FLASH_SMALL_KT(14) FLASH_SMALL_KT(15) FLASH_SMALL_KT(16)
#undef FLASH_SMALL_KT
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((BH + G - 1) / G), 32 * warps, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, bias,
      (__nv_bfloat16*)o, m, inv, st[0], st[1], st[2], st[3], BH, H, Nq, Nk, G, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias, void* o, float* m,
               float* inv, const Strides* st, int B, int H, int Nq, int Nk, int Dh, int causal,
               float scale, int device, cudaStream_t stream) {
  auto kernel = small_fwd_kernel<T, DP>;
  const int nkp = ((Nk + kBK - 1) / kBK) * kBK;
  const size_t smem = sizeof(float) * (size_t)(kBQ * (DP + 1) + kBK * (DP + 1) + kBQ * (nkp + 1) + nkp);
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((Nq + kBQ - 1) / kBQ);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)o, m, inv, st[0], st[1], st[2], st[3], H,
      Nq, Nk, Dh, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_dp(int DP, const void* q, const void* k, const void* v, const float* bias, void* o,
                  float* m, float* inv, const Strides* st, int B, int H, int Nq, int Nk, int Dh,
                  int causal, float scale, int device, cudaStream_t stream) {
  switch (DP) {
    case 32: return launch_fwd<T, 32>(q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, Dh, causal, scale, device, stream);
    case 64: return launch_fwd<T, 64>(q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, Dh, causal, scale, device, stream);
    case 128: return launch_fwd<T, 128>(q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, Dh, causal, scale, device, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace small
}  // namespace flash

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). strides: 12
// element strides, (batch, head, seq) of q, k, v, o. bias: (B, Nk) fp32,
// contiguous. m, inv: (B, H, Nq) fp32, contiguous. Nq, Nk in [1, 255],
// Dh <= 128. Returns the CUDA error code of the launch (0 = ok). The library
// links its own CUDA runtime, so the device is set here.
int flash_small_fwd_launch(int dtype, const void* q, const void* k, const void* v,
                           const float* bias, void* o, float* m, float* inv,
                           const long long* strides, int B, int H, int Nq, int Nk, int Dh,
                           int causal, float scale, int device, void* stream) {
  using namespace flash;
  if (B <= 0 || H <= 0 || Nq <= 0) return 0;
  const int DP = dp_for(Dh);
  if (Nk <= 0 || Nq > small::kMaxLen || Nk > small::kMaxLen || Dh <= 0 || DP == 0 ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const Strides st[4] = {{strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]}, {strides[9], strides[10], strides[11]}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return small::launch_fwd_dp<float>(DP, q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, Dh, causal, scale, device, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (Dh == kMD && mma_aligned(q, strides) && mma_aligned(k, strides + 3) &&
      mma_aligned(v, strides + 6) && strides[9] % 2 == 0 && strides[10] % 2 == 0 &&
      strides[11] % 2 == 0 && (uintptr_t)o % 4 == 0)
    return small::launch_fwd_mma(q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, causal, scale, device, s);
  return small::launch_fwd_dp<__nv_bfloat16>(DP, q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, Dh, causal, scale, device, s);
}

const char* flash_small_fwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

FLASH_EXPORT_ATTRIBUTE_CALLS(flash_small_fwd)

}  // extern "C"
