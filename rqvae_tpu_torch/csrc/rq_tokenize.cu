// Fused L-level residual vector quantization, hard argmin (corpus tokenization).
//
// Replaces the TPU kernel rqvae_tpu/ops/quantize_pallas.py:_rq_kernel
// (rq_tokenize). Per row and level l:
//   dist_c = (||r||^2 - 2 r.cb_c) + ||cb_c||^2      (fp32, the TPU kernel's term order)
//   id     = argmin_c dist_c                         (lowest index on ties, as jnp.argmin)
//   emb    = cb[id];  loss += (1 + beta) ||r - emb||^2;  r -= emb
// Outputs: ids (B, L) int32, emb_sum (B, D), final residual (B, D), loss (B,).
//
// What bounds it on an H100: at the shipped shape (B = 4096-row chunks, L = 3,
// K = 256, D = 32) the 2*B*L*K*D fp32 FMAs of the distance products
// (~0.2 GFLOP, ~3 us at 67 TFLOP/s fp32) outweigh the ~1.6 MB of traffic
// (~0.5 us at 3.35 TB/s): it is bound by fp32 operations, and at this size in
// practice by launch latency and the per-block codebook load.
//
// Design: the whole (L, K, D) codebook stack is staged once per block in
// dynamic shared memory, TRANSPOSED to [l][d][k] with a row pitch of K + 1, so
// that the 32 lanes of a warp read 32 consecutive codes of one dimension
// (conflict-free) and the transposing store is conflict-free too. ||cb||^2 is
// computed once per block. One warp owns one row: each lane keeps D/32
// residual elements in registers across the L levels and broadcasts them
// with shuffles; each lane scores K/32 codes per level (8 at a time in
// registers), then a butterfly argmin with lowest-index tie-break leaves the
// winner in every lane. The codeword is read straight from global memory
// (coalesced over D): the TPU kernel's one-hot matmul was a systolic-array
// trick and is not needed here. No (B, K) distance matrix is ever written.
// Limits: D <= 128; the stack must fit the block's opt-in shared memory
// (3 x 256 x 32 uses ~101 KB of 227 KB). Larger codebooks need K-tiling.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDPerLane = 4;   // D <= 128
constexpr int kCodesPerLane = 8;  // codes a lane scores per pass (256 per warp pass)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
rq_tokenize_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                   int32_t* __restrict__ ids, float* __restrict__ emb_out,
                   float* __restrict__ res_out, float* __restrict__ loss_out,
                   int B, int L, int K, int D, float loss_scale) {
  extern __shared__ float smem[];
  const int Kp = K + 1;
  float* cbT = smem;                              // [L][D][Kp]
  float* cbn = smem + (size_t)L * D * Kp;         // [L][K]

  const int total = L * K * D;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int d = i % D;
    const int lc = i / D;
    const int c = lc % K;
    const int l = lc / K;
    cbT[((size_t)l * D + d) * Kp + c] = cb[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L * K; i += blockDim.x) {
    const int c = i % K;
    const int l = i / K;
    const float* col = cbT + (size_t)l * D * Kp + c;
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float v = col[(size_t)d * Kp];
      s = fmaf(v, v, s);
    }
    cbn[i] = s;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nd = (D + 31) / 32;
  for (int row = blockIdx.x * kWarps + warp; row < B; row += gridDim.x * kWarps) {
    float r[kMaxDPerLane];
    float es[kMaxDPerLane];
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      r[i] = (i < nd && d < D) ? x[(size_t)row * D + d] : 0.f;
      es[i] = 0.f;
    }
    float loss = 0.f;
    for (int l = 0; l < L; ++l) {
      float rr = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) rr = fmaf(r[i], r[i], rr);
      rr = warp_sum(rr);

      const float* cbl = cbT + (size_t)l * D * Kp;
      const float* cnl = cbn + (size_t)l * K;
      float best = __int_as_float(0x7f800000);  // +inf
      int best_c = 0x7fffffff;
      for (int c0 = 0; c0 < K; c0 += 32 * kCodesPerLane) {
        float acc[kCodesPerLane];
#pragma unroll
        for (int j = 0; j < kCodesPerLane; ++j) acc[j] = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxDPerLane; ++i) {
          if (i < nd) {
            for (int dd = 0; dd < 32; ++dd) {
              const int d = 32 * i + dd;
              if (d >= D) break;  // warp-uniform
              const float rd = __shfl_sync(kFull, r[i], dd);
              const float* cbd = cbl + (size_t)d * Kp + c0 + lane;
#pragma unroll
              for (int j = 0; j < kCodesPerLane; ++j) {
                if (c0 + lane + 32 * j < K) acc[j] = fmaf(rd, cbd[32 * j], acc[j]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kCodesPerLane; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < K) {
            const float dist = (rr - 2.f * acc[j]) + cnl[c];
            if (dist < best) {  // codes visited in increasing c: lowest index wins ties
              best = dist;
              best_c = c;
            }
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int oc = __shfl_xor_sync(kFull, best_c, off);
        if (ob < best || (ob == best && oc < best_c)) {
          best = ob;
          best_c = oc;
        }
      }
      if (best_c >= K) best_c = 0;  // every distance inf/NaN: jnp.argmin gives 0 for inf

      const float* cw = cb + ((size_t)l * K + best_c) * D;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (i < nd && d < D) {
          const float e = cw[d];
          const float diff = r[i] - e;
          part = fmaf(diff, diff, part);
          es[i] += e;
          r[i] = diff;
        }
      }
      loss += loss_scale * warp_sum(part);
      if (lane == 0) ids[(size_t)row * L + l] = best_c;
    }
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (i < nd && d < D) {
        emb_out[(size_t)row * D + d] = es[i];
        res_out[(size_t)row * D + d] = r[i];
      }
    }
    if (lane == 0) loss_out[row] = loss;
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for an (L, K, D) codebook stack.
long long rq_tokenize_smem_bytes(int L, int K, int D) {
  return ((long long)L * D * (K + 1) + (long long)L * K) * (long long)sizeof(float);
}

int rq_tokenize_max_d() { return 32 * kMaxDPerLane; }

// Opt-in shared memory a block may use on ``device``.
long long rq_tokenize_max_smem(int device) {
  int max_optin = 0;
  if (cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  return max_optin;
}

// Launches on ``stream`` of ``device``; returns the CUDA error code of the
// launch (0 = ok). This library links its own CUDA runtime, so the device is
// set here rather than inherited from the caller's runtime.
int rq_tokenize_launch(const float* x, const float* cb, int32_t* ids, float* emb,
                       float* res, float* loss, int B, int L, int K, int D,
                       float commitment_weight, int device, void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || D > 32 * kMaxDPerLane || L <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long smem = rq_tokenize_smem_bytes(L, K, D);
  const int dev = device;
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  int max_optin = 0, sms = 0;
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (smem > max_optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(rq_tokenize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rq_tokenize_kernel, kThreads,
                                                      (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const int want = (B + kWarps - 1) / kWarps;
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  rq_tokenize_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      x, cb, ids, emb, res, loss, B, L, K, D, 1.0f + commitment_weight);
  return (int)cudaGetLastError();
}

const char* rq_tokenize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
