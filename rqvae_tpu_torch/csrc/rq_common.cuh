// K-tiled L-level residual vector quantization, hard argmin: the loop shared
// by csrc/rq_tokenize.cu (corpus tokenization) and csrc/rq_quantize_train.cu
// (the stage-1 training forward).
//
// Per row and level l (the TPU kernels' arithmetic, fp32):
//   dist_c = (||r||^2 - 2 r.cb_c) + ||cb_c||^2      (the TPU kernels' term order)
//   id     = argmin_c dist_c                         (lowest index on ties, as jnp.argmin)
//   emb    = cb[id];  loss += (1 + beta) ||r - emb||^2;  r -= emb
//
// The TPU kernels keep the whole (L, K, D) stack in VMEM. A block here may use
// 227 KB of shared memory, and the 4 x 2048 x 64 fp32 stack of the stretch
// shape is 2 MB, so the codebooks are TILED along K: a tile of up to 512
// codes is staged in shared memory with 16-byte cp.async copies (all of a
// tile's copies in flight at once), and every row keeps a running
// (distance, index) minimum across tiles. The comparison takes the smaller
// distance, or the lower index on equal distances, so the result is
// jnp.argmin's whatever order tiles and lanes are visited in. Level l + 1
// starts only after level l's argmin is final: the residual chain is
// sequential.
//
// Work layout: a block of 4 warps owns `rows` rows (8, 16 or 32) and walks
// every tile of every level. Each lane scores 8 rows x 4 codes per tile (an
// 8 x 4 register tile of dot products), 4 dimensions at a time: the 4 codes,
// 32 apart, are one float4 each (a staged code is padded to an odd number of
// 16-byte chunks, so a quarter-warp's 8 float4 reads hit 8 bank groups), the
// 8 residual values are float4 broadcasts, i.e. 128 FMAs per 12 shared
// loads: the loop is bound by the fp32 FMA pipe, not by shared memory. The
// warps of a block sit side by side along codes (`code_groups` of them, 128
// codes each) and on top of each other along rows; a level ends with a
// butterfly argmin in each warp and a merge of the code groups in shared
// memory, then one warp per row reads the winning codeword (from the staged
// tile when one tile holds the level, else from global memory, coalesced over
// D), stores it and updates the residual. ||cb||^2 comes from
// a small pass over the stack before the main kernel (one warp per code).
// D must be a multiple of 4 (the wrapper zero-pads other widths, which
// changes no distance).
//
// What bounds it on an H100: 2*B*L*K*D fp32 FMAs (1.07 GFLOP at B = 1024,
// L = 4, K = 2048, D = 64: ~16 us at 67 TFLOP/s) against ~4.5 MB of traffic
// (~1.3 us at 3.35 TB/s): fp32 operations. What this design gives up: a
// block's rows re-read the whole stack from L2 (2 MB per block; B = 1024 at
// 8 rows a block is 128 blocks for 132 SMs, 256 MB of L2 reads), one block of
// 4 warps fills an SM at the stretch shape (little latency hiding), and
// tiles are not double-buffered: a tile's copies are issued, waited for,
// then scored.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rq {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;                     // rows every lane scores together
constexpr int kCodesPerLane = 4;                    // codes a lane scores per tile, 32 apart
constexpr int kCodesPerWarp = 32 * kCodesPerLane;   // 128
constexpr int kMaxD = 128;
constexpr int kMaxDPerLane = kMaxD / 32;
constexpr int kTileFloats = 36864;                  // codebook tile budget: 144 KB
constexpr unsigned kFull = 0xffffffffu;

// How a launch lays out its blocks for an (L, K, D) stack.
struct Plan {
  int code_groups;  // warps side by side along the codes of a tile: 1, 2 or 4
  int rows;         // rows a block owns: kRowsPerWarp * kWarps / code_groups
  int tile;         // codes staged per tile: kCodesPerWarp * code_groups
  int pitch;        // floats between two codes of the staged tile
  long long smem;   // dynamic shared memory, bytes
};

// A staged code is D floats plus padding to an odd number of 16-byte chunks,
// so that the 8 lanes of a quarter-warp reading float4s of 8 consecutive codes
// hit 8 distinct bank groups.
static inline int tile_pitch(int D) {
  const int chunks = D / 4;
  return 4 * (chunks + (chunks % 2 == 0 ? 1 : 2));
}

static inline Plan plan_for(int K, int D) {
  const int pitch = tile_pitch(D);
  int cg = kWarps;
  // fewer, taller warps when a tile would exceed its budget or K is small
  while (cg > 1 && ((long long)cg * kCodesPerWarp * pitch > kTileFloats ||
                    (cg / 2) * kCodesPerWarp >= K))
    cg /= 2;
  Plan p;
  p.code_groups = cg;
  p.rows = kRowsPerWarp * (kWarps / cg);
  p.tile = kCodesPerWarp * cg;
  p.pitch = pitch;
  p.smem = (long long)sizeof(float) *
               ((long long)p.tile * pitch         // the tile, [tile][pitch]
                + 2LL * p.rows * D                // residuals and codeword sums, [rows][D]
                + p.tile                          // the tile's code norms
                + p.rows                          // ||r||^2 per row
                + (long long)cg * p.rows)         // per-warp best distance, [cg][rows]
           + (long long)sizeof(int) * cg * p.rows;  // per-warp best code
  return p;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Asynchronous 4-byte copy global -> shared (zero-filled when !valid): the
// tile's loads are all in flight at once instead of one L2 round trip each.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// The same for 16 bytes; ``bytes`` (0 or 16) are read, the rest zero-filled.
__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// (d, c) beats (bd, bc): smaller distance, or the lower code on a tie
__device__ __forceinline__ bool better(float d, int c, float bd, int bc) {
  return d < bd || (d == bd && c < bc);
}

// ||cb_c||^2 for every code of the stack, one warp per code.
__global__ void code_norms_kernel(const float* __restrict__ cb, float* __restrict__ norms,
                                  int n_codes, int D) {
  const int code = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (code >= n_codes) return;  // warp-uniform
  const float* c = cb + (size_t)code * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(c[d], c[d], s);
  s = warp_sum(s);
  if (lane == 0) norms[code] = s;
}

// kTrain: out_a = pre-level residuals (L, B, D), out_b = codewords (L, B, D).
// else:   out_a = codeword sum (B, D),          out_b = final residual (B, D).
// D is a multiple of 4 (the wrapper zero-pads other widths).
template <bool kTrain>
__global__ void __launch_bounds__(kThreads)
rq_kernel(const float* __restrict__ x, const float* __restrict__ cb,
          const float* __restrict__ norms, int32_t* __restrict__ ids,
          float* __restrict__ out_a, float* __restrict__ out_b, float* __restrict__ loss_out,
          int B, int L, int K, int D, int code_groups, int pitch, float loss_scale) {
  extern __shared__ __align__(16) float smem[];
  const int cg_n = code_groups;
  const int rows = kRowsPerWarp * (kWarps / cg_n);
  const int tile = kCodesPerWarp * cg_n;
  float* ts = smem;                                      // [tile][pitch] staged codes
  float* rs = ts + tile * pitch;                         // [rows][D] residuals
  float* es = rs + rows * D;                             // [rows][D] codeword sums
  float* cn = es + rows * D;                             // [tile] code norms
  float* rrs = cn + tile;                                // [rows] ||r||^2
  float* bd = rrs + rows;                                // [cg][rows]
  int* bc = reinterpret_cast<int*>(bd + cg_n * rows);    // [cg][rows]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp / cg_n;   // this warp's row group (8 rows)
  const int cgi = warp % cg_n;  // and code group (128 codes of a tile)
  const int row0 = blockIdx.x * rows;
  const int owned = rows / kWarps;  // rows this warp updates: warp + kWarps * j
  const int q4 = D / 4;             // float4 chunks per code

  const long long x0 = (long long)row0 * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    rs[i] = x0 + i < (long long)B * D ? x[x0 + i] : 0.f;
    es[i] = 0.f;
  }
  __syncthreads();
  float loss[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    loss[j] = 0.f;
    if (j < owned) {
      const int r = warp + kWarps * j;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) part = fmaf(rs[r * D + d], rs[r * D + d], part);
      }
      part = warp_sum(part);
      if (lane == 0) rrs[r] = part;
    }
  }

  // the staging walk: thread t copies float4 chunks t, t + kThreads, ... of
  // the tile, as (code, chunk) pairs advanced without a division per chunk
  const int step_c = kThreads / q4;
  const int step_q = kThreads % q4;
  const int c_first = threadIdx.x / q4;
  const int q_first = threadIdx.x % q4;

  for (int l = 0; l < L; ++l) {
    const float* cbl = cb + (size_t)l * K * D;
    const float* nl = norms + (size_t)l * K;
    float best[kRowsPerWarp];
    int best_c[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      best[i] = __int_as_float(0x7f800000);  // +inf
      best_c[i] = 0x7fffffff;
    }
    for (int t0 = 0; t0 < K; t0 += tile) {
      __syncthreads();  // the previous tile, or the previous level's update, is done
      for (int c = c_first, q = q_first; c < tile;) {
        const bool valid = t0 + c < K;
        cp_async_f32x4(ts + c * pitch + 4 * q, cbl + (size_t)(valid ? t0 + c : 0) * D + 4 * q,
                       valid ? 16 : 0);
        c += step_c;
        q += step_q;
        if (q >= q4) {
          q -= q4;
          ++c;
        }
      }
      for (int c = threadIdx.x; c < tile; c += kThreads)
        cp_async_f32(cn + c, nl + (t0 + c < K ? t0 + c : 0), t0 + c < K);
      cp_async_wait_all();
      __syncthreads();

      float acc[kRowsPerWarp][kCodesPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < kCodesPerLane; ++j) acc[i][j] = 0.f;
      const float* rsg = rs + rg * kRowsPerWarp * D;
      const float* tsw = ts + (cgi * kCodesPerWarp + lane) * pitch;
#pragma unroll 2
      for (int q = 0; q < q4; ++q) {
        float4 c[kCodesPerLane];
#pragma unroll
        for (int j = 0; j < kCodesPerLane; ++j)
          c[j] = *reinterpret_cast<const float4*>(tsw + 32 * j * pitch + 4 * q);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 r = *reinterpret_cast<const float4*>(rsg + i * D + 4 * q);  // broadcast
#pragma unroll
          for (int j = 0; j < kCodesPerLane; ++j) {
            float a = acc[i][j];
            a = fmaf(r.x, c[j].x, a);
            a = fmaf(r.y, c[j].y, a);
            a = fmaf(r.z, c[j].z, a);
            acc[i][j] = fmaf(r.w, c[j].w, a);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kCodesPerLane; ++j) {
        const int lc = cgi * kCodesPerWarp + lane + 32 * j;
        const int code = t0 + lc;
        if (code < K) {
          const float cnorm = cn[lc];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float dist = (rrs[rg * kRowsPerWarp + i] - 2.f * acc[i][j]) + cnorm;
            if (better(dist, code, best[i], best_c[i])) {
              best[i] = dist;
              best_c[i] = code;
            }
          }
        }
      }
    }

    // argmin over the warp's lanes, then over the code groups
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best[i], off);
        const int oc = __shfl_xor_sync(kFull, best_c[i], off);
        if (better(ob, oc, best[i], best_c[i])) {
          best[i] = ob;
          best_c[i] = oc;
        }
      }
      if (lane == 0) {
        bd[cgi * rows + rg * kRowsPerWarp + i] = best[i];
        bc[cgi * rows + rg * kRowsPerWarp + i] = best_c[i];
      }
    }
    __syncthreads();

    // one warp per row: read the codewords of all the warp's rows first (their
    // loads overlap; from the staged tile when it holds the whole level),
    // then store them and update the residuals
    const bool staged = K <= tile;
    int win[kRowsPerWarp];
    float ev[kRowsPerWarp][kMaxDPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + kWarps * j;
      int c = 0;
      if (j < owned) {
        float b = bd[r];
        c = bc[r];
        for (int g = 1; g < cg_n; ++g) {
          if (better(bd[g * rows + r], bc[g * rows + r], b, c)) {
            b = bd[g * rows + r];
            c = bc[g * rows + r];
          }
        }
        if (c >= K) c = 0;  // every distance NaN: no winner
      }
      win[j] = c;
      const bool live = j < owned && row0 + r < B;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (!live || d >= D)
          ev[j][i] = 0.f;
        else
          ev[j][i] = staged ? ts[c * pitch + d] : cbl[(size_t)c * D + d];
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + kWarps * j;
      const int row = row0 + r;
      if (j >= owned || row >= B) continue;  // warp-uniform
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float rv = rs[r * D + d];
          const float e = ev[j][i];
          const float diff = rv - e;
          part = fmaf(diff, diff, part);
          if (kTrain) {
            out_a[((size_t)l * B + row) * D + d] = rv;
            out_b[((size_t)l * B + row) * D + d] = e;
          } else {
            es[r * D + d] += e;
          }
          rs[r * D + d] = diff;
        }
      }
      part = warp_sum(part);
      loss[j] += loss_scale * part;
      if (lane == 0) {
        rrs[r] = part;  // ||r||^2 of the next level's residual
        ids[(size_t)row * L + l] = win[j];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + kWarps * j;
    const int row = row0 + r;
    if (j >= owned || row >= B) continue;
    if (!kTrain) {
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          out_a[(size_t)row * D + d] = es[r * D + d];
          out_b[(size_t)row * D + d] = rs[r * D + d];
        }
      }
    }
    if (lane == 0) loss_out[row] = loss[j];
  }
}

// Launches the norm pass and the main kernel on ``stream`` of ``device``;
// ``norms`` is (L * K,) fp32 scratch. Returns the CUDA error code (0 = ok).
// Each library links its own CUDA runtime, so the device is set here rather
// than inherited from the caller's runtime.
template <bool kTrain>
static inline int launch(const float* x, const float* cb, float* norms, int32_t* ids,
                         float* out_a, float* out_b, float* loss, int B, int L, int K, int D,
                         float commitment_weight, int device, void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || D > kMaxD || D % 4 != 0 || L <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan_for(K, D);
  // the opt-in shared memory is raised once per device and size, not per call
  static long long raised[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (p.smem > raised[device]) {
    int max_optin = 0;
    err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (p.smem > max_optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(rq_kernel<kTrain>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    raised[device] = p.smem;
  }
  const long long n_codes = (long long)L * K;
  const unsigned norm_blocks = (unsigned)((n_codes + kWarps - 1) / kWarps);
  code_norms_kernel<<<norm_blocks, kThreads, 0, (cudaStream_t)stream>>>(cb, norms, (int)n_codes, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((B + p.rows - 1) / p.rows);
  rq_kernel<kTrain><<<grid, kThreads, (size_t)p.smem, (cudaStream_t)stream>>>(
      x, cb, norms, ids, out_a, out_b, loss, B, L, K, D, p.code_groups, p.pitch,
      1.0f + commitment_weight);
  return (int)cudaGetLastError();
}

}  // namespace rq
