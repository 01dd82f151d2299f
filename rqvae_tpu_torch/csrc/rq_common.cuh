// L-level residual vector quantization, hard argmin: the kernels shared by
// csrc/rq_tokenize.cu (corpus tokenization) and csrc/rq_quantize_train.cu
// (the stage-1 training forward).
//
// Per row and level l (the TPU kernels' arithmetic, fp32):
//   dist_c = (||r||^2 - 2 r.cb_c) + ||cb_c||^2      (the TPU kernels' term order)
//   id     = argmin_c dist_c                         (lowest index on ties, as jnp.argmin)
//   emb    = cb[id];  loss += (1 + beta) ||r - emb||^2;  r -= emb
//
// What bounds it on an H100: 2*B*L*K*D fp32 FMAs (1.07 GFLOP at B = 1024,
// L = 4, K = 2048, D = 64: 16 us at 67 TFLOP/s) against ~4.5 MB of traffic
// (1.3 us at 3.35 TB/s), so fp32 operations; at the flagship's B = 64 x 3 x
// 256 x 32 (3 MFLOP), the launch and the chain of L dependent levels. Shared
// memory is the second limit: a warp's 16-byte load costs the SM four
// cycles (a quarter-warp a cycle) even when every lane reads one address,
// so a lane must do about 4 FMAs per float it loads to keep the FMA pipe
// busy.
//
// One launch a call, of one of two kernels (plan_for picks from the shapes):
//
//   * rq_resident_kernel, when every level's codes fit in one CTA's shared
//     memory (the flagship step, the Amazon corpus chunks): each CTA stages
//     the whole stack and owns a few rows, a warp scores its rows against
//     every code and takes each row's winner by a butterfly over its lanes,
//     with one block barrier a level (after the level's norms) and one
//     before the first wait on the copies' barriers.
//   * rq_cluster_kernel otherwise (the stretch shape): a thread-block cluster
//     of C CTAs (1, 2 or 4) owns 16 or 32 rows and CTA k of it scores the
//     slice [k Ks, (k + 1) Ks) of every level's codes (Ks = ceil(K / C)) in
//     units of R rows x 8 (256 / R) codes, a warp a unit, 8 x 8 a lane. At a
//     level's end the CTAs' (distance, index) minima meet at one cluster
//     barrier and every CTA reads the others' from their shared memory
//     (DSMEM) and applies the same winner. Tiles flow through a ring of
//     stages when the slices do not fit; the last warp done with a stage
//     refills it.
//
// Shared by both:
//   * ||cb||^2 is computed from the staged codes (8-lane groups: lane p sums
//     chunks p, p + 8, ..., then a butterfly over the 8), and each dot
//     product sums D in order: both orders are the same wherever a code
//     sits, so equal codewords get equal distances, and every merge (lanes,
//     warps, CTAs) takes the smaller distance or, on equal ones, the lower
//     index: jnp.argmin's winner whatever order codes are visited in. A row
//     whose every distance is NaN takes code 0.
//   * Staging by TMA copies onto mbarriers that the levels do not wait on:
//     for D a multiple of 32, tensor copies of 64-code boxes of 32 floats in
//     the 128-byte swizzle (16-byte chunk j of code c lands at j ^ (c % 8),
//     so 8 lanes reading one chunk of 8 consecutive codes hit 8 bank groups);
//     else one bulk copy, dense. When the stack fits, every level's copies
//     are issued at the start and only level 0 waits.
//   * Scoring on the fp32 CUDA cores (a single TF32 pass would not keep the
//     ids; a 3xTF32 product was not tried).
//
// D must be a multiple of 4 (the wrapper zero-pads other widths, which
// changes no distance) and at most 128. Any B, L, K >= 1.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (cuTensorMapEncodeTiled is looked up at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "mbarrier.cuh"

namespace rq {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBoxCodes = 64;            // codes of a tensor-copy box
// a warp's unit: R rows (16 or 32, a cluster's) x unit_codes(R) codes, 8 x 8 a lane
__host__ __device__ constexpr int unit_codes(int R) { return 8 * (256 / R); }
constexpr int kMaxD = 128;
constexpr int kMaxPasses = 4;            // row chunks a thread applies: ceil(next_pow2(D / 4) / 8)
constexpr int kMaxCluster = 4;
constexpr int kMaxStages = 8;
constexpr int kSlack = 1024;             // to align the ring to 1024 bytes (the swizzle's period)
constexpr unsigned kFull = 0xffffffffu;
// the launcher's own error: the plan's cluster cannot be resident on the device
constexpr int kErrClusterUnschedulable = 10001;

// How a launch lays out its CTAs for B rows and an (L, K, D) stack.
struct Plan {
  int resident;     // 1: rq_resident_kernel (the whole stack staged in each CTA)
  int rows;         // R: rows a CTA owns (resident: 8 or 32) or a cluster (16 or 32)
  int cluster;      // C: CTAs a cluster, each a slice of every level's codes
  int slice;        // Ks: codes of a level a CTA scores, ceil(K / C)
  int tile;         // codes a stage holds (a multiple of unit_codes(R))
  int tiles;        // tiles a level's slice
  int stages;       // ring stages (all L * tiles when they fit)
  int swizzled;     // 1: tensor copies in the 128-byte swizzle (D % 32 == 0)
  long long smem;   // dynamic shared memory a CTA, bytes
  long long grid;   // CTAs: ceil(B / R) * C
};

// Shared memory besides the ring: rows, ||r||^2, per-warp minima, the
// cluster's candidates (two levels), the winners, per-warp norms, the
// stages' barriers and counters.
inline long long fixed_smem(int D, int R) {
  return kSlack + 4LL * (R * D + R + 2 * kWarps * R + 4 * R + R + kWarps * unit_codes(R)) +
         12LL * kMaxStages;
}

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The plan for R rows and C CTAs a cluster within ``optin`` bytes of shared
// memory a CTA.
inline Plan plan_with(int B, int L, int K, int D, int R, int C, long long optin) {
  Plan p;
  p.resident = 0;
  p.rows = R;
  p.cluster = C;
  p.swizzled = D % 32 == 0;
  p.slice = (K + C - 1) / C;
  const int unit = unit_codes(R);
  const long long budget = optin - fixed_smem(D, R);
  const long long code_bytes = 4LL * D;
  const int whole = round_up(p.slice, unit);
  if ((long long)L * whole * code_bytes <= budget) {
    p.tile = whole;  // every level's slice resident at once
    p.tiles = 1;
  } else {
    // three stages of the largest tile, cut so that a slice splits evenly
    const int tmax = (int)(budget / (3 * code_bytes)) / unit * unit;
    p.tiles = (p.slice + tmax - 1) / tmax;
    p.tile = round_up((p.slice + p.tiles - 1) / p.tiles, unit);
  }
  long long stages = (long long)L * p.tiles;
  const long long fit = budget / ((long long)p.tile * code_bytes);
  if (stages > fit) stages = fit;
  if (stages > kMaxStages) stages = kMaxStages;
  p.stages = (int)stages;
  p.smem = fixed_smem(D, R) + (long long)p.stages * p.tile * code_bytes;
  p.grid = (long long)((B + R - 1) / R) * C;
  return p;
}

// The resident kernel's codes staged a level: K, rounded up to the 64-code
// boxes of the swizzled copies.
inline int resident_codes(int K, int D) { return D % 32 == 0 ? round_up(K, kBoxCodes) : K; }

// Shared memory of the resident kernel: the L levels' codes and norms, the
// rows, the barriers.
inline long long resident_smem(int L, int K, int D, int R) {
  const long long kp = resident_codes(K, D);
  return kSlack + 4LL * ((long long)L * kp * D + round_up(L * (int)kp, 4) + (long long)R * D) +
         8LL * kMaxStages;
}

// The plan of the resident kernel: R rows a CTA (8: 4 warps of 2; 32: 8
// warps of 4), no cluster.
inline Plan plan_resident(int B, int L, int K, int D, int R) {
  Plan p;
  p.resident = 1;
  p.rows = R;
  p.cluster = 1;
  p.slice = K;
  p.tile = resident_codes(K, D);
  p.tiles = 1;
  p.stages = L;
  p.swizzled = D % 32 == 0;
  p.smem = resident_smem(L, K, D, R);
  p.grid = (B + R - 1) / R;
  return p;
}

// The automatic plan on a device of ``sms`` SMs. When every level's codes
// fit in one CTA's shared memory (at most kMaxStages levels), the resident
// kernel: 32 rows a CTA where that gives three quarters of the SMs a CTA,
// else 8. Otherwise the cluster kernel, with the most CTAs that run
// in one wave, one CTA an SM (a CTA takes ~250 registers a thread): R rows
// (32, else 16) and C CTAs (1, 2 or 4) a cluster, each CTA at least one
// whole unit of codes. Clusters of 4 CTAs of ~200 KB cover at most 7/8 of
// an H100's SMs at once (cudaOccupancyMaxActiveClusters: 30 of them on its
// 132 SMs), so a plan of 4 keeps its grid under that. At equal grids the
// larger R and the smaller C win; with no plan in one wave, R = 32, C = 1.
inline Plan plan_for(int B, int L, int K, int D, int sms, long long optin) {
  if (L <= kMaxStages && resident_smem(L, K, D, 32) <= optin)
    return plan_resident(B, L, K, D, (long long)((B + 31) / 32) >= (3LL * sms) / 4 ? 32 : 8);
  int best_r = 32, best_c = 1;
  long long best_grid = 0;
  for (int R = 32; R >= 16; R /= 2)
    for (int C = 1; C <= kMaxCluster; C *= 2) {
      const long long grid = (long long)((B + R - 1) / R) * C;
      const long long cap = C == 4 ? (7LL * sms) / 8 : sms;
      if ((K + C - 1) / C < unit_codes(R) && C > 1) continue;
      if (grid > cap || grid <= best_grid) continue;
      best_grid = grid;
      best_r = R;
      best_c = C;
    }
  return plan_with(B, L, K, D, best_r, best_c, optin);
}

// ---- device side ----

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// (d, c) beats (bd, bc): smaller distance, or the lower code on a tie
__device__ __forceinline__ bool better(float d, int c, float bd, int bc) {
  return d < bd || (d == bd && c < bc);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// every thread of every CTA of the cluster: writes to shared memory before
// it are seen by reads (also from other CTAs) after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the (distance, code) pair at ``p`` in the shared memory of cluster CTA ``rank``
__device__ __forceinline__ float2 load_remote(const float2* p, unsigned rank) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(hopper::smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
// the float4 at ``p`` in the shared memory of cluster CTA ``rank``
__device__ __forceinline__ float4 load_remote4(const float* p, unsigned rank) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(hopper::smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
// A 64-code box (32 floats a code) of ``map`` at (chunk group ``sub``, code
// ``code``) into dst (1024-byte aligned) in the 128-byte swizzle, counted on bar.
__device__ __forceinline__ void box_copy(float* dst, const CUtensorMap* map, int sub, int code,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4}], [%5];\n" ::"r"(hopper::smem_u32(dst)),
      "l"(map), "r"(0), "r"(sub), "r"(code), "r"(hopper::smem_u32(bar))
      : "memory");
}
// the first float of logical chunk q of staged code c (tile: T codes a stage)
template <bool kSwz>
__device__ __forceinline__ const float* code_at(const float* stage, int T, int D, int c, int q) {
  if (kSwz) return stage + (q >> 3) * T * 32 + c * 32 + 4 * ((q & 7) ^ (c & 7));
  return stage + c * D + 4 * q;
}

// One unit: the kR rows against codes cb0 .. cb0 + unit_codes(kR) - 1 of the
// stage (the slice's codes code0 + ..; those at or past n_valid are staged
// but not the slice's), folded into the lane's running minima of its 8 rows.
// Lane i holds rows 8 (i / G) .. + 7 and codes i % G + G b (b < 8), G =
// 256 / kR; a quarter-warp's 8 lanes share its rows and hold codes 8 apart
// from each other's by one.
template <bool kSwz, int kR>
__device__ __forceinline__ void score_unit(const float* stage, int T, int D, int q4,
                                           const float* rs, float* cn, int lane, int cb0,
                                           int n_valid, int code0, const float (&rr)[8],
                                           float (&best)[8], int (&best_c)[8]) {
  constexpr int G = 256 / kR, UC = unit_codes(kR);
  // the unit's norms: lanes 8 jj .. 8 jj + 7 share codes 4 k + jj, lane p
  // of them sums chunks p, p + 8, ..., then a butterfly over the 8; the
  // codes' loads and shuffles are in flight together
  {
    const int jj = lane >> 3, p = lane & 7;
    float s[UC / 4];
#pragma unroll
    for (int k = 0; k < UC / 4; ++k) s[k] = 0.f;
    for (int q = p; q < q4; q += 8) {
#pragma unroll
      for (int k = 0; k < UC / 4; ++k) {
        const float4 v = ld4(code_at<kSwz>(stage, T, D, cb0 + 4 * k + jj, q));
        s[k] = fmaf(v.x, v.x, s[k]);
        s[k] = fmaf(v.y, v.y, s[k]);
        s[k] = fmaf(v.z, v.z, s[k]);
        s[k] = fmaf(v.w, v.w, s[k]);
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
#pragma unroll
      for (int k = 0; k < UC / 4; ++k) s[k] += __shfl_xor_sync(kFull, s[k], off);
    if (p == 0)
#pragma unroll
      for (int k = 0; k < UC / 4; ++k) cn[4 * k + jj] = s[k];
    __syncwarp();
  }
  const int rg = lane / G, cg = lane % G;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  const float* rp = rs + rg * 8 * D;
  for (int q = 0; q < q4; ++q) {
    float4 rv[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) rv[a] = ld4(rp + a * D + 4 * q);  // a quarter-warp: one address
    // code cg + G b is G b staged rows past code cg, in the same swizzle phase
    const float* cq = code_at<kSwz>(stage, T, D, cb0 + cg, q);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float4 c = ld4(cq + b * G * (kSwz ? 32 : D));
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        float v = acc[a][b];
        v = fmaf(rv[a].x, c.x, v);
        v = fmaf(rv[a].y, c.y, v);
        v = fmaf(rv[a].z, c.z, v);
        acc[a][b] = fmaf(rv[a].w, c.w, v);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int j = cg + G * b;
    const float cnorm = cn[j];
    if (j < n_valid) {
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float dist = (rr[a] - 2.f * acc[a][b]) + cnorm;
        if (better(dist, code0 + j, best[a], best_c[a])) {
          best[a] = dist;
          best_c[a] = code0 + j;
        }
      }
    }
  }
  __syncwarp();  // cn is the next unit's
}

// Sum over the lanes of a group of Q (a power of two <= 32, aligned).
__device__ __forceinline__ float group_sum(float v, int Q) {
  for (int off = Q >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// kTrain: out_a = pre-level residuals (L, B, D), out_b = codewords (L, B, D).
// else:   out_a = codeword sum (B, D),          out_b = final residual (B, D).
// kSwz: codes staged by tensor copies of ``map`` in the 128-byte swizzle.
template <bool kTrain, bool kSwz, int kR>
__global__ void __launch_bounds__(kThreads, 1)
rq_cluster_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ x,
                  const float* __restrict__ cb, int32_t* __restrict__ ids,
                  float* __restrict__ out_a, float* __restrict__ out_b,
                  float* __restrict__ loss_out, int B, int L, int K, int D, int slice, int tile,
                  int tiles, int stages, float loss_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((kSlack - (hopper::smem_u32(smem_raw) & (kSlack - 1))) & (kSlack - 1)));
  constexpr int G = 256 / kR, UC = unit_codes(kR);
  float* rs = ring + (size_t)stages * tile * D;                       // [kR][D]
  float* rrs = rs + kR * D;                                           // [kR] ||r||^2
  float* wbest = rrs + kR;                                            // [kWarps][kR]
  int* wcode = reinterpret_cast<int*>(wbest + kWarps * kR);           // [kWarps][kR]
  float2* cand = reinterpret_cast<float2*>(wcode + kWarps * kR);      // [2][kR]
  int* win = reinterpret_cast<int*>(cand + 2 * kR);                   // [kR]
  float* cn = reinterpret_cast<float*>(win + kR);                     // [kWarps][UC]
  uint64_t* full = reinterpret_cast<uint64_t*>(cn + kWarps * UC);     // [kMaxStages]
  int* done = reinterpret_cast<int*>(full + kMaxStages);              // [kMaxStages]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned rank = cluster_rank();
  const unsigned n_ranks = cluster_size();
  const int row0 = (int)(blockIdx.x / n_ranks) * kR;
  const int k_lo = (int)rank * slice;
  const int k_n = max(0, min(slice, K - k_lo));  // codes of a level this CTA scores
  const int total = L * tiles;
  const int q4 = D / 4;
  const int units_per_tile = tile / UC;
  const bool resident = total <= stages;  // level l's slice stays in stage l

  // tile g = (level g / tiles, tile g % tiles of the slice) into stage g % stages
  auto issue = [&](int g) {
    const int l = g / tiles, t = g - l * tiles, s = g % stages;
    const int n = min(tile, k_n - t * tile);
    float* dst = ring + (size_t)s * tile * D;
    const int first = l * K + k_lo + t * tile;
    if (n <= 0) {
      hopper::mbar_arrive(full + s);
    } else if (kSwz) {
      const int boxes = (n + kBoxCodes - 1) / kBoxCodes;
      hopper::mbar_expect(full + s, (unsigned)(boxes * kBoxCodes * D * 4));
      for (int sub = 0; sub < D / 32; ++sub)
        for (int bx = 0; bx < boxes; ++bx)
          box_copy(dst + (sub * tile + bx * kBoxCodes) * 32, &map, sub, first + bx * kBoxCodes,
                   full + s);
    } else {
      const unsigned bytes = (unsigned)n * D * 4u;
      hopper::mbar_expect(full + s, bytes);
      hopper::bulk_copy(dst, cb + (size_t)first * D, bytes, full + s);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      hopper::mbar_init(full + s, 1);
      done[s] = 0;
    }
    hopper::fence_mbar_init();
    for (int g = 0; g < stages; ++g) issue(g);  // every level's, when they fit
  }

  // A thread applies 16-byte chunk ``lane % Q`` of rows
  // p * 8 * (32 / Q) + warp * (32 / Q) + lane / Q, p < passes (Q: the chunks
  // of a row, rounded up to a power of two).
  int Q = 1;
  while (Q < q4) Q <<= 1;
  const int rpw = 32 / Q;
  const int passes = (kR + kWarps * rpw - 1) / (kWarps * rpw);
  const int ch = lane % Q;
  float loss[kMaxPasses];
  float4 es[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    loss[p] = 0.f;
    es[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p >= passes) continue;
    const int r = p * kWarps * rpw + warp * rpw + lane / Q;
    const bool active = r < kR && ch < q4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active && row0 + r < B) v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * D) + ch);
    if (active) *reinterpret_cast<float4*>(rs + r * D + 4 * ch) = v;
    float part = fmaf(v.x, v.x, 0.f);
    part = fmaf(v.y, v.y, part);
    part = fmaf(v.z, v.z, part);
    part = fmaf(v.w, v.w, part);
    part = group_sum(part, Q);
    if (active && ch == 0) rrs[r] = part;
  }
  __syncthreads();

  float* cnw = cn + warp * UC;
  for (int l = 0; l < L; ++l) {
    float best[8], rr[8];
    int best_c[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      best[a] = __int_as_float(0x7f800000);  // +inf
      best_c[a] = 0x7fffffff;
      rr[a] = rrs[(lane / G) * 8 + a];
    }
    for (int t = 0; t < tiles; ++t) {
      const int g = l * tiles + t, s = g % stages;
      const int n_t = min(tile, k_n - t * tile);
      const int n_units = n_t > 0 ? (n_t + UC - 1) / UC : 0;
      hopper::mbar_wait(full + s, (unsigned)(g / stages) & 1u);
      const float* st = ring + (size_t)s * tile * D;
      // the level's units are dealt to the warps in turn: unit i to warp i % 8
      const int first = t * units_per_tile;
      for (int u = (warp - first % kWarps + kWarps) % kWarps; u < n_units; u += kWarps)
        score_unit<kSwz, kR>(st, tile, D, q4, rs, cnw, lane, u * UC, n_t - u * UC,
                             k_lo + t * tile + u * UC, rr, best, best_c);
      if (g + stages < total && lane == 0) {
        // the last warp done with the stage refills it
        __threadfence_block();
        if (atomicAdd(done + s, 1) == kWarps - 1) {
          done[s] = 0;
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(g + stages);
        }
      }
    }

    // the level's winner: over the 8 lanes of a row group, the warps, then
    // the cluster's CTAs
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float ob = __shfl_xor_sync(kFull, best[a], off);
        const int oc = __shfl_xor_sync(kFull, best_c[a], off);
        if (better(ob, oc, best[a], best_c[a])) {
          best[a] = ob;
          best_c[a] = oc;
        }
      }
    if (lane % G == 0)
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        wbest[warp * kR + (lane / G) * 8 + a] = best[a];
        wcode[warp * kR + (lane / G) * 8 + a] = best_c[a];
      }
    __syncthreads();
    float2* cl = cand + (l & 1) * kR;  // two buffers: one cluster barrier a level
    if (tid < kR) {
      float b = wbest[tid];
      int c = wcode[tid];
      for (int w = 1; w < kWarps; ++w)
        if (better(wbest[w * kR + tid], wcode[w * kR + tid], b, c)) {
          b = wbest[w * kR + tid];
          c = wcode[w * kR + tid];
        }
      cl[tid] = make_float2(b, __int_as_float(c));
    }
    cluster_sync();
    if (tid < kR) {
      float b = __int_as_float(0x7f800000);
      int c = 0x7fffffff;
      for (unsigned k = 0; k < n_ranks; ++k) {
        const float2 v = load_remote(cl + tid, k);
        if (better(v.x, __float_as_int(v.y), b, c)) {
          b = v.x;
          c = __float_as_int(v.y);
        }
      }
      win[tid] = c >= K ? 0 : c;  // every distance NaN: no winner, code 0
    }
    __syncthreads();

    // apply it, a chunk a thread; the codewords are read first, so their
    // loads overlap: from the stage of the CTA whose slice holds the winner
    // when every level is resident (its own, or another's by DSMEM), else
    // from global memory
    const float* cbl = cb + (size_t)l * K * D;
    float4 ev[kMaxPasses];
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      ev[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int r = p * kWarps * rpw + warp * rpw + lane / Q;
      if (p < passes && r < kR && ch < q4 && row0 + r < B) {
        const int c = win[r];
        if (resident) {
          const unsigned owner = (unsigned)(c / slice);
          const int local = c - (int)owner * slice;  // in stage l * tiles + local / tile
          const float* at = code_at<kSwz>(ring + (size_t)(l * tiles + local / tile) * tile * D,
                                          tile, D, local % tile, ch);
          ev[p] = owner == rank ? ld4(at) : load_remote4(at, owner);
        } else {
          ev[p] = __ldg(reinterpret_cast<const float4*>(cbl + (size_t)c * D) + ch);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p >= passes) continue;  // warp-uniform
      const int r = p * kWarps * rpw + warp * rpw + lane / Q;
      const int row = row0 + r;
      const bool active = r < kR && ch < q4;
      const bool mine = active && row < B && r % (int)n_ranks == (int)rank;  // this CTA stores it
      float part = 0.f;
      if (active) {
        const float4 rv = ld4(rs + r * D + 4 * ch);
        const float4 e = ev[p];
        const float4 diff = make_float4(rv.x - e.x, rv.y - e.y, rv.z - e.z, rv.w - e.w);
        part = fmaf(diff.x, diff.x, part);
        part = fmaf(diff.y, diff.y, part);
        part = fmaf(diff.z, diff.z, part);
        part = fmaf(diff.w, diff.w, part);
        if (kTrain) {
          if (mine) {
            reinterpret_cast<float4*>(out_a + ((size_t)l * B + row) * D)[ch] = rv;
            reinterpret_cast<float4*>(out_b + ((size_t)l * B + row) * D)[ch] = e;
          }
        } else {
          es[p] = make_float4(es[p].x + e.x, es[p].y + e.y, es[p].z + e.z, es[p].w + e.w);
        }
        *reinterpret_cast<float4*>(rs + r * D + 4 * ch) = diff;
      }
      part = group_sum(part, Q);
      if (active && ch == 0) {
        loss[p] += loss_scale * part;
        rrs[r] = part;  // ||r||^2 of the next level's residual
        if (mine) ids[(size_t)row * L + l] = win[r];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    const int r = p * kWarps * rpw + warp * rpw + lane / Q;
    const int row = row0 + r;
    if (p >= passes || r >= kR || ch >= q4 || row >= B || r % (int)n_ranks != (int)rank)
      continue;
    if (!kTrain) {
      reinterpret_cast<float4*>(out_a + (size_t)row * D)[ch] = es[p];
      reinterpret_cast<float4*>(out_b + (size_t)row * D)[ch] = ld4(rs + r * D + 4 * ch);
    }
    if (ch == 0) loss_out[row] = loss[p];
  }
  cluster_sync();  // no CTA leaves while another may still read its candidates
}

// The resident kernel: each CTA of kW warps stages every level's codes once
// (level l's copies waited for only at level l) and owns R = kW kRW rows,
// kRW a warp. A warp scores its rows against every code of a level (lane
// j: codes j + 32 i, 256 a block, kRW x 8 a lane), takes each row's winner
// by a butterfly over its lanes and applies it, lanes over D: no block
// barrier but one a level, after the level's norms (8-lane groups, as in
// the cluster kernel), and one after the rows are staged, which every
// warp's first wait needs (the barriers are armed by warp 0). For stacks that fit in shared memory (the flagship,
// the Amazon corpus chunks), where the cluster kernel's merges and barriers
// would be the level's critical path. Two shapes: 8 warps of 4 rows (32
// rows a CTA) for a large B, where two warps a scheduler hide the shared
// loads' latency (8 rows a warp, one warp a scheduler, ran slower on an
// H100); 4 warps of 2 rows (8 rows a CTA) for a small B, spread over more
// SMs, whose shared memory bandwidth (a warp's 16-byte load is four of the
// SM's cycles) bounds the scoring.
template <bool kTrain, bool kSwz, int kRW, int kW>
__global__ void __launch_bounds__(kW * 32, 1)
rq_resident_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ x,
                   const float* __restrict__ cb, int32_t* __restrict__ ids,
                   float* __restrict__ out_a, float* __restrict__ out_b,
                   float* __restrict__ loss_out, int B, int L, int K, int D, int Kp,
                   float loss_scale) {
  constexpr int R = kW * kRW;
  constexpr int NB = 8;  // codes a lane a block: 32 NB = 256 a block
  constexpr int ND = kMaxD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stack = reinterpret_cast<float*>(
      smem_raw + ((kSlack - (hopper::smem_u32(smem_raw) & (kSlack - 1))) & (kSlack - 1)));
  const size_t level_floats = (size_t)Kp * D;
  float* cn = stack + (size_t)L * level_floats;                    // [L][Kp]
  float* rs = cn + round_up(L * Kp, 4);                             // [R][D]
  uint64_t* full = reinterpret_cast<uint64_t*>(rs + R * D);         // [L]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q4 = D / 4;
  const int nd = (D + 31) / 32;  // values a lane when lanes run over D
  const int row0 = blockIdx.x * R;

  if (warp == 0) {
    // lane 0 arms the barriers, then the warp's lanes issue the copies
    // together, a box (or a level's bulk copy) a lane
    if (lane == 0) {
      for (int l = 0; l < L; ++l) hopper::mbar_init(full + l, 1);
      hopper::fence_mbar_init();
      for (int l = 0; l < L; ++l) hopper::mbar_expect(full + l, (unsigned)((kSwz ? Kp : K) * D * 4));
    }
    __syncwarp();
    if (kSwz) {
      const int boxes = Kp / kBoxCodes, per_level = boxes * (D / 32);
      for (int j = lane; j < L * per_level; j += 32) {
        const int l = j / per_level, sub = (j % per_level) / boxes, bx = j % boxes;
        box_copy(stack + l * level_floats + (sub * Kp + bx * kBoxCodes) * 32, &map, sub,
                 l * K + bx * kBoxCodes, full + l);
      }
    } else {
      for (int l = lane; l < L; l += 32)
        hopper::bulk_copy(stack + l * level_floats, cb + (size_t)l * K * D, (unsigned)(K * D * 4),
                          full + l);
    }
  }

  // the warp's rows, lanes over D, and their ||r||^2 (the same in every lane)
  float rr[kRW], loss[kRW];
  float es[kRW][ND];
  {
    float v[kRW][ND];
#pragma unroll
    for (int a = 0; a < kRW; ++a)
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i, row = row0 + warp * kRW + a;
        v[a][i] = i < nd && d < D && row < B ? __ldg(x + (size_t)row * D + d) : 0.f;
      }
#pragma unroll
    for (int a = 0; a < kRW; ++a) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        es[a][i] = 0.f;
        if (i < nd && d < D) rs[(warp * kRW + a) * D + d] = v[a][i];
        part = fmaf(v[a][i], v[a][i], part);
      }
      rr[a] = part;
      loss[a] = 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int a = 0; a < kRW; ++a) rr[a] += __shfl_xor_sync(kFull, rr[a], off);
  }
  // the barriers' init is seen by every warp before its first wait (warp 0's
  // copies and every warp's row loads are already in flight)
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const float* st = stack + l * level_floats;
    float* cnl = cn + (size_t)l * Kp;
    hopper::mbar_wait(full + l, 0);
    // the level's norms: 8-lane group g of the CTA sums codes c0 + 16 j + g
    // (j < 8), lane p of it chunks p, p + 8, ..., then a butterfly over the 8
    {
      constexpr int G = kW * 32 / 8, U = 8;
      const int g = tid >> 3, p = tid & 7;
      for (int c0 = 0; c0 < K; c0 += G * U) {
        float sq[U];
#pragma unroll
        for (int j = 0; j < U; ++j) sq[j] = 0.f;
        for (int q = p; q < q4; q += 8)
#pragma unroll
          for (int j = 0; j < U; ++j) {
            const int c = min(c0 + G * j + g, K - 1);
            const float4 w = ld4(code_at<kSwz>(st, Kp, D, c, q));
            sq[j] = fmaf(w.x, w.x, sq[j]);
            sq[j] = fmaf(w.y, w.y, sq[j]);
            sq[j] = fmaf(w.z, w.z, sq[j]);
            sq[j] = fmaf(w.w, w.w, sq[j]);
          }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
#pragma unroll
          for (int j = 0; j < U; ++j) sq[j] += __shfl_xor_sync(kFull, sq[j], off);
#pragma unroll
        for (int j = 0; j < U; ++j)
          if (p == 0 && c0 + G * j + g < K) cnl[c0 + G * j + g] = sq[j];
      }
    }
    __syncthreads();

    float best[kRW];
    int best_c[kRW];
#pragma unroll
    for (int a = 0; a < kRW; ++a) {
      best[a] = __int_as_float(0x7f800000);  // +inf
      best_c[a] = 0x7fffffff;
    }
    const float* rw = rs + warp * kRW * D;
    // the swizzle phase of every code of the lane (j + 32 i, and the staged
    // rows that stand in for codes past K) is lane % 8, so chunk q of each of
    // them is at its staged row plus one offset
    for (int blk = 0; blk < K; blk += 32 * NB) {
      const float* cp[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        int c = blk + lane + 32 * i;
        if (kSwz) {
          if (c >= Kp) c -= round_up(c - Kp + 1, kBoxCodes);  // a staged row, same phase
          cp[i] = st + c * 32;
        } else {
          cp[i] = st + min(c, K - 1) * D;
        }
      }
      float acc[kRW][NB];
#pragma unroll
      for (int a = 0; a < kRW; ++a)
#pragma unroll
        for (int i = 0; i < NB; ++i) acc[a][i] = 0.f;
      for (int q = 0; q < q4; ++q) {
        float4 rv[kRW];
#pragma unroll
        for (int a = 0; a < kRW; ++a) rv[a] = ld4(rw + a * D + 4 * q);  // one address a warp
        const int qoff = kSwz ? (q >> 3) * Kp * 32 + 4 * ((q & 7) ^ (lane & 7)) : 4 * q;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float4 c = ld4(cp[i] + qoff);
#pragma unroll
          for (int a = 0; a < kRW; ++a) {
            float v = acc[a][i];
            v = fmaf(rv[a].x, c.x, v);
            v = fmaf(rv[a].y, c.y, v);
            v = fmaf(rv[a].z, c.z, v);
            acc[a][i] = fmaf(rv[a].w, c.w, v);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int code = blk + lane + 32 * i;
        if (code < K) {
          const float cnorm = cnl[code];
#pragma unroll
          for (int a = 0; a < kRW; ++a) {
            const float dist = (rr[a] - 2.f * acc[a][i]) + cnorm;
            if (better(dist, code, best[a], best_c[a])) {
              best[a] = dist;
              best_c[a] = code;
            }
          }
        }
      }
    }
    // each row's winner over the warp's lanes, then applied, lanes over D:
    // every row's codeword and residual read first, then written
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int a = 0; a < kRW; ++a) {
        const float ob = __shfl_xor_sync(kFull, best[a], off);
        const int oc = __shfl_xor_sync(kFull, best_c[a], off);
        if (better(ob, oc, best[a], best_c[a])) {
          best[a] = ob;
          best_c[a] = oc;
        }
      }
    float ev[kRW][ND], rv[kRW][ND];
#pragma unroll
    for (int a = 0; a < kRW; ++a) {
      best_c[a] = best_c[a] >= K ? 0 : best_c[a];  // every distance NaN: code 0
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        const bool in = i < nd && d < D;
        ev[a][i] = in ? *(code_at<kSwz>(st, Kp, D, best_c[a], d >> 2) + (d & 3)) : 0.f;
        rv[a][i] = in ? rs[(warp * kRW + a) * D + d] : 0.f;
      }
    }
#pragma unroll
    for (int a = 0; a < kRW; ++a) {
      const int row = row0 + warp * kRW + a;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        const float diff = rv[a][i] - ev[a][i];
        part = fmaf(diff, diff, part);
        if (i < nd && d < D) {
          if (kTrain) {
            if (row < B) {
              out_a[((size_t)l * B + row) * D + d] = rv[a][i];
              out_b[((size_t)l * B + row) * D + d] = ev[a][i];
            }
          } else {
            es[a][i] += ev[a][i];
          }
          rs[(warp * kRW + a) * D + d] = diff;
        }
      }
      rr[a] = part;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int a = 0; a < kRW; ++a) rr[a] += __shfl_xor_sync(kFull, rr[a], off);
#pragma unroll
    for (int a = 0; a < kRW; ++a) {
      const int row = row0 + warp * kRW + a;
      loss[a] += loss_scale * rr[a];
      if (lane == 0 && row < B) ids[(size_t)row * L + l] = best_c[a];
    }
    __syncwarp();
  }

#pragma unroll
  for (int a = 0; a < kRW; ++a) {
    const int r = warp * kRW + a;
    const int row = row0 + r;
    if (row >= B) continue;
    if (!kTrain) {
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        if (i < nd && d < D) {
          out_a[(size_t)row * D + d] = es[a][i];
          out_b[(size_t)row * D + d] = rs[r * D + d];
        }
      }
    }
    if (lane == 0) loss_out[row] = loss[a];
  }
}

// ---- host side: the launch state, kept per library ----
//
// Each library (one .cu) has its own copy of this state: an unnamed
// namespace gives it internal linkage. A function-local static of an inline
// function or template would not do: g++ gives it STB_GNU_UNIQUE binding,
// and two libraries loaded in one process (a parent build beside a changed
// one) would share it.
namespace {

struct KernelState {
  const void* fn;
  int device;
  long long raised;     // the dynamic shared memory opt-in set so far
  int cluster;          // the last residency query: cluster size, bytes,
  long long smem;
  int clusters;         // and its answer (clusters resident at once)
};
constexpr int kMaxKernels = 16;
constexpr int kMaxDevices = 64;
KernelState g_kernels[kMaxKernels];
int g_n_kernels = 0;
int g_sms[kMaxDevices];      // 0: not read yet
int g_optin[kMaxDevices];
std::mutex g_mutex;          // ctypes drops the GIL around a launch

// cuTensorMapEncodeTiled, looked up once through the runtime (the library
// links only the CUDA runtime)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled g_encode = nullptr;

KernelState* kernel_state(const void* fn, int device) {
  for (int i = 0; i < g_n_kernels; ++i)
    if (g_kernels[i].fn == fn && g_kernels[i].device == device) return &g_kernels[i];
  if (g_n_kernels == kMaxKernels) return nullptr;
  g_kernels[g_n_kernels] = {fn, device, 0, 0, 0, 0};
  return &g_kernels[g_n_kernels++];
}

// SMs and opt-in shared memory of ``device``, read once
cudaError_t device_limits(int device, int* sms, long long* optin) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_sms[device] == 0) {
    int s = 0, o = 0;
    cudaError_t err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    g_sms[device] = s;
    g_optin[device] = o;
  }
  *sms = g_sms[device];
  *optin = g_optin[device];
  return cudaSuccess;
}

// The (L K, D) fp32 stack as a tensor map of 64-code boxes of 32 floats,
// copied in the 128-byte swizzle (D a multiple of 32).
cudaError_t codes_map(CUtensorMap* map, const float* cb, long long n_codes, int D) {
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    if (g_encode == nullptr) {
      void* fn = nullptr;
      cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
      cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                         cudaEnableDefault, &found);
#else
      cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                                &found);
#endif
      if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
        return cudaErrorNotSupported;
      g_encode = (EncodeTiled)fn;
    }
  }
  const cuuint64_t dims[3] = {32, (cuuint64_t)(D / 32), (cuuint64_t)n_codes};
  const cuuint64_t strides[2] = {128, (cuuint64_t)D * 4};
  const cuuint32_t box[3] = {32, 1, (cuuint32_t)kBoxCodes};
  const cuuint32_t unit_strides[3] = {1, 1, 1};
  const CUresult r = g_encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(cb),
                              dims, strides, box, unit_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaLaunchConfig_t launch_config(const Plan& p, cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.grid, 1, 1);
  cfg.blockDim = dim3(p.resident && p.rows == 8 ? 128 : kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.resident ? 0 : 1;
  return cfg;
}

// Raise the kernel's opt-in on its first launch that needs it, and ask once
// per (cluster size, bytes) how many such clusters can be resident: 0 is the
// launcher's error, raised, not worked around.
template <typename Kernel>
int ready(Kernel kernel, const Plan& p, int device, int* clusters) {
  std::lock_guard<std::mutex> lock(g_mutex);
  KernelState* st = kernel_state((const void*)kernel, device);
  if (st == nullptr) return (int)cudaErrorInvalidValue;
  if (st->raised < p.smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    st->raised = p.smem;
  }
  if (st->cluster != p.cluster || st->smem != p.smem) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(p, attr, nullptr);
    int n = 0;
    cudaError_t err;
    if (p.resident) {  // CTAs resident at once
      int sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, p.rows == 8 ? 128 : kThreads,
                                                          (size_t)p.smem);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      n *= sms;
    } else {
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    }
    if (err != cudaSuccess) return (int)err;
    st->cluster = p.cluster;
    st->smem = p.smem;
    st->clusters = n;
  }
  *clusters = st->clusters;
  return st->clusters > 0 ? 0 : kErrClusterUnschedulable;
}

inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur == device) return cudaSuccess;
  return cudaSetDevice(device);
}

// The plan of a call: plan_for's. A build with -DRQ_FORCE_ROWS=R
// -DRQ_FORCE_CLUSTER=C (R 16 or 32 rows, C 1, 2 or 4 CTAs a cluster) takes
// the cluster kernel's plan_with(R, C) instead, for experiments/torch_rq_ab.py's
// sweep of plans.
int make_plan(int B, int L, int K, int D, int device, Plan* p) {
  if (D <= 0 || D > kMaxD || D % 4 != 0 || L <= 0 || K <= 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  long long optin = 0;
  cudaError_t err = device_limits(device, &sms, &optin);
  if (err != cudaSuccess) return (int)err;
#ifdef RQ_FORCE_ROWS
  *p = plan_with(B, L, K, D, RQ_FORCE_ROWS, RQ_FORCE_CLUSTER, optin);
#else
  *p = plan_for(B, L, K, D, sms, optin);
#endif
  if (p->smem > optin) return (int)cudaErrorInvalidValue;
  return 0;
}

// One launch of ``kernel`` (either kernel: the same parameters up to the
// plan's), its opt-in raised and residency asked first.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, const Plan& p, int device, cudaStream_t stream, Args... args) {
  int clusters = 0;
  const int err = ready(kernel, p, device, &clusters);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p, attr, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool kTrain, bool kSwz>
int launch_plan(const Plan& p, const float* x, const float* cb, int32_t* ids, float* out_a,
                float* out_b, float* loss, int B, int L, int K, int D, float commitment_weight,
                int device, cudaStream_t stream) {
  CUtensorMap map = {};
  if (kSwz) {
    const cudaError_t e = codes_map(&map, cb, (long long)L * K, D);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f + commitment_weight;
  if (p.resident) {
    if (p.rows == 8)
      return launch_kernel(rq_resident_kernel<kTrain, kSwz, 2, 4>, p, device, stream, map, x, cb,
                           ids, out_a, out_b, loss, B, L, K, D, p.tile, scale);
    return launch_kernel(rq_resident_kernel<kTrain, kSwz, 4, 8>, p, device, stream, map, x, cb, ids,
                         out_a, out_b, loss, B, L, K, D, p.tile, scale);
  }
  if (p.rows == 16)
    return launch_kernel(rq_cluster_kernel<kTrain, kSwz, 16>, p, device, stream, map, x, cb, ids,
                         out_a, out_b, loss, B, L, K, D, p.slice, p.tile, p.tiles, p.stages, scale);
  return launch_kernel(rq_cluster_kernel<kTrain, kSwz, 32>, p, device, stream, map, x, cb, ids,
                       out_a, out_b, loss, B, L, K, D, p.slice, p.tile, p.tiles, p.stages, scale);
}

}  // namespace

// One launch on ``stream`` of ``device``. Returns the CUDA error code (0 = ok) or
// kErrClusterUnschedulable. Each library links its own CUDA runtime, so the
// device is set here rather than inherited from the caller's runtime.
template <bool kTrain>
inline int launch(const float* x, const float* cb, int32_t* ids, float* out_a, float* out_b,
                  float* loss, int B, int L, int K, int D, float commitment_weight, int device,
                  void* stream) {
  if (B == 0) return 0;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  const int perr = make_plan(B, L, K, D, device, &p);
  if (perr != 0) return perr;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.swizzled)
    return launch_plan<kTrain, true>(p, x, cb, ids, out_a, out_b, loss, B, L, K, D,
                                     commitment_weight, device, s);
  return launch_plan<kTrain, false>(p, x, cb, ids, out_a, out_b, loss, B, L, K, D,
                                    commitment_weight, device, s);
}

// The plan of a launch into out[0..10]: resident, rows, cluster, slice,
// tile, tiles, stages, swizzled, shared memory, grid, and the clusters (CTAs,
// for the resident kernel) the device holds at once, asked of it for the
// kernel the plan picks. Returns the error code, as a launch would.
template <bool kTrain>
inline int describe(int B, int L, int K, int D, int device, long long* out) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  int code = make_plan(B, L, K, D, device, &p);
  if (code != 0) return code;
  int clusters = 0;
#define RQ_READY(kernel) code = ready(kernel, p, device, &clusters)
  if (p.resident) {
    if (p.swizzled) {
      if (p.rows == 8) RQ_READY((rq_resident_kernel<kTrain, true, 2, 4>));
      else RQ_READY((rq_resident_kernel<kTrain, true, 4, 8>));
    } else {
      if (p.rows == 8) RQ_READY((rq_resident_kernel<kTrain, false, 2, 4>));
      else RQ_READY((rq_resident_kernel<kTrain, false, 4, 8>));
    }
  } else if (p.swizzled) {
    if (p.rows == 16) RQ_READY((rq_cluster_kernel<kTrain, true, 16>));
    else RQ_READY((rq_cluster_kernel<kTrain, true, 32>));
  } else {
    if (p.rows == 16) RQ_READY((rq_cluster_kernel<kTrain, false, 16>));
    else RQ_READY((rq_cluster_kernel<kTrain, false, 32>));
  }
#undef RQ_READY
  const long long vals[11] = {p.resident, p.rows, p.cluster, p.slice, p.tile, p.tiles,
                              p.stages, p.swizzled, p.smem, p.grid, clusters};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return code;
}

inline const char* error_string(int code) {
  if (code == kErrClusterUnschedulable)
    return "the plan's thread-block cluster cannot be resident on this device "
           "(cudaOccupancyMaxActiveClusters gave 0)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace rq
