// Short-sequence fused masked attention, forward:
// out = softmax(q k^T / sqrt(Dh) + bias) v for Nq, Nk < 256, plus the row
// statistics the backward reads (m, the row max, and inv, each (B, H, Nq)
// fp32).
//
// Replaces the TPU kernel rqvae_tpu/ops/flash_attention.py:_flash_small_kernel
// (flash_attention_small's forward, its pallas_call at :375). Its
// arithmetic: scores in fp32 with the key bias and the causal cut, one max /
// exp / sum over the whole row (no online carry), e = exp(s - m) cast to the
// operand type before the PV product, and inv = (m > -5e29 ? 1 / sum(e) : 0)
// folded into the output, so a row with no valid key gives zeros, m = -1e30
// and inv = 0.
//
// What bounds it on an H100: bytes, and only some of them. At the Amazon
// encoder shape (B = 256, H = 8, N = 81, Dh = 64, bf16) q and out are
// 21.2 MB each, and K and V 21.2 MB each over every key; but a masked key's
// K and V are needed by no row, and the histories are right-padded (0.294
// of the recorded batch's keys are valid): ~56 MB, 0.017 ms at 3.35 TB/s,
// against 4 Dh flops a valid (query, key) pair, ~0.001 ms at 989 TFLOP/s.
// So the design moves only the bytes the answer needs, and keeps the copies
// off the computing warps' path:
//   * Live key tiles only. A 16-key tile is live when one of its keys has a
//     bias above -5e29 (one __ballot_sync a pair of tiles over the staged
//     bias). Only live tiles' K and V are copied, packed together in shared
//     memory, and the score, exp and PV loops run over the live count: KT, a
//     template constant, bounds it so the score row stays in registers, and
//     the count is warp-uniform, so the unrolled loop is predicated. Under
//     the causal cut a warp also skips the live tiles past its last row. A
//     skipped tile's scores are -1e30 (or -inf) against a finite row max,
//     whose exp is exactly 0, so only the order of the fp32 sums can differ
//     from the twin's; a pair with no live tile writes zeros, m = -1e30 and
//     inv = 0.
//   * A producer warp and TMA copies. Copying with cp.async (16 bytes a
//     thread) kept the computing warps issuing copies for over a microsecond
//     a unit, and per-row bulk copies were slower still (PERF.md): a
//     q tile and each live K / V tile is one tensor copy here (tensor maps
//     encoded at launch over the strided views; 128-byte swizzle; rows past
//     N land as zeros), issued by one lane of a producer warp, completion
//     counted on an mbarrier. With one key tile (Nk <= 16) nothing is left
//     to choose, so K and V start with q instead of after the bias.
//   * Persistent CTAs over a two-stage ring. The grid is what fits on the
//     SMs; each CTA walks units of G (batch, head) pairs (two where a pair is
//     one query tile: 5 x 81, 5 x 5, a decode step's 1 x T). While the
//     consumer warps (one a 16-row query tile) compute a unit, the producer
//     fetches the next: its key bias (cp.async), q, and the live K / V tiles
//     the landed bias names. Full / empty mbarriers hand the stages over, so
//     no block barrier stands in the loop. More stages, and other G, did not
//     pay on the H100 (PERF.md).
//   * The softmax in log2 units: scale log2 e and the bias (times log2 e)
//     folded into one FMA, e = 2^(s - m) on ex2.approx, the per-score masks
//     (keys past Nk, the causal cut) only on the tiles that need them. m is
//     stored in natural units (m2 ln 2, or -1e30 for a row with no valid
//     key), so the backward's exp(s - m) gives the same e to fp32 rounding.
//   * The output goes through the warp's own q rows in shared memory and
//     out as 16-byte stores of whole rows.
// Each consumer warp runs q k^T and e v on the tensor cores (mma.sync
// m16n8k16, fp32 accumulate) from the swizzled tiles of
// flash_attention_small.cuh.
//
// Three variants compute the same function (fwd_gate picks):
//   * small_fwd_live_kernel<KT>: the above, for bf16 operands with Dh = 64
//     whose rows can be copied 16 bytes at a time (the model's case under
//     amp).
//   * small_fwd_tf32_kernel<KT>: fp32 operands with Dh = 64 and 16-byte
//     aligned rows (every shipped decoder config: they train in fp32). fp32
//     doubles the bytes and a TF32 product keeps 11 bits of each operand, so
//     each product is three TF32 mma.sync m16n8k8 (flash_attention_common.cuh:
//     split_tf32, mma_tf32x3), six times the bf16 kernel's tensor
//     instructions. A staged design like the one above, in fp32 (TMA copies
//     of two 32-float halves a row, one or two stages), measured no faster
//     over a step's shapes on an H100 (PERF.md): its consumer warps are bound
//     by the products and their operand splits, and fp32 stages leave fewer
//     of them an SM. So this kernel stages nothing: a warp a (pair, query
//     tile), the live tiles' K and V read straight into registers, the warps
//     of a pair sharing them in L1, many warps an SM to hide the loads.
//   * small_fwd_kernel<T, DP>: other head sizes (Dh <= 128) and unaligned
//     views, fp32 or bf16: a CTA owns one pair's 64-row query tile, stages
//     key tiles of 64 in shared memory as fp32 and writes every score of its
//     rows to a shared-memory row of up to 256 (the fp32 K and V of a whole
//     pair at Dh = 128 would exceed 227 KB), then the same one-pass softmax
//     and p v on the CUDA cores.
#include "flash_attention_small.cuh"
#include "mbarrier.cuh"

#include <cuda.h>   // CUtensorMap and its enums (cuTensorMapEncodeTiled is looked up at run time)

namespace flash {
namespace small {

// ---- the tensor-copy (TMA) and mbarrier instructions the bf16 kernel uses ----

using hopper::fence_mbar_init;
using hopper::mbar_arrive;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;

// The box of ``map`` (a (64, N, H, B) bf16 view) at rows n.. of head h of
// batch row b into dst (1024-byte aligned) in the 128-byte swizzle, by the
// TMA unit; rows past N land as zeros, and every byte of the box counts on bar.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int n, int h, int b,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(0), "r"(n), "r"(h), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// bring a tensor map's descriptor into the TMA unit's cache ahead of use
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

// Consumer warps a CTA (one more warp produces): up to 96 keys, six, so
// that two CTAs fit on an SM at 128 registers; more keys, seven, one CTA an
// SM, a block of 256 threads (ptxas budgets registers for blocks in steps
// of four warps: nine warps would cap them at 168, and the longer score
// rows spill there).
__host__ __device__ constexpr int consumer_warps(int KT) { return KT <= 6 ? 6 : 7; }
constexpr int kStages = 2;     // a unit computes while the next one lands
constexpr int kMaxPairs = 2;   // pairs a unit (G)

// A CTA's shared memory for units of G pairs: a stage is q [nqp][64] and K,
// V [nkp][64] a pair (bf16, 128-byte swizzled rows from a 1024-byte
// boundary), the key bias [G][nkp] fp32, a full and an empty mbarrier and
// the live-tile masks [G].
__host__ __device__ constexpr long long fwd_smem_bytes(int G, int nqp, int nkp) {
  return kSmemSlack + kStages * (G * ((nqp + 2LL * nkp) * kMD * 2 + nkp * 4LL + 4) + 16);
}

template <int KT>
__global__ void __launch_bounds__((consumer_warps(KT) + 1) * 32, KT <= 6 ? 2 : 1)
small_fwd_live_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ inv_out, Strides so, int BH, int H, int Nq, int Nk, int G,
                      int causal, float scale2) {
  constexpr int S = kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nkp = 16 * KT;
  const int n_qt = (Nq + 15) / 16;
  const int nqp = 16 * n_qt;
  const int pair_elems = (nqp + 2 * nkp) * kMD;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_base(smem_raw));   // [S][G]: Q, K, V
  float* bias_s = reinterpret_cast<float*>(tiles + S * G * pair_elems);           // [S][G][nkp]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + S * G * nkp);             // [S]
  uint64_t* empty = full + S;                                                    // [S]
  unsigned* masks = reinterpret_cast<unsigned*>(empty + S);                      // [S][G]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int consumers = (blockDim.x >> 5) - 1;   // the last warp produces
  const int units = (BH + G - 1) / G;
  const int step = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 2);           // the producer: q's bytes, then K / V's
      mbar_init(empty + s, consumers);  // every consumer warp, done with the stage
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == consumers) {
    // The producer walks the CTA's units, stage s: once the consumers have
    // released the stage, it copies the unit's key bias (cp.async), starts
    // q's tensor copies, reads the live tiles off the landed bias (a ballot
    // a tile pair), and starts their K and V copies, a lane a copy.
    if (lane < 3) prefetch_tensormap(lane == 0 ? &tq : lane == 1 ? &tk : &tv);
    int s = 0;
    unsigned parity = 0;
    for (int u = blockIdx.x; u < units; u += step) {
      const int np = min(G, BH - u * G);
      mbar_wait(empty + s, parity ^ 1u);
      __nv_bfloat16* st = tiles + s * G * pair_elems;
      for (int p = 0; p < np; ++p)
        stage_floats(bias_s + (s * G + p) * nkp, bias + (long long)((u * G + p) / H) * Nk, Nk, Nk,
                     lane, 32);
      cp_async_commit();
      // with one key tile there is nothing to choose: its K and V start
      // with q (a pair with no valid key reads them for nothing)
      if (lane == 0) mbar_expect(full + s, (unsigned)(np * (nqp + (KT == 1 ? 2 * nkp : 0)) * kMD * 2));
      __syncwarp();
      if (lane < np * (KT == 1 ? 3 : 1)) {   // lane: pair lane % np, operand lane / np
        const int p = lane % np, bh = u * G + p;
        __nv_bfloat16* Qs = st + p * pair_elems;
        const int which = lane / np;
        tensor_copy(Qs + (which == 0 ? 0 : nqp + (which - 1) * nkp) * kMD,
                    which == 0 ? &tq : which == 1 ? &tk : &tv, 0, bh % H, bh / H, full + s);
      }
      cp_async_wait<0>();
      __syncwarp();
      unsigned mk[kMaxPairs] = {0u, 0u};
      for (int p = 0; p < np; ++p) {
        mk[p] = live_mask<KT>(bias_s + (s * G + p) * nkp, Nk);
        if (lane == 0) masks[s * G + p] = mk[p];
      }
      if (KT == 1) {
        if (lane == 0) mbar_arrive(full + s);
      } else {
        if (lane == 0) mbar_expect(full + s, (unsigned)((__popc(mk[0]) + __popc(mk[1])) * 2 * 16 * kMD * 2));
        __syncwarp();
        // lane: live tile j = lane % KT of pair lane / KT, keys 16 t ..
        const int p = lane / KT, j = lane % KT;
        if (p < np && j < __popc(mk[p])) {
          const int bh = u * G + p, t = __fns(mk[p], 0, j + 1);
          __nv_bfloat16* Ks = st + p * pair_elems + nqp * kMD;
          tensor_copy(Ks + 16 * j * kMD, &tk, 16 * t, bh % H, bh / H, full + s);
          tensor_copy(Ks + (nkp + 16 * j) * kMD, &tv, 16 * t, bh % H, bh / H, full + s);
        }
      }
      if (++s == S) s = 0, parity ^= 1u;
    }
    return;
  }

  // A consumer warp owns pair p of each unit and its query tiles qt0,
  // qt0 + tiles_step, ...
  const int p = consumers >= G * n_qt ? warp / n_qt : 0;
  const int qt0 = consumers >= G * n_qt ? warp % n_qt : warp;
  const int qt_step = consumers >= G * n_qt ? n_qt : consumers;
  const int g = lane >> 2, c = lane & 3;
  int s = 0;
  unsigned parity = 0;
  for (int u = blockIdx.x; u < units; u += step) {
    const int np = min(G, BH - u * G);
    mbar_wait(full + s, parity);
    for (int qt = qt0; p < np && qt < n_qt; qt += qt_step) {
      const int bh = u * G + p;
      const float* bs = bias_s + (s * G + p) * nkp;
      // the live tiles; under the cut, only those at or below the warp's
      // last row (a prefix of the packed tiles)
      unsigned mask = masks[s * G + p];
      if (causal) mask &= (2u << qt) - 1u;
      const int nl = __popc(mask);
      const unsigned long long idx = tile_list<KT>(mask);
      __nv_bfloat16* Qs = tiles + (s * G + p) * pair_elems;
      const __nv_bfloat16* Ks = Qs + nqp * kMD;
      const __nv_bfloat16* Vs = Ks + nkp * kMD;
      const int row[2] = {16 * qt + g, 16 * qt + g + 8};

      float sc[2 * KT][4];
      if (nl > 0) {
        uint32_t qf[4][4];
        load_a_sw(qf, Qs, 16 * qt);
#pragma unroll
        for (int jj = 0; jj < KT; ++jj)
          if (jj < nl) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[2 * jj][e] = sc[2 * jj + 1][e] = 0.f;
            mma_nt_sw(sc[2 * jj], sc[2 * jj + 1], qf, Ks, 16 * jj);
          }
      }
      // scores in log2 units and the whole row's max (finite on a computed
      // tile: it holds a key < Nk); only the last tile can reach past Nk, and
      // under the cut only the warp's diagonal tile needs the per-score test
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        if (jj >= nl) continue;
        const int t = (int)((idx >> (4 * jj)) & 15ull);
        const bool edge = 16 * t + 16 > Nk || (causal && t == qt);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = 16 * t + 8 * hh + 2 * c;
          const float2 bb = *reinterpret_cast<const float2*>(bs + col);
          const float b2[2] = {bb.x * kLog2e, bb.y * kLog2e};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(sc[2 * jj + hh][e], scale2, b2[e & 1]);
            if (edge) {
              const int key = col + (e & 1);
              if (key >= Nk) x = -INFINITY;
              else if (causal && key > row[e >> 1]) x = kNegInf2;
            }
            sc[2 * jj + hh][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        if (jj >= nl) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[2 * jj + hh][e] = ex2(sc[2 * jj + hh][e] - mx[e >> 1]);
            rs[e >> 1] += sc[2 * jj + hh][e];
          }
      }
      bool any[2];
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
        rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
        any[r] = mx[r] > 0.5f * kNegInf2;   // the row met a valid key
        inv[r] = any[r] ? 1.f / rs[r] : 0.f;
      }

      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < KT; ++jj)
        if (jj < nl) {
          uint32_t a[4];
          pack_a(a, sc[2 * jj], sc[2 * jj + 1]);   // e rounded to bf16 where it enters the product
          mma_pa_sw<false>(acc, a, Vs, 16 * jj, nullptr);
        }

      // the output through the warp's own q rows (read into fragments
      // above): bf16 rows there, then 16-byte stores of whole rows
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(Qs + sw(row[r], 8 * j + 2 * c)) =
              pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
      __syncwarp();
      __nv_bfloat16* op = o + (bh / H) * so.b + (bh % H) * so.h;
#pragma unroll
      for (int r0 = 0; r0 < 16; r0 += 4) {
        const int r = 16 * qt + r0 + (lane >> 3);
        if (r < Nq)
          *reinterpret_cast<uint4*>(op + r * so.n + 8 * (lane & 7)) =
              *reinterpret_cast<const uint4*>(Qs + sw(r, 8 * (lane & 7)));
      }
      const long long stat0 = (long long)bh * Nq;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (c == 0 && row[r] < Nq) {
          m_out[stat0 + row[r]] = any[r] ? mx[r] * kLn2 : kNegInf;
          inv_out[stat0 + row[r]] = inv[r];
        }
    }
    // release the stage: this warp's shared-memory writes (the output
    // rows) ordered before the tensor copies that will overwrite them
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == S) s = 0, parity ^= 1u;
  }
}

// The unit of a launch: G pairs, two where a pair is one query tile (16
// rows), the unit's shared memory keeps two CTAs on an SM and the grid
// still holds two units for each CTA slot; else one. The block is a warp
// per query tile (at most consumer_warps) and the producer.
struct FwdPlan {
  int G, warps;
  long long smem;
};
inline FwdPlan fwd_plan(int BH, int Nq, int Nk) {
  const int n_qt = (Nq + 15) / 16, nqp = 16 * n_qt, KT = (Nk + 15) / 16, nkp = 16 * KT;
  const int G = n_qt == 1 && fwd_smem_bytes(2, nqp, nkp) <= kPairSmemBudget &&
                        (BH + 1) / 2 >= 2 * kSmsH100 ? 2 : 1;
  const int consumers = std::min(consumer_warps(KT), G * n_qt);
  return {G, consumers + 1, fwd_smem_bytes(G, nqp, nkp)};
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

// The fp32 forward on the tensor cores: a warp a (pair, 16-row query tile),
// kTf32FwdWarps to a CTA (consecutive tiles of a pair, so they share K and V
// in L1), no shared memory. The warp reads the pair's key bias, takes the
// live tiles as the bf16 kernel does (under the cut, those at or below its
// last row), and runs q k^T and e v over them alone as three TF32 products,
// its fragments read from global memory (flash_attention_small.cuh); the
// softmax, m and inv are the bf16 kernel's. Small CTAs and a register cap of
// 128 keep 16 warps an SM at up to 96 keys: the warps' chains of loads and
// products are what bound it, so more of them hide more latency.
constexpr int kTf32FwdWarps = 4;

template <int KT>
__global__ void __launch_bounds__(kTf32FwdWarps * 32, KT <= 6 ? 4 : 1)
small_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ inv_out, Strides sq, Strides sk, Strides sv, Strides so,
                      int BH, int H, int Nq, int Nk, int causal, float scale2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int n_qt = (Nq + 15) / 16;
  const long long item = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= (long long)BH * n_qt) return;
  const int bh = (int)(item / n_qt), qt = (int)(item % n_qt);
  const int b = bh / H, h = bh % H;
  const float* bs = bias + (long long)b * Nk;
  unsigned mask = live_mask<KT>(bs, Nk);
  if (causal) mask &= (2u << qt) - 1u;
  const int nl = __popc(mask);
  const unsigned long long idx = tile_list<KT>(mask);
  const float* qp = q + b * sq.b + h * sq.h;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
  const int row[2] = {16 * qt + g, 16 * qt + g + 8};

  float sc[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
  if (nl > 0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int d = 16 * kk + 4 * c;
      uint32_t ab[2][4], as[2][4];
      frag_a_dims(ldg4(qp + row[0] * sq.n + d, row[0] < Nq), ldg4(qp + row[1] * sq.n + d, row[1] < Nq),
                  ab, as);
#pragma unroll
      for (int jj = 0; jj < KT; ++jj)
        if (jj < nl) {
          const int t = (int)((idx >> (4 * jj)) & 15ull);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int key = 16 * t + 8 * u + g;
            mma_dims(sc[2 * jj + u], ab, as, ldg4(kp + key * sk.n + d, key < Nk));
          }
        }
    }
  }
  // scores in log2 units and the whole row's max, as in small_fwd_live_kernel
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jj = 0; jj < KT; ++jj) {
    if (jj >= nl) continue;
    const int t = (int)((idx >> (4 * jj)) & 15ull);
    const bool edge = 16 * t + 16 > Nk || (causal && t == qt);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = 16 * t + 8 * u + 2 * c;
      const float b2[2] = {col < Nk ? bs[col] * kLog2e : 0.f, col + 1 < Nk ? bs[col + 1] * kLog2e : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(sc[2 * jj + u][e], scale2, b2[e & 1]);
        if (edge) {
          const int key = col + (e & 1);
          if (key >= Nk) x = -INFINITY;
          else if (causal && key > row[e >> 1]) x = kNegInf2;
        }
        sc[2 * jj + u][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < KT; ++jj) {
    if (jj >= nl) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[2 * jj + u][e] = ex2(sc[2 * jj + u][e] - mx[e >> 1]);
        rs[e >> 1] += sc[2 * jj + u][e];
      }
  }
  bool any[2];
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
    rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
    any[r] = mx[r] > 0.5f * kNegInf2;   // the row met a valid key
    inv[r] = any[r] ? 1.f / rs[r] : 0.f;
  }

  // e v: e from the score accumulator (keys 2 c, 2 c + 1 of each 8 as k
  // indices c, c + 4), V rows read for all eight n-tiles at once
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int jj = 0; jj < KT; ++jj)
    if (jj < nl) {
      const int t = (int)((idx >> (4 * jj)) & 15ull);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t ab[4], as[4];
        frag_a_acc(sc[2 * jj + u], ab, as);
        const int k0 = 16 * t + 8 * u + 2 * c;
        float r0[8], r1[8];
        load8(r0, vp + k0 * sv.n, k0 < Nk);   // a key past Nk reads zeros (its e is 0)
        load8(r1, vp + (k0 + 1) * sv.n, k0 + 1 < Nk);
        mma_rows<8>(acc, ab, as, r0, r1);
      }
    }
  store_dims<8>(o + b * so.b + h * so.h, so.n, 16 * qt, Nq, 0, acc, inv);
  const long long stat0 = (long long)bh * Nq;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (c == 0 && row[r] < Nq) {
      m_out[stat0 + row[r]] = any[r] ? mx[r] * kLn2 : kNegInf;
      inv_out[stat0 + row[r]] = inv[r];
    }
}

inline int launch_fwd_tf32(const void* q, const void* k, const void* v, const float* bias, void* o,
                           float* m, float* inv, const Strides* st, int B, int H, int Nq, int Nk,
                           int causal, float scale, cudaStream_t stream) {
  const long long items = (long long)B * H * ((Nq + 15) / 16);
  const unsigned grid = (unsigned)((items + kTf32FwdWarps - 1) / kTf32FwdWarps);
  switch ((Nk + 15) / 16) {
#define FLASH_SMALL_KT(n)                                                                         \
  case n: {                                                                                       \
    small_fwd_tf32_kernel<n><<<grid, kTf32FwdWarps * 32, 0, stream>>>(                            \
        (const float*)q, (const float*)k, (const float*)v, bias, (float*)o, m, inv, st[0], st[1], \
        st[2], st[3], B * H, H, Nq, Nk, causal, scale * kLog2e);                                  \
    return (int)cudaGetLastError();                                                               \
  }
    FLASH_SMALL_KT(1) FLASH_SMALL_KT(2) FLASH_SMALL_KT(3) FLASH_SMALL_KT(4)
    FLASH_SMALL_KT(5) FLASH_SMALL_KT(6) FLASH_SMALL_KT(7) FLASH_SMALL_KT(8)
    FLASH_SMALL_KT(9) FLASH_SMALL_KT(10) FLASH_SMALL_KT(11) FLASH_SMALL_KT(12)
    FLASH_SMALL_KT(13) FLASH_SMALL_KT(14) FLASH_SMALL_KT(15) FLASH_SMALL_KT(16)
#undef FLASH_SMALL_KT
  }
  return (int)cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled, looked up once through the runtime (the library
// links only the CUDA runtime).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
namespace {
EncodeTiled g_encode = nullptr;
}

// A (B, H, N, 64) bf16 view (element strides st) as a tensor map whose box
// is ``rows`` rows of one head, copied in the 128-byte swizzle.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, const Strides& st, int B, int H,
                              int N, int rows) {
  if (g_encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    g_encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)kMD, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.n * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kMD, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit_strides[4] = {1, 1, 1, 1};
  const CUresult r = g_encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                              strides, box, unit_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int launch_fwd_mma(const void* q, const void* k, const void* v, const float* bias, void* o,
                          float* m, float* inv, const Strides* st, int B, int H, int Nq, int Nk,
                          int causal, float scale, int device, cudaStream_t stream) {
  const int BH = B * H;
  const FwdPlan pl = fwd_plan(BH, Nq, Nk);
  const int units = (BH + pl.G - 1) / pl.G;
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map(&tq, q, st[0], B, H, Nq, 16 * ((Nq + 15) / 16));
  if (err == cudaSuccess) err = tensor_map(&tk, k, st[1], B, H, Nk, 16);
  if (err == cudaSuccess) err = tensor_map(&tv, v, st[2], B, H, Nk, 16);
  if (err != cudaSuccess) return (int)err;
  switch ((Nk + 15) / 16) {
#define FLASH_SMALL_KT(n)                                                                        \
  case n:                                                                                        \
    return launch_persistent(small_fwd_live_kernel<n>, pl.warps, pl.smem, units, device, stream, tq, \
                             tk, tv, bias, (__nv_bfloat16*)o, m, inv, st[3], BH, H, Nq, Nk, pl.G, \
                             causal, scale * kLog2e);
    FLASH_SMALL_KT(1) FLASH_SMALL_KT(2) FLASH_SMALL_KT(3) FLASH_SMALL_KT(4)
    FLASH_SMALL_KT(5) FLASH_SMALL_KT(6) FLASH_SMALL_KT(7) FLASH_SMALL_KT(8)
    FLASH_SMALL_KT(9) FLASH_SMALL_KT(10) FLASH_SMALL_KT(11) FLASH_SMALL_KT(12)
    FLASH_SMALL_KT(13) FLASH_SMALL_KT(14) FLASH_SMALL_KT(15) FLASH_SMALL_KT(16)
#undef FLASH_SMALL_KT
  }
  return (int)cudaErrorInvalidValue;
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

// The kernel that takes operands of this dtype at these addresses and
// strides (Route, flash_attention_small.cuh): at Dh = 64, bf16 operands
// whose rows are 16-byte aligned take the live kernel (its epilogue stores
// whole 16-byte output rows) and fp32 ones the TF32 kernel (float4 reads
// and stores), when q, k, v and o all are; else the CUDA-core kernel. The
// one place this gate lives: the launcher takes it and
// flash_small_fwd_route exports it.
inline int fwd_gate(int dtype, const void* q, const void* k, const void* v, const void* o,
                    const long long* strides) {
  const void* ops[4] = {q, k, v, o};
  bool ok = true;
  for (int i = 0; i < 4; ++i)
    ok = ok && (dtype == 0 ? tf32_aligned(ops[i], strides + 3 * i) : mma_aligned(ops[i], strides + 3 * i));
  return ok ? (dtype == 0 ? kRouteTf32x3 : kRouteMmaBf16) : kRouteCudaCores;
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int route = Dh == kMD ? small::fwd_gate(dtype, q, k, v, o, strides) : small::kRouteCudaCores;
  if (route == small::kRouteTf32x3)
    return small::launch_fwd_tf32(q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, causal, scale, s);
  if (route == small::kRouteMmaBf16)
    return small::launch_fwd_mma(q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, causal, scale, device, s);
  if (dtype == 0)
    return small::launch_fwd_dp<float>(DP, q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, Dh, causal, scale, device, s);
  return small::launch_fwd_dp<__nv_bfloat16>(DP, q, k, v, bias, o, m, inv, st, B, H, Nq, Nk, Dh, causal, scale, device, s);
}

// The bf16 Dh = 64 kernel's launch for (B H, Nq, Nk) on ``device``: out[0]
// pairs a unit (G), out[1] stages (S), out[2] warps a CTA, out[3] shared
// memory a CTA in bytes, out[4] CTAs an SM (0 on an error).
void flash_small_fwd_plan(int BH, int Nq, int Nk, int device, long long* out) {
  using namespace flash;
  const small::FwdPlan pl = small::fwd_plan(BH, Nq, Nk);
  const int warps = pl.warps;
  int per_sm = 0;
  if (use_device(device) == cudaSuccess) {
    switch ((Nk + 15) / 16) {
#define FLASH_SMALL_KT(n)                                                                         \
  case n:                                                                                         \
    if (prepare(small::small_fwd_live_kernel<n>, (size_t)pl.smem, device) == cudaSuccess)        \
      per_sm = blocks_per_sm(small::small_fwd_live_kernel<n>, 32 * warps, (size_t)pl.smem, device); \
    break;
      FLASH_SMALL_KT(1) FLASH_SMALL_KT(2) FLASH_SMALL_KT(3) FLASH_SMALL_KT(4)
      FLASH_SMALL_KT(5) FLASH_SMALL_KT(6) FLASH_SMALL_KT(7) FLASH_SMALL_KT(8)
      FLASH_SMALL_KT(9) FLASH_SMALL_KT(10) FLASH_SMALL_KT(11) FLASH_SMALL_KT(12)
      FLASH_SMALL_KT(13) FLASH_SMALL_KT(14) FLASH_SMALL_KT(15) FLASH_SMALL_KT(16)
#undef FLASH_SMALL_KT
    }
  }
  const long long vals[5] = {pl.G, small::kStages, warps, pl.smem, per_sm};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
}

// The kernel that operands of ``dtype`` at these addresses and strides (12,
// as the launch takes them) take: 0 = the CUDA-core kernel, 1 =
// small_fwd_live_kernel (bf16), 2 = small_fwd_tf32_kernel (fp32).
int flash_small_fwd_route(int dtype, const void* q, const void* k, const void* v, const void* o,
                          const long long* strides, int Dh) {
  using namespace flash::small;
  return Dh == flash::kMD ? fwd_gate(dtype, q, k, v, o, strides) : kRouteCudaCores;
}

// The fp32 Dh = 64 kernel's launch at Nk keys on ``device``: out[0] warps a
// CTA, out[1] shared memory a CTA in bytes, out[2] CTAs an SM (0 on an error).
void flash_small_fwd_tf32_plan(int Nk, int device, long long* out) {
  using namespace flash;
  int per_sm = 0;
  if (use_device(device) == cudaSuccess) {
    switch ((Nk + 15) / 16) {
#define FLASH_SMALL_KT(n)                                                                      \
  case n:                                                                                      \
    per_sm = blocks_per_sm(small::small_fwd_tf32_kernel<n>, 32 * small::kTf32FwdWarps, 0, device); \
    break;
      FLASH_SMALL_KT(1) FLASH_SMALL_KT(2) FLASH_SMALL_KT(3) FLASH_SMALL_KT(4)
      FLASH_SMALL_KT(5) FLASH_SMALL_KT(6) FLASH_SMALL_KT(7) FLASH_SMALL_KT(8)
      FLASH_SMALL_KT(9) FLASH_SMALL_KT(10) FLASH_SMALL_KT(11) FLASH_SMALL_KT(12)
      FLASH_SMALL_KT(13) FLASH_SMALL_KT(14) FLASH_SMALL_KT(15) FLASH_SMALL_KT(16)
#undef FLASH_SMALL_KT
    }
  }
  const long long vals[3] = {small::kTf32FwdWarps, 0, per_sm};
  for (int i = 0; i < 3; ++i) out[i] = vals[i];
}

const char* flash_small_fwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

FLASH_EXPORT_ATTRIBUTE_CALLS(flash_small_fwd)

}  // extern "C"
