// Windowed child-token read from a level's sorted distinct-key table
// (the constrained-beam-search validity test), with two epilogues.
//
// Replaces the TPU kernel rqvae_tpu/ops/children_window.py:_children_kernel
// (children_window). For beam row r and window slot j < W, the slot is in
// the run when j < cnt[r] and 0 <= lo[r] + j < n, and then
//   child[r, j] = table[lo[r] + j] - key0[r].
//   Tokens: out[r, j] = child[r, j] if the slot is in the run and the child
//           lies in [0, k_tokens), else k_tokens: (R, W) int32, the TPU
//           kernel's function. (Its (R, W + 128) output with a 128-aligned
//           load window was a Mosaic lane-alignment artifact.)
//   Mask:   out[r, t] = 1 if some slot of the run holds child t, for
//           t < k_tokens: (R, k_tokens) bool, the caller's one-hot fold
//           (rqvae_tpu/tokenizer/semids.py:children_mask) done here. Tokens
//           >= k_tokens are dropped, as the fold's (K + 1)-th column is.
// Keys are int64 (the port's key dtype), so the difference never wraps.
//
// What bounds it on an H100: bytes. Each epilogue reads 16 bytes a row of
// lo / cnt / key0, the keys the rows' runs cover (each once: a key two rows
// share comes from L2 the second time) and writes its output once. The
// bound counts those keys, the union of [lo, lo + min(cnt, W)) over the rows,
// not the table: the table is padded to n_items, and at the deeper levels a
// run is a few keys. At the Amazon serving shape (R = 256 users x 32 beams =
// 8,192, W = K = 256) the output dominates: Tokens 8.4 MB of int32, Mask
// 2.1 MB of bool, 0.131 MB of row operands, and the covered keys at most the
// 12,101-key dedup table (0.097 MB): Tokens <= 0.00257 ms, Mask <= 0.00069
// ms at 3.35 TB/s. At ML-32M serving (R = 2,048, an 84,432-key table, 0.675
// MB whole) the covered keys are what moves the Mask bound; chip_smoke.py
// reports each level's count and bound.
//
// Design: one warp a row, over persistent CTAs (SMs x resident blocks,
// rows in a grid stride). Lanes 0-2 load the row's lo, cnt and key0 at once
// and a shuffle broadcasts them. Lane l owns the slots 4 (l + 32 i) + q,
// q < 4, and reads only the keys of the run, consecutive int64 loads; at the
// deeper levels most runs are a few keys, so most lanes load nothing. The
// table is not staged in shared memory (the ML-32M table is 675 KB; each
// window is read once, from L2).
//   Tokens: each lane writes its 4 slots as one 16-byte store (scalar stores
//   when W is not a multiple of 4).
//   Mask: each lane sets its children's bits in the warp's bitmap in shared
//   memory (atomicOr), then lane l expands bits 8 (l + 32 i) .. + 7 into 8
//   bytes of 0 / 1 and writes them as one 8-byte store: 256 bytes a row at
//   K = 256, where the fold wrote an 8.4 MB token array, read it back into a
//   16.8 MB int64 index and scattered it into a zeroed mask (four launches,
//   ~45 MB at 8,192 rows).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace cw {

constexpr int kWarps = 8;                 // warps (rows in flight) a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// The slots [jb, je) of the row's window that are in its run.
struct Run {
  const int64_t* keys;   // table + lo (read only at j in [jb, je))
  long long key0;
  int jb, je;
};

__device__ __forceinline__ Run load_row(const int64_t* table, const int32_t* lo,
                                        const int32_t* cnt, const int64_t* key0, int r, int n,
                                        int W, int lane) {
  long long v = 0;
  if (lane == 0) v = lo[r];
  else if (lane == 1) v = cnt[r];
  else if (lane == 2) v = key0[r];
  const long long row_lo = __shfl_sync(kFull, v, 0);
  const long long row_cnt = __shfl_sync(kFull, v, 1);
  Run run;
  run.key0 = __shfl_sync(kFull, v, 2);
  run.keys = table + row_lo;
  long long end = row_cnt < W ? row_cnt : W;
  if (end > n - row_lo) end = n - row_lo;
  run.jb = row_lo < 0 ? (int)-row_lo : 0;
  run.je = end > 0 ? (int)end : 0;
  return run;
}

// The token of slot j: the child if j is in the run and the child is below
// k_tokens, else k_tokens.
__device__ __forceinline__ int token(const Run& run, int j, int k_tokens) {
  if (j < run.jb || j >= run.je) return k_tokens;
  const long long child = __ldg(run.keys + j) - run.key0;
  return (child >= 0 && child < k_tokens) ? (int)child : k_tokens;
}

// 8 bits to 8 bytes of 0 / 1, bit q to byte q (the byte at the lowest address).
__device__ __forceinline__ uint64_t spread_bits(uint32_t byte) {
  uint64_t x = byte;
  x = (x | (x << 28)) & 0x0000000F0000000FULL;
  x = (x | (x << 14)) & 0x0003000300030003ULL;
  x = (x | (x << 7)) & 0x0101010101010101ULL;
  return x;
}

struct Tokens {
  static constexpr int kId = 0;
  static constexpr bool kBitmap = false;
  static constexpr int kAlign = 16;   // bytes a lane stores at once
  // vec: W is a multiple of 4 and out is 16-byte aligned
  static __device__ __forceinline__ void row(const Run& run, int32_t* out, int W, int k_tokens,
                                             bool vec, int lane, uint32_t*) {
    if (vec) {
      for (int g = lane; 4 * g < W; g += 32) {
        const int j = 4 * g;
        const int4 v = make_int4(token(run, j, k_tokens), token(run, j + 1, k_tokens),
                                 token(run, j + 2, k_tokens), token(run, j + 3, k_tokens));
        reinterpret_cast<int4*>(out)[g] = v;
      }
    } else {
      for (int j = lane; j < W; j += 32) out[j] = token(run, j, k_tokens);
    }
  }
};

struct Mask {
  static constexpr int kId = 1;
  static constexpr bool kBitmap = true;   // ceil(k_tokens / 32) words a warp
  static constexpr int kAlign = 8;
  // vec: k_tokens is a multiple of 8 and out is 8-byte aligned
  static __device__ __forceinline__ void row(const Run& run, uint8_t* out, int, int k_tokens,
                                             bool vec, int lane, uint32_t* bits) {
    for (int w = lane; 32 * w < k_tokens; w += 32) bits[w] = 0u;
    __syncwarp();
    for (int j0 = 4 * lane; j0 < run.je; j0 += 4 * 32) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = token(run, j0 + q, k_tokens);
        if (t < k_tokens) atomicOr(&bits[t >> 5], 1u << (t & 31));
      }
    }
    __syncwarp();
    if (vec) {
      for (int i = lane; 8 * i < k_tokens; i += 32)
        reinterpret_cast<uint64_t*>(out)[i] = spread_bits((bits[i >> 2] >> (8 * (i & 3))) & 0xffu);
    } else {
      for (int t = lane; t < k_tokens; t += 32) out[t] = (uint8_t)((bits[t >> 5] >> (t & 31)) & 1u);
    }
    __syncwarp();   // the bitmap is read out before the next row clears it
  }
};

template <class Epilogue, typename Out>
__global__ void __launch_bounds__(kThreads)
window_kernel(const int64_t* __restrict__ table, const int32_t* __restrict__ lo,
              const int32_t* __restrict__ cnt, const int64_t* __restrict__ key0,
              Out* __restrict__ out, int R, int n, int W, int k_tokens, int out_cols, bool vec,
              int words) {
  extern __shared__ uint32_t bits[];   // kWarps x words: each warp's bitmap (Mask)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = blockIdx.x * kWarps + warp; r < R; r += gridDim.x * kWarps) {
    const Run run = load_row(table, lo, cnt, key0, r, n, W, lane);
    Epilogue::row(run, out + (size_t)r * out_cols, W, k_tokens, vec, lane, bits + warp * words);
  }
}

// ---- per-device launch state: the persistent grid, asked once ----
constexpr int kMaxDevices = 64;
namespace {
struct Grid {
  int blocks;    // SMs x resident blocks; 0 = not read yet
  size_t smem;   // the dynamic shared memory it was read for
};
Grid g_grid[2][kMaxDevices];   // [epilogue][device]
std::mutex g_mutex;            // ctypes drops the GIL around a launch
}  // namespace

// Blocks a launch with ``smem`` bytes of dynamic shared memory may take on
// ``device``: SMs x resident blocks of ``kernel``. Opts the kernel in above
// 48 KB; an ``smem`` above the device's opt-in limit is cudaErrorInvalidValue.
template <typename Kernel>
cudaError_t grid_cap(Kernel kernel, int which, int device, size_t smem, int* cap) {
  std::lock_guard<std::mutex> lock(g_mutex);
  Grid& grid = g_grid[which][device];
  if (grid.blocks == 0 || grid.smem != smem) {
    int sms = 0, per_sm = 0, optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess && smem > (size_t)optin) err = cudaErrorInvalidValue;
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    grid = {sms * std::max(per_sm, 1), smem};
  }
  *cap = grid.blocks;
  return cudaSuccess;
}

// Make ``device`` current (this library links its own CUDA runtime): a
// thread-local read, and a set only when it differs.
cudaError_t use_device(int device) {
  int cur = -1;
  const cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur == device) return cudaSuccess;
  return cudaSetDevice(device);
}

template <class Epilogue, typename Out>
int launch(const int64_t* table, const int32_t* lo, const int32_t* cnt, const int64_t* key0,
           Out* out, int R, int n, int W, int k_tokens, int out_cols, int device, void* stream) {
  if (R <= 0 || out_cols <= 0) return 0;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const auto kernel = window_kernel<Epilogue, Out>;
  const int words = Epilogue::kBitmap ? (k_tokens + 31) / 32 : 0;
  const size_t smem = (size_t)kWarps * words * sizeof(uint32_t);
  int cap = 0;
  err = grid_cap(kernel, Epilogue::kId, device, smem, &cap);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)std::min<long long>(((long long)R + kWarps - 1) / kWarps, cap);
  constexpr int kAlign = Epilogue::kAlign;
  const bool vec = out_cols % (kAlign / (int)sizeof(Out)) == 0 && (uintptr_t)out % kAlign == 0;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(table, lo, cnt, key0, out, R, n, W,
                                                           k_tokens, out_cols, vec, words);
  return (int)cudaGetLastError();
}

}  // namespace cw

extern "C" {

// The Tokens epilogue: out (R, W) int32. Launches on ``stream`` of
// ``device``; returns the CUDA error code of the launch (0 = ok).
int children_window_launch(const int64_t* table, const int32_t* lo, const int32_t* cnt,
                           const int64_t* key0, int32_t* out, int R, int n, int W,
                           int k_tokens, int device, void* stream) {
  if (W <= 0) return 0;
  return cw::launch<cw::Tokens>(table, lo, cnt, key0, out, R, n, W, k_tokens, W, device, stream);
}

// The Mask epilogue: out (R, k_tokens) bool (one byte each). Its bitmaps take
// 8 x ceil(k_tokens / 32) words of shared memory, so k_tokens is bounded by
// the device's opt-in limit (232,448 on sm_90: ops/children_window.py
// MASK_MAX_K); above it the launch returns cudaErrorInvalidValue.
int children_window_mask_launch(const int64_t* table, const int32_t* lo, const int32_t* cnt,
                                const int64_t* key0, uint8_t* out, int R, int n, int W,
                                int k_tokens, int device, void* stream) {
  if (k_tokens <= 0) return (int)cudaErrorInvalidValue;
  return cw::launch<cw::Mask>(table, lo, cnt, key0, out, R, n, W, k_tokens, k_tokens, device,
                              stream);
}

const char* children_window_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
