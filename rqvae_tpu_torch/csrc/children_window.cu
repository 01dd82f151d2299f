// Windowed child-token read from a level's sorted distinct-key table
// (the constrained-beam-search validity test).
//
// Replaces the TPU kernel rqvae_tpu/ops/children_window.py:_children_kernel
// (children_window). For beam row r and window slot j < W:
//   out[r, j] = table[lo[r] + j] - key0[r]   if j < cnt[r], lo[r] + j < n and
//                                            the difference lies in [0, k_tokens)
//             = k_tokens                     otherwise
// Slot j holds the child at run position j. The TPU kernel's (R, W + 128)
// output with a 128-aligned load window was a Mosaic lane-alignment artifact;
// the validity mask built from either output is the same.
//
// What bounds it on an H100: the (R, W) int32 output. At the serving shape
// (R = 256 users x 32 beams = 8,192, W = K = 256) that is 8.4 MB of writes,
// ~2.5 us at 3.35 TB/s; the 12,101-entry int64 table (97 KB) and the per-row
// lo / cnt / key0 are small. It is bound by bytes written.
//
// Design: one thread per output slot, 256 threads per block, grid (R, W/256).
// Threads of a warp read consecutive table entries (coalesced; the table
// stays resident in the 50 MB L2 across rows) and write consecutive output
// words. Keys are int64 (the port's key dtype), so the difference never wraps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
children_window_kernel(const int64_t* __restrict__ table, const int32_t* __restrict__ lo,
                       const int32_t* __restrict__ cnt, const int64_t* __restrict__ key0,
                       int32_t* __restrict__ out, int n, int W, int k_tokens) {
  const int r = blockIdx.x;
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= W) return;
  const long long pos = (long long)lo[r] + j;
  int32_t v = k_tokens;
  if (j < cnt[r] && pos >= 0 && pos < n) {
    const int64_t child = table[pos] - key0[r];
    if (child >= 0 && child < k_tokens) v = (int32_t)child;
  }
  out[(size_t)r * W + j] = v;
}

}  // namespace

extern "C" {

// Launches on ``stream`` of ``device``; returns the CUDA error code of the
// launch (0 = ok). This library links its own CUDA runtime, so the device is
// set here rather than inherited from the caller's runtime.
int children_window_launch(const int64_t* table, const int32_t* lo, const int32_t* cnt,
                           const int64_t* key0, int32_t* out, int R, int n, int W,
                           int k_tokens, int device, void* stream) {
  if (R <= 0 || W <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)R, (unsigned)((W + kThreads - 1) / kThreads));
  children_window_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      table, lo, cnt, key0, out, n, W, k_tokens);
  return (int)cudaGetLastError();
}

const char* children_window_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
