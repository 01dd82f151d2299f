// Span-restricted attention, forward: query i attends key j iff
// lo_i <= j < hi_i or j == extra_i; out = softmax(where(allow,
// q k^T / sqrt(Dh), -1e30)) v, and zeros for a row that may attend no key.
//
// Replaces the TPU kernel rqvae_tpu/ops/flash_attention.py:_flash_span_kernel
// (flash_attention_spans' forward, :491). The kernels are
// flash_attention_fwd.cuh's (64-key tiles, online softmax; for bf16 at
// Dh = 64 wgmma with two warpgroups a block, fp32 CUDA cores otherwise),
// bound here to the span mask (flash_attention_common.cuh:SpanMask): each
// thread folds its rows' (lo, hi, extra) into a 64-bit mask of the tile's
// allowed keys, a select after scaling as the TPU kernel's _span_allow.
// Also writes the row statistics m and inv, each (B, H, Nq) fp32, for the
// backward (flash_attention_spans_bwd.cu).
//
// What bounds it on an H100: the work is the allowed (q, k) pairs, not the
// dense Nq x Nk. In packed training (96 rows of 808 tokens, 8 heads,
// Dh = 64, bf16) 0.642 of the dense pairs are allowed: 4 Dh tensor flops a
// pair, 0.083 ms at 989 TFLOP/s, and one exp, 0.077 ms on the
// special-function units. Bytes: q read and out written for every row, K
// and V read for the keys some row attends (nearly all of them), the spans
// and the row statistics: ~0.32 GB, 0.095 ms at 3.35 TB/s, the bound, with
// the operations close behind (chip_smoke.py counts all three from its
// run's data). The design skips every key tile in which no row of a
// warpgroup is allowed (exact: those scores weigh exp(-1e30 - m) = 0), so
// the tiles it computes follow the allowed pairs up to tile granularity; a
// segment's window is contiguous and every extra column (a user token)
// sits in key tile 0. A warp whose rows may attend a whole tile takes no
// per-score select; within the other computed tiles the masked pairs still
// cost their products.
#include "flash_attention_fwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). lo, hi, extra:
// (B, Nq) int32, contiguous. strides: 12 element strides, (batch, head,
// seq) of q, k, v, o. m, inv: (B, H, Nq) fp32 or both null. Returns the
// CUDA error code of the launch (0 = ok).
int flash_spans_fwd_launch(int dtype, const void* q, const void* k, const void* v, const int* lo,
                           const int* hi, const int* extra, void* o, float* m, float* inv,
                           const long long* strides, int B, int H, int Nq, int Nk, int Dh,
                           float scale, int device, void* stream) {
  return flash::fwd_dispatch(flash::SpanMask{lo, hi, extra, Nq, Nk}, dtype, q, k, v, o, m, inv,
                             strides, B, H, Nq, Nk, Dh, scale, device, stream);
}

const char* flash_spans_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

FLASH_EXPORT_ATTRIBUTE_CALLS(flash_spans_fwd)

}  // extern "C"
