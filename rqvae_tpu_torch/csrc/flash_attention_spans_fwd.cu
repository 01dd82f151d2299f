// Span-restricted attention, forward: query i attends key j iff
// lo_i <= j < hi_i or j == extra_i; out = softmax(where(allow,
// q k^T / sqrt(Dh), -1e30)) v, and zeros for a row that may attend no key.
//
// Replaces the TPU kernel rqvae_tpu/ops/flash_attention.py:_flash_span_kernel
// (flash_attention_spans' forward, :491). The kernels are
// flash_attention_fwd.cuh's (64 x 64 tiles, online softmax, mma.sync for
// bf16 at Dh = 64, fp32 CUDA cores otherwise), bound here to the span mask
// (flash_attention_common.cuh:SpanMask): each block stages its 64 query
// rows' (lo, hi, extra) per key tile and masks with two compares and an
// equality, a select after scaling as the TPU kernel's _span_allow. Also
// writes the row statistics m and inv, each (B, H, Nq) fp32, for the
// backward (flash_attention_spans_bwd.cu).
//
// What bounds it on an H100: the work is the allowed (q, k) pairs, not the
// dense Nq x Nk: 4 H Dh flops per pair. In packed training (96 rows of 808
// tokens, 8 heads, Dh = 64, bf16) about a third of the dense pairs are
// allowed, ~0.1 ms at 989 TFLOP/s, against ~0.1 GB of operands (~0.03 ms
// at 3.35 TB/s): operations. The design skips every key tile in which no
// row of the query tile is allowed (exact: those scores weigh exp(-1e30 -
// m) = 0), so the tiles it computes follow the allowed pairs up to tile
// granularity; a segment's window is contiguous and every extra column (a
// user token) sits in key tile 0. Within a computed tile the masked pairs
// still cost their multiply-adds, and tile loads are synchronous.
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

}  // extern "C"
