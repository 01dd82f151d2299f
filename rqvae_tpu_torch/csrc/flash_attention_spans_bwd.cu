// Span-restricted attention, backward: dq, dk, dv of
// out = softmax(where(allow, q k^T / sqrt(Dh), -1e30)) v for an upstream
// gradient g, allow = (lo_i <= j < hi_i) | (j == extra_i).
//
// Replaces the TPU kernel rqvae_tpu/ops/flash_attention.py:
// _flash_span_bwd_kernel (flash_attention_spans' custom-VJP backward, :513),
// with its arithmetic: c = rowsum(dp * e) * inv, ds = e * ((dp - c) * inv)
// cast to the operand type, dv = e^T (g * inv) with g * inv cast to g's
// type. A padded or empty query row (lo = hi = 0, extra = -1) has inv = 0
// and contributes nothing. The kernels are flash_attention_bwd.cuh's (for
// bf16 at Dh = 64 an exact c sweep, then one pass over the tile pairs with
// dq added by atomics), bound here to the span mask
// (flash_attention_common.cuh:SpanMask).
//
// What bounds it on an H100: the allowed (q, k) pairs, 10 H Dh flops per
// pair by the TPU cost estimate's count; in packed training (96 rows of 808
// tokens, 8 heads, Dh = 64, bf16) 0.64 of the dense pairs, ~0.21 ms at 989
// TFLOP/s: operations. Both the c sweep and the one pass skip every
// (q tile, key tile) pair that the spans rule out (exact: it adds 0), so the
// computed tiles follow the allowed pairs up to tile granularity. In fp32
// (decoder_ml32m.json's packed branch: three TF32 products a product on
// mma.sync) 30 Dh tensor flops an allowed pair at 495 TFLOP/s bound it.
#include "flash_attention_bwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dq, dk, dv share it).
// lo, hi, extra: (B, Nq) int32, contiguous. strides: 21 element strides,
// (batch, head, seq) of q, k, v, g, dq, dk, dv. m, inv: the forward's
// (B, H, Nq) row statistics; c: (B, H, Nq) fp32 scratch; dq_acc: (B, H, Nq,
// 64) fp32 scratch when flash_spans_bwd_route says 1, else null.
// Launches on ``stream``; returns the first CUDA error code (0 = ok).
int flash_spans_bwd_launch(int dtype, const void* q, const void* k, const void* v, const int* lo,
                           const int* hi, const int* extra, const void* g, const float* m,
                           const float* inv, float* c, float* dq_acc, void* dq, void* dk, void* dv,
                           const long long* strides, int B, int H, int Nq, int Nk, int Dh,
                           float scale, int device, void* stream) {
  return flash::bwd_dispatch(flash::SpanMask{lo, hi, extra, Nq, Nk}, dtype, q, k, v, g, m, inv, c,
                             dq_acc, dq, dk, dv, strides, B, H, Nq, Nk, Dh, scale, device, stream);
}

// The kernels flash_spans_bwd_launch takes for these operands (as
// flash_bwd_route: 0 the CUDA cores, 1 bf16 on wgmma, which needs dq_acc,
// 2 fp32 as three TF32 products); strides: the 12 element strides of q, k,
// v, g.
int flash_spans_bwd_route(int dtype, const void* q, const void* k, const void* v, const void* g,
                          const long long* strides, int Dh) {
  return flash::bwd_route(dtype, q, k, v, g, strides, Dh);
}

const char* flash_spans_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

FLASH_EXPORT_ATTRIBUTE_CALLS(flash_spans_bwd)

}  // extern "C"
