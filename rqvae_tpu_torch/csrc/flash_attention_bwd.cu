// Fused masked attention, backward: dq, dk, dv of out = softmax(q k^T /
// sqrt(Dh) + bias) v for an upstream gradient g.
//
// Replaces the TPU kernel rqvae_tpu/ops/flash_attention.py:_flash_bwd_kernel
// (flash_attention's custom-VJP backward), with the same arithmetic. The
// kernels are flash_attention_bwd.cuh's (for bf16 at Dh = 64: an exact c
// sweep, then one pass over the (key tile, q tile) pairs that adds dq into
// an fp32 accumulator with atomics), bound here to the key-bias mask
// (flash_attention_common.cuh:BiasMask).
//
// What bounds it on an H100: 10 B H Nq Nk Dh flops by the TPU cost estimate
// (0.85 ms at B = 256, H = 8, N = 801, Dh = 64 and 989 TFLOP/s): operations.
// The design does 14 (4 for c, 10 in the one pass), on wgmma with the next
// tile's loads in flight under the current one; see flash_attention_bwd.cuh.
// In fp32 (flash_bwd_c_tf32_kernel + flash_bwd_tf32_kernel, three TF32
// products a product, on mma.sync) at decoder_ml1m.json's step (B = 128,
// H = 8, N = 801, 0.308 of the pairs allowed): 30 Dh tensor flops an
// allowed pair, 0.785 ms at 495 TFLOP/s: operations. Both passes skip the
// (q tile, key tile) pairs with nothing to attend (BiasMask::live).
#include "flash_attention_bwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dq, dk, dv share it).
// strides: 21 element strides, (batch, head, seq) of q, k, v, g, dq, dk, dv.
// bias: (B, Nk) fp32; m, inv: the forward's (B, H, Nq) row statistics;
// c: (B, H, Nq) fp32 scratch; dq_acc: (B, H, Nq, 64) fp32 scratch when
// flash_bwd_route says 1 (bf16 on wgmma), else null. Launches on ``stream``; returns the
// first CUDA error code (0 = ok).
int flash_bwd_launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
                     const void* g, const float* m, const float* inv, float* c, float* dq_acc,
                     void* dq, void* dk, void* dv, const long long* strides, int B, int H, int Nq,
                     int Nk, int Dh, int causal, float scale, int device, void* stream) {
  return flash::bwd_dispatch(flash::BiasMask{bias, Nk, causal}, dtype, q, k, v, g, m, inv, c,
                             dq_acc, dq, dk, dv, strides, B, H, Nq, Nk, Dh, scale, device, stream);
}

// The kernels flash_bwd_launch takes for these operands: 0 the CUDA cores,
// 1 bf16 on wgmma (it then needs dq_acc), 2 fp32 as three TF32 products;
// strides: the 12 element strides of q, k, v, g, as flash_bwd_launch
// takes them.
int flash_bwd_route(int dtype, const void* q, const void* k, const void* v, const void* g,
                    const long long* strides, int Dh) {
  return flash::bwd_route(dtype, q, k, v, g, strides, Dh);
}

const char* flash_bwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

FLASH_EXPORT_ATTRIBUTE_CALLS(flash_bwd)

}  // extern "C"
