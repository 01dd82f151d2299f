// Fused masked attention, forward: out = softmax(q k^T / sqrt(Dh) + bias) v.
//
// Replaces the TPU kernel rqvae_tpu/ops/flash_attention.py:_flash_kernel
// (flash_attention's forward). The kernels are flash_attention_fwd.cuh's,
// bound here to the key-bias mask (flash_attention_common.cuh:BiasMask):
// the (B, Nk) key mask as an additive fp32 bias (0 / -1e30) and causal
// masking col <= row, as the TPU kernel. Also writes the row statistics the
// backward needs: m (final row max) and inv, each (B, H, Nq) fp32, when the
// pointers are not null.
//
// What bounds it on an H100: 4 B H Nq Nk Dh flops (the TPU cost estimate);
// at B = 256, H = 8, N = 801, Dh = 64 that is 0.34 ms at 989 TFLOP/s bf16,
// against ~0.1 GB of operand traffic (0.03 ms at 3.35 TB/s): operations.
// The tensor-core variant (bf16, Dh = 64) loads its tiles synchronously and
// runs the exp / mask work on the CUDA cores, so it stays well above that
// bound; see flash_attention_fwd.cuh for both variants.
#include "flash_attention_fwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). strides: 12
// element strides, (batch, head, seq) of q, k, v, o. bias: (B, Nk) fp32,
// contiguous. m, inv: (B, H, Nq) fp32 or both null. Returns the CUDA error
// code of the launch (0 = ok).
int flash_fwd_launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
                     void* o, float* m, float* inv, const long long* strides, int B, int H,
                     int Nq, int Nk, int Dh, int causal, float scale, int device, void* stream) {
  return flash::fwd_dispatch(flash::BiasMask{bias, Nk, causal}, dtype, q, k, v, o, m, inv, strides,
                             B, H, Nq, Nk, Dh, scale, device, stream);
}

const char* flash_fwd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
