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
// What bounds it on an H100 (B = 256, H = 8, N = 801, Dh = 64, bf16, the
// ML-32M step, whose crop leaves 0.35 of the keys valid): key tiles whose
// every key is masked are skipped (exact: they weigh exp(-1e30 - m) = 0), so
// the work follows the valid keys. Bytes: q read and out written for every
// row (0.42 GB), K and V read for the valid keys (0.15 GB), the bias and the
// row statistics (0.01 GB): ~0.58 GB, 0.17 ms at 3.35 TB/s, the bound.
// Operations: 4 Dh tensor flops a valid (q, k) pair, 0.12 ms at 989
// TFLOP/s; one exp a pair, 0.11 ms on the special-function units. With
// every key valid the three are 0.25 (bytes), 0.34 and 0.31 ms, and the
// tensor flops bound it. chip_smoke.py counts all three from its run's
// data. The bf16 Dh = 64 kernel (flash_attention_fwd.cuh:
// flash_fwd_wg_kernel) runs both products on wgmma, two warpgroups a block
// sharing each K / V tile of a cp.async ring, and the softmax in log2
// units beside the products; see that header.
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

FLASH_EXPORT_ATTRIBUTE_CALLS(flash_fwd)

}  // extern "C"
