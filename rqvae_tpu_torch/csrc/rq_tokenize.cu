// Fused L-level residual vector quantization, hard argmin (corpus tokenization).
//
// Replaces the TPU kernel rqvae_tpu/ops/quantize_pallas.py:_rq_kernel
// (rq_tokenize). Outputs: ids (B, L) int32, the sum of the chosen codewords
// (B, D), the final residual (B, D) and the loss (B,) = sum over levels of
// (1 + beta) ||r - emb||^2.
//
// The kernels are csrc/rq_common.cuh's, so any (L, K, D) stack with D <= 128
// runs; the design and what bounds it on an H100 are described there. At
// the shipped shape (4,096-row corpus chunks, 3 x 256 x 32; 0.2 GFLOP of
// fp32 FMAs, 3 us at 67 TFLOP/s) the plan is the resident kernel: 128 CTAs
// of 32 rows (8 warps of 4), every level staged at once; at 4 x 2048 x 64,
// the cluster kernel without a cluster: 128 CTAs of 32 rows, each walking
// all 2048 codes a level in eight tiles through a ring of three stages.
#include "rq_common.cuh"

extern "C" {

int rq_tokenize_max_d() { return rq::kMaxD; }

int rq_tokenize_launch(const float* x, const float* cb, int32_t* ids, float* emb_sum, float* res,
                       float* loss, int B, int L, int K, int D, float commitment_weight, int device,
                       void* stream) {
  return rq::launch<false>(x, cb, ids, emb_sum, res, loss, B, L, K, D, commitment_weight, device,
                           stream);
}

int rq_tokenize_plan(int B, int L, int K, int D, int device, long long* out) {
  return rq::describe<false>(B, L, K, D, device, out);
}

const char* rq_tokenize_error_string(int code) { return rq::error_string(code); }

}  // extern "C"
