// Fused L-level residual vector quantization, hard argmin (corpus tokenization).
//
// Replaces the TPU kernel rqvae_tpu/ops/quantize_pallas.py:_rq_kernel
// (rq_tokenize). Outputs: ids (B, L) int32, the sum of the chosen codewords
// (B, D), the final residual (B, D) and the loss (B,) = sum over levels of
// (1 + beta) ||r - emb||^2.
//
// The loop is csrc/rq_common.cuh's, K-tiled, so any (L, K, D) stack with
// D <= 128 runs: the shipped 3 x 256 x 32 stack is one tile per level, the
// 4 x 2048 x 64 stretch stack four tiles of 512 codes per level. What bounds
// it on an H100, and the layout, are described there. At the shipped shape
// (4,096-row corpus chunks) the work is ~0.2 GFLOP of fp32 FMAs (~3 us at
// 67 TFLOP/s); launch latency and the per-block tile loads dominate.
#include "rq_common.cuh"

extern "C" {

int rq_tokenize_max_d() { return rq::kMaxD; }

// ``norms``: (L * K,) fp32 scratch for the codes' squared norms.
int rq_tokenize_launch(const float* x, const float* cb, float* norms, int32_t* ids,
                       float* emb_sum, float* res, float* loss, int B, int L, int K, int D,
                       float commitment_weight, int device, void* stream) {
  return rq::launch<false>(x, cb, norms, ids, emb_sum, res, loss, B, L, K, D, commitment_weight,
                           device, stream);
}

const char* rq_tokenize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
