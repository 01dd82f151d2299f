// Fused L-level residual vector quantization for stage-1 training, forward.
//
// Replaces the TPU kernel rqvae_tpu/ops/quantize_pallas.py:_rq_train_kernel
// (rq_quantize_train). The same hard-argmin residual loop as rq_tokenize, but
// it stores what the backward and the model's statistics need: the
// pre-level residual and the chosen codeword of every level, each (L, B, D),
// plus ids (B, L) int32 and the loss (B,) = sum over levels of
// (1 + beta) ||r - emb||^2. The estimators' gradients (STE, rotation trick)
// are plain torch ops in ops/quantize_kernels.py, as they are plain jnp in
// the JAX package.
//
// The loop is csrc/rq_common.cuh's (K-tiled; see there for the layout and
// for what bounds it). At the stretch shape (B = 1024, 4 x 2048 x 64) a block
// owns 8 rows and walks 4 tiles of 512 codes per level: 128 blocks for the
// H100's 132 SMs.
#include "rq_common.cuh"

extern "C" {

// ``norms``: (L * K,) fp32 scratch for the codes' squared norms.
int rq_quantize_train_launch(const float* x, const float* cb, float* norms, int32_t* ids,
                             float* residuals, float* embeddings, float* loss, int B, int L,
                             int K, int D, float commitment_weight, int device, void* stream) {
  return rq::launch<true>(x, cb, norms, ids, residuals, embeddings, loss, B, L, K, D,
                          commitment_weight, device, stream);
}

const char* rq_quantize_train_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
