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
// The kernels are csrc/rq_common.cuh's (see there for the design and for
// what bounds them). At the flagship step (B = 64, 3 x 256 x 32) the plan is
// the resident kernel: 8 CTAs of 8 rows (4 warps of 2), every level's 256
// codes staged at once; at the stretch shape (B = 1024, 4 x 2048 x 64) the
// cluster kernel: 64 clusters of two CTAs of 16 rows, each CTA 1024 codes a
// level in four 256-code tiles through a ring of three stages.
#include "rq_common.cuh"

extern "C" {

int rq_quantize_train_launch(const float* x, const float* cb, int32_t* ids, float* residuals,
                             float* embeddings, float* loss, int B, int L, int K, int D,
                             float commitment_weight, int device, void* stream) {
  return rq::launch<true>(x, cb, ids, residuals, embeddings, loss, B, L, K, D, commitment_weight,
                          device, stream);
}

int rq_quantize_train_plan(int B, int L, int K, int D, int device, long long* out) {
  return rq::describe<true>(B, L, K, D, device, out);
}

const char* rq_quantize_train_error_string(int code) { return rq::error_string(code); }

}  // extern "C"
