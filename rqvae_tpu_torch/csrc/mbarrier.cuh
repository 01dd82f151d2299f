// mbarriers and the bulk copies that complete on them (sm_90), shared by
// csrc/flash_attention_small_fwd.cu (TMA tensor copies of q / K / V tiles)
// and csrc/rq_common.cuh (bulk copies of codebook slices).
//
// A copy issued by the async proxy (cp.async.bulk, TMA) counts its bytes on
// an mbarrier in shared memory; a waiter spins on the barrier's phase
// parity. A barrier's first phase has parity 0.
#pragma once

#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// the initialised barriers made visible to the async proxy (the copies)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival on bar, which also expects ``bytes`` more to land on it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// one arrival on bar
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait for the phase of bar with this parity to complete (on a barrier that
// has not completed a phase yet, parity 1 passes at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from global
// memory into this CTA's shared memory by the TMA unit, counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace hopper
