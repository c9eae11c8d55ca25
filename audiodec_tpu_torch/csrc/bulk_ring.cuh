// The mbarrier and bulk-copy (TMA, non-tensor) primitives of a ring of
// shared-memory stages on Hopper (sm_90a): a producer thread arms a
// stage's `full` barrier with the bytes it expects and issues one
// `cp.async.bulk` into the stage; consumers wait on the barrier's phase
// and release the stage on its `empty` barrier.  Used by dot_chain.cu and
// rvq_encode.cu.
//
// A header of device functions only, included by each source; the build
// (ops/kernels/_build.py) hashes it with every source.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk_ring {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed; a wait that has
// not completed in 2^34 cycles (several seconds) traps rather than hangs
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// the barriers' initialisation, visible to the async proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

}  // namespace bulk_ring
