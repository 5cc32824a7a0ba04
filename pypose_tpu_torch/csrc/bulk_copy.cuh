// Shared memory filled by the bulk-copy engine (cp.async.bulk), behind
// mbarriers: the helpers the ringed kernels share (knn.cu's scans,
// stencil_cg_tiled.cu's matvec and block-Jacobi apply).  Each is one PTX
// instruction (mbar_wait a bounded loop that traps), so every includer
// compiles them to the same code.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ppt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Orders this thread's reads of shared memory through the generic proxy
// before the async proxy's later writes there (the bulk copy that refills
// a stage): a stage's |b|^2, read by plain loads, was overwritten under
// them at 4096^2, intermittently, without it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// Waits for the completion of the barrier's phase of this parity; traps
// (the launch fails) after 2^26 polls instead of hanging.  The loop is
// PTX's: a C++ loop whose exit differs by thread would put the wgmmas
// after it on a divergent path, which ptxas serializes (C7520).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 67108864;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes from global to shared memory by the bulk-copy engine, counted on
// `bar` (16-byte aligned, a multiple of 16 bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace ppt
