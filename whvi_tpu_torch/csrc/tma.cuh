// Hopper's bulk copies between global and shared memory (the Tensor
// Memory Accelerator without a tensor map) and the mbarriers that report
// their completion, as inline PTX for sm_90.
//
// A load is issued by one thread: it arms the stage's mbarrier with the
// bytes to expect (arrive_expect_tx), then asks the TMA unit for the copy
// (bulk_load), which counts those bytes off the barrier as they land. A
// waiter spins on the barrier's phase parity (wait_parity): phase k of a
// barrier armed once per fill completes when the k-th fill has landed, so
// the k-th wait passes parity k & 1. A barrier initialised with n
// arrivals may count threads instead (barrier_arrive): a ring's "stage
// free" barrier counts the warps that have read the stage. A store
// (bulk_store) goes into the issuing thread's current bulk group;
// bulk_commit closes the group, and bulk_wait_read<N> returns once at
// most N of that thread's committed groups still read shared memory, so a
// stage may be refilled; bulk_wait_all once every group has also written
// global memory. Shared memory written by threads reaches a bulk store
// only after fence_proxy_async in each writer and a barrier between the
// writers and the issuing thread.
//
// Rules of the hardware: sizes and both addresses are multiples of 16
// bytes; an mbarrier counts at most 2^20 - 1 bytes a phase.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Init with one expected arrival a phase; then fence_barrier_init() before
// the async proxy (the TMA unit) may signal it.
__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's view of shared memory before the async proxy's
// next access to it (a bulk store of what a bulk load wrote).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival on `bar` (release: this thread's earlier shared-memory
// accesses are done before a waiter on the phase goes on).
__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` counted off `bar` as they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global, in the current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// every committed group done, its global writes included
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace tma
