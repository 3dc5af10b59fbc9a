// Hopper's warpgroup matrix multiply (wgmma.mma_async, sm_90a) on bf16
// operands in shared memory, fp32 accumulators in registers, as inline
// PTX.
//
// A warpgroup is four consecutive warps whose first warp index is a
// multiple of 4. Its 128 threads issue each wgmma together; the product
// runs asynchronously: fence() before the first wgmma of a batch (and
// whenever the accumulators were touched by other instructions since),
// commit() closes the batch into a group, wait<N>() returns once at most N
// of the warpgroup's groups are still running. fence_operand() keeps the
// compiler from moving reads or writes of the accumulators across those.
//
// Operands are read through 64-bit matrix descriptors (smem_desc): the
// shared-memory address of the operand's first element, and two strides,
// in the canonical layouts with the 128-byte swizzle:
//   K-major (the reduction index contiguous): rows of the M or N index 128
//     bytes apart, 64 bf16 of K a row; each row's eight 16-byte groups are
//     stored at group ^ (row & 7) (the swizzle, on address bits 4-6 against
//     bits 7-9, so the atom of 8 rows must start on 1024 bytes). SBO is the
//     step to the next 8 rows; LBO is unused. A k16 step inside the 64 is
//     32 bytes added to the start address.
//   MN-major (read with the transpose flag, bf16 and fp16 only): rows of
//     the K index 128 bytes apart, 64 elements of M or N a row, the same
//     swizzle. SBO is the step to the next 8 K-rows, LBO the step to the
//     next 64 elements of M or N.
#pragma once

#include <cstdint>

namespace wgmma {

// byte strides encoded in 16-byte units; layout type 1: 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t smem_addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) = A (64 x 16) * B (16 x 128) + (accumulate ? d : 0),
// both bf16 from shared memory: A K-major, B K-major (kTransB false) or
// MN-major (kTransB true). Thread t of the warpgroup holds, in d[4n + r],
// row 16 (t / 32) + (t % 32) / 4 + 8 (r / 2), column 8n + 2 (t % 4) + r % 2.
template <bool kTransB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                               bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"((int)accumulate), "n"((int)kTransB));
}

}  // namespace wgmma
