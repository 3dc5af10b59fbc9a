// Shared pieces of the Walsh-Hadamard kernels: the radix-2 butterfly over
// one row held in shared memory, the block shape, and the broadcast
// geometry the fused product receives from its Python wrapper
// (whvi_tpu_torch/ops/fwht_cuda.py).
//
// Layout: a block has kBlockThreads threads. A row of D = 2^log2d floats
// is worked on by tpr = min(D / 2, kBlockThreads) threads, so a block
// holds kBlockThreads / tpr rows: one row for D >= 512, up to 256 rows
// for D = 2. Every row of a block sits in dynamic shared memory at
// row_in_block * D. All threads of a block run every stage, including
// those of rows past the end, so __syncthreads() is always reached by
// the whole block.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace whvi {

constexpr int kBlockThreads = 256;
constexpr int kMaxLog2D = 14;  // D = 16384: 64 KB of shared memory a row

// Element strides of the four operands (x, s1, u, s2, in that order) over
// the output's leading shape, collapsed by the wrapper to at most four
// dims, outermost first. A broadcast axis has stride 0; unused dims have
// size 1. The last (transform) axis of every operand is contiguous.
struct Geometry {
  int64_t size[4];
  int64_t stride[4][4];  // [operand][dim]
};

// Threads per row for a row of 2^log2d elements.
__host__ __device__ inline int threads_per_row(int log2d) {
  const int half = 1 << (log2d - 1);
  return half < kBlockThreads ? half : kBlockThreads;
}

// Radix-2 stages s_begin .. s_end - 1 over `row` (2^log2d floats) in
// shared memory: stage s pairs element j with j + 2^s inside every block
// of 2^(s+1), h = 1 first, the order of the plain version
// (ops/hadamard.py:fwht). Stages 0 .. k-1 apply H_(2^k) to the low k index
// bits, stages k .. log2d-1 the Hadamard factor of the high bits, so a
// range of stages is one Kronecker factor of H_D. Every thread of the
// block must call this; the caller syncs before the first stage.
__device__ __forceinline__ void butterflies(float* row, int log2d, int lane,
                                            int tpr, int s_begin, int s_end) {
  const int half = 1 << (log2d - 1);
  for (int s = s_begin; s < s_end; ++s) {
    const int h = 1 << s;
    for (int p = lane; p < half; p += tpr) {
      const int i0 = ((p >> s) << (s + 1)) | (p & (h - 1));
      const float a = row[i0];
      const float b = row[i0 + h];
      row[i0] = a + b;
      row[i0 + h] = a - b;
    }
    __syncthreads();
  }
}

// All log2d stages: H_D.
__device__ __forceinline__ void butterflies(float* row, int log2d, int lane,
                                            int tpr) {
  butterflies(row, log2d, lane, tpr, 0, log2d);
}

}  // namespace whvi
