// Shared pieces of the Kronecker-factor kernels: the row-group layout, the
// stage codes and the tiling check. The tensor-core products (k_mm1,
// k_mm2 and the whole product of k_full, k_flat, emit_full) run in
// whvi_full.cu on wgmma; the kernels of k_cur and k_swap hold their rows
// in registers on fwht_core.cuh instead.
//
// The product y = s1 * H(u * H(s2 * x)) is computed on a row of
// D = a * 128 elements viewed as an (a, 128) matrix T[i][k] = row[i*128+k],
// with H_D = H_a (x) H_128. The operand of every factor contraction is
// rounded to bf16 (H is +-1 and exact in bf16) and the contraction
// accumulates in fp32, in the order of the TPU bodies
// (benchmarks/pallas_diag.py:k_full): R(s2*x) @ H_128, then H_a over i,
// then * u, H_a over i, H_128 over k, and * s1. k_mm1 stops after the
// first contraction, k_mm2 after the second.
//
// Row groups. A group is kGroupElems = 16384 elements, so it holds 16384 /
// D rows (one row at D = 16384, 128 rows at D = 128) and always 128
// "lane-rows" of 128 elements. Why 16384: one fp32 row at D = 16384 is 64
// KB, and a group is then a 128 x 128 matrix, one wgmma tile
// (whvi_full.cu).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kron {

using bf16 = __nv_bfloat16;

constexpr int kLane = 128;  // the last factor, H_128
constexpr int kThreads = 256;
constexpr int kGroupElems = 16384;
constexpr int kGroupRows = kGroupElems / kLane;  // lane-rows in a group
constexpr int kMinLog2D = 7;   // D = 128: a = 1
constexpr int kMaxLog2D = 14;  // D = 16384: a = 128

enum Stage { kCopy = 0, kScale = 1, kMm1 = 2, kMm2 = 3, kFull = 4 };

// bf16 bits of H[i][j] = (-1)^popcount(i & j)
__device__ __forceinline__ uint32_t sign_bits(int i, int j) {
  return 0x3F80u | ((uint32_t)(__popc(i & j) & 1) << 15);
}

// Rejects what the kernels do not take: D outside [128, 16384], a row
// tile that does not divide B, or more tiles than a grid can hold.
__host__ inline bool valid_tiling(int64_t B, int log2d, int tb) {
  return log2d >= kMinLog2D && log2d <= kMaxLog2D && tb >= 1 && B >= 0 &&
         B % tb == 0 && B / tb <= 0x7fffffff;
}

}  // namespace kron
