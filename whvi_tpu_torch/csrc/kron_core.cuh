// Shared pieces of the Kronecker-factor kernels (whvi_kron.cu,
// whvi_pipe.cu): the tensor-core factor contractions, the bf16 rounding
// and the row-group layout in shared memory.
//
// The product y = s1 * H(u * H(s2 * x)) is computed on a row of
// D = a * 128 elements viewed as an (a, 128) matrix T[i][k] = row[i*128+k],
// with H_D = H_a (x) H_128. The operand of every factor contraction is
// rounded to bf16 (H is +-1 and exact in bf16) and the contraction
// accumulates in fp32, in the order of the TPU bodies
// (benchmarks/pallas_diag.py:k_full): R(s2*x) @ H_128, then H_a over i,
// then * u, H_a over i, H_128 over k, and * s1. H is never loaded: each
// fragment's signs come from popcount(i & j).
//
// Row groups. A block works on its rows a group at a time. A group is
// kGroupElems = 16384 elements, so it holds 16384 / D rows (one row at
// D = 16384, 128 rows at D = 128) and always 128 "lane-rows" of 128
// elements. Why 16384: one fp32 row at D = 16384 is 64 KB, and the
// tensor-core path keeps a group twice in bf16 (ping and pong buffers of
// 128 lane-rows at a pitch of 136 elements, 68 KB together), which leaves
// room for the pipelined kernel's two fp32 ring stages (128 KB) inside
// the 227 KB a block may use.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kron {

using bf16 = __nv_bfloat16;

constexpr int kLane = 128;  // the last factor, H_128
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupElems = 16384;
constexpr int kGroupRows = kGroupElems / kLane;  // lane-rows in a group
// bf16 pitch of a lane-row: 272 bytes, so the 8 lane-rows that one mma
// fragment reads start in 8 different 4-bank groups (no bank conflicts).
constexpr int kPitch = kLane + 8;
constexpr int kMinLog2D = 7;   // D = 128: a = 1
constexpr int kMaxLog2D = 14;  // D = 16384: a = 128
constexpr size_t kFlatSmem = 2 * (size_t)kGroupRows * kPitch * sizeof(bf16);

enum Stage { kCopy = 0, kScale = 1, kMm1 = 2, kMm2 = 3, kFull = 4 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16 bits of H[i][j] = (-1)^popcount(i & j)
__device__ __forceinline__ uint32_t sign_bits(int i, int j) {
  return 0x3F80u | ((uint32_t)(__popc(i & j) & 1) << 15);
}

// H_n[i][j] (low half) and H_n[i][j+1] (high half); 0 outside n x n
__device__ __forceinline__ uint32_t h_pair(int i, int j, int n) {
  const uint32_t lo = (i < n && j < n) ? sign_bits(i, j) : 0u;
  const uint32_t hi = (i < n && j + 1 < n) ? sign_bits(i, j + 1) : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t bits(bf16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store_f32x2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// D (16x8, fp32) += A (16x16, bf16, row-major) * B (16x8, bf16, col-major).
// Fragments (PTX ISA, mma.m16n8k16), g = lane / 4, t = lane % 4:
//   a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..],
//   a[3] = A[g+8][2t+8..]; b[0] = B[2t..2t+1][g], b[1] = B[2t+8..][g];
//   c[0..1] = D[g][2t..2t+1], c[2..3] = D[g+8][2t..2t+1].
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out[m][k] = sum_j in[m][j] * H_128[j][k] for lane-rows m < m_rows, with
// in a bf16 buffer at pitch kPitch. Each warp takes 16-row slabs of the
// output (16 n-tiles of 8, 64 fp32 accumulators a thread) and hands
// epi(m, k, out[m][k], out[m][k+1]) each pair it owns.
template <class Epi>
__device__ __forceinline__ void contract_last(const bf16* in, int m_rows,
                                              Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int m0 = warp * 16; m0 < m_rows; m0 += kWarps * 16) {
    float acc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const int r0 = m0 + g, r1 = r0 + 8;
    const bool v0 = r0 < m_rows, v1 = r1 < m_rows;
#pragma unroll 1
    for (int k0 = 0; k0 < kLane; k0 += 16) {
      const int c = k0 + 2 * t;
      uint32_t a[4];
      a[0] = v0 ? *reinterpret_cast<const uint32_t*>(in + r0 * kPitch + c) : 0u;
      a[1] = v1 ? *reinterpret_cast<const uint32_t*>(in + r1 * kPitch + c) : 0u;
      a[2] = v0 ? *reinterpret_cast<const uint32_t*>(in + r0 * kPitch + c + 8) : 0u;
      a[3] = v1 ? *reinterpret_cast<const uint32_t*>(in + r1 * kPitch + c + 8) : 0u;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int n = nt * 8 + g;  // H is symmetric: B[j][n] = H[n][j]
        const uint32_t b[2] = {h_pair(n, c, kLane), h_pair(n, c + 8, kLane)};
        mma_bf16(acc[nt], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int k = nt * 8 + 2 * t;
      if (v0) epi(r0, k, acc[nt][0], acc[nt][1]);
      if (v1) epi(r1, k, acc[nt][2], acc[nt][3]);
    }
  }
}

// in[j][k] (low half) and in[j+1][k] (high half) of one row's (a, 128)
// matrix; 0 for j >= a
__device__ __forceinline__ uint32_t col_pair(const bf16* base, int j, int k,
                                             int a) {
  const uint32_t lo = j < a ? bits(base[j * kPitch + k]) : 0u;
  const uint32_t hi = j + 1 < a ? bits(base[(j + 1) * kPitch + k]) : 0u;
  return lo | (hi << 16);
}

// out[r][i][k] = sum_j H_a[i][j] * in[r][j][k] for each of the nr rows of
// the group (lane-row r*a + j of in). A row's (a, 128) matrix is padded
// to 16-row tiles with zeros when a < 16. Each warp takes (row, 16-row
// slab) pairs; epi gets the flat lane-row m = r*a + i.
template <class Epi>
__device__ __forceinline__ void contract_first(const bf16* in, int nr, int a,
                                               Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = (a + 15) >> 4;
  for (int slab = warp; slab < nr * mtiles; slab += kWarps) {
    const int r = slab / mtiles;
    const int i_lo = (slab % mtiles) * 16 + g, i_hi = i_lo + 8;
    const bf16* base = in + (size_t)r * a * kPitch;
    float acc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 1
    for (int j0 = 0; j0 < a; j0 += 16) {
      const int c = j0 + 2 * t;
      const uint32_t h[4] = {h_pair(i_lo, c, a), h_pair(i_hi, c, a),
                             h_pair(i_lo, c + 8, a), h_pair(i_hi, c + 8, a)};
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int k = nt * 8 + g;
        const uint32_t b[2] = {col_pair(base, c, k, a),
                               col_pair(base, c + 8, k, a)};
        mma_bf16(acc[nt], h, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int k = nt * 8 + 2 * t;
      if (i_lo < a) epi(r * a + i_lo, k, acc[nt][0], acc[nt][1]);
      if (i_hi < a) epi(r * a + i_hi, k, acc[nt][2], acc[nt][3]);
    }
  }
}

// dst (bf16 lane-rows at kPitch) = R(src * s2) for the nr rows of a group;
// src is fp32, contiguous, in global or shared memory. Ends in a barrier.
__device__ __forceinline__ void load_scaled_bf16(const float* src,
                                                 const float* __restrict__ s2,
                                                 bf16* dst, int nr,
                                                 int log2d) {
  const int n4 = (nr << log2d) >> 2;
  const int dmask = (1 << log2d) - 1;
  for (int q = threadIdx.x; q < n4; q += kThreads) {
    const int e = q << 2;
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    const float4 s = __ldg(reinterpret_cast<const float4*>(s2 + (e & dmask)));
    bf16* d = dst + (e >> 7) * kPitch + (e & (kLane - 1));
    store_bf16x2(d, v.x * s.x, v.y * s.y);
    store_bf16x2(d + 2, v.z * s.z, v.w * s.w);
  }
  __syncthreads();
}

// The flat (tensor-core) layout on one group whose R(s2*x) is in bufA:
// kMm1 writes y = R(s2*x) @ H_128, kMm2 y = H_D(s2*x) with the second
// rounding, kFull the whole product. y points at the group's first row;
// bufB is the second buffer. Ends in a barrier.
template <int kStage>
__device__ __forceinline__ void flat_group(bf16* bufA, bf16* bufB, float* y,
                                           int nr, int log2d,
                                           const float* __restrict__ s1,
                                           const float* __restrict__ u) {
  const int a = 1 << (log2d - 7);
  const int amask = a - 1;
  const int m_rows = nr * a;
  auto to_y = [&](int m, int k, float v0, float v1) {
    store_f32x2(y + (size_t)m * kLane + k, v0, v1);
  };
  auto to_bufB = [&](int m, int k, float v0, float v1) {
    store_bf16x2(bufB + m * kPitch + k, v0, v1);
  };
  if constexpr (kStage == kMm1) {
    contract_last(bufA, m_rows, to_y);
  } else {
    contract_last(bufA, m_rows, to_bufB);
    __syncthreads();
    if constexpr (kStage == kMm2) {
      contract_first(bufB, nr, a, to_y);
    } else {
      contract_first(bufB, nr, a, [&](int m, int k, float v0, float v1) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(
            u + (m & amask) * kLane + k));
        store_bf16x2(bufA + m * kPitch + k, v0 * w.x, v1 * w.y);
      });
      __syncthreads();
      contract_first(bufA, nr, a, to_bufB);
      __syncthreads();
      contract_last(bufB, m_rows, [&](int m, int k, float v0, float v1) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(
            s1 + (m & amask) * kLane + k));
        store_f32x2(y + (size_t)m * kLane + k, v0 * w.x, v1 * w.y);
      });
    }
  }
  __syncthreads();
}

// Rejects what the kernels do not take: D outside [128, 16384], a row
// tile that does not divide B, or more tiles than a grid can hold.
__host__ inline bool valid_tiling(int64_t B, int log2d, int tb) {
  return log2d >= kMinLog2D && log2d <= kMaxLog2D && tb >= 1 && B >= 0 &&
         B % tb == 0 && B / tb <= 0x7fffffff;
}

}  // namespace kron
