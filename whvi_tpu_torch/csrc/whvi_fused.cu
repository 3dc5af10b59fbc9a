// Fused WHVI structured product y = s1 * H(u * H(s2 * x)), fp32 storage,
// in both operand precisions of the Pallas kernels it replaces.
//
// Replaces the Pallas kernels of whvi_tpu/ops/fwht_pallas.py:
//   _kernel_1f_y / _kernel_2f_y  (y only; kResiduals = false),
//   _kernel_1f   / _kernel_2f    (y plus i1 = H(s2*x), i2 = H(u*i1)),
// and, launched on (s2, u, s1, g), the transform half of _bwd.
// The TPU kernels spend two dense MXU matmuls per transform (H_D, or
// H_a (x) H_128 for D > 1024) because the v5e's matrix unit is what it is
// good at. Here each transform is log2 D radix-2 butterfly stages in
// shared memory, adds and subtracts only, with one code path for D from 2
// to 16384.
//
// Precision: the Pallas kernels take precision="fp32" | "bf16"; "bf16" is
// the default of _fused_raw and whvi_mul_pallas (fwht_pallas.py:259-260,
// :385) and the only mode the JAX main path reaches (whvi_op.py:172).
// - kBf16 = false reproduces precision="fp32" (H stored fp32, matmuls at
//   Precision.HIGHEST): nothing is rounded below fp32.
// - kBf16 = true reproduces precision="bf16" (4 <= D <= 16384): the
//   operand of every contraction is rounded to bf16 (R, to nearest even,
//   as _dot/_dotg's astype, fwht_pallas.py:93-149) and the sums stay fp32:
//     D <= 1024 (_kernel_1f*, one factor):  i1 = H_D R(s2 x),
//                                           i2 = H_D R(u i1);
//     D >= 2048 (_kernel_2f*, H_D = H_a (x) H_128, a = D / 128):
//       i1 = H_a R(H_128 R(s2 x)),  i2 = H_128 R(H_a R(u i1)),
//   H_128 being butterfly stages 0-6 (the low 7 index bits) and H_a the
//   stages above. The second transform contracts H_a first, as
//   _kernel_2f's does. i1 and i2 are the fp32 sums, stored unrounded and in
//   natural layout (the TPU's swapped i1 layout is not ported). The sums of
//   +-1 * bf16 values run in another order than the MXU's, so a sum can
//   land on the other side of a bf16 rounding boundary; ops/fwht_cuda.py
//   (bf16_tol) states what that allows.
//
// Broadcasting: x and the three diagonals are read through per-operand
// leading strides (0 on a broadcast axis), so the stacked matrix's
// (stack, D) diagonals, a per-sample or per-row u, and an x shared across
// the stack are never materialized per row. Each row computes its four
// base offsets once, in int64.
//
// What bounds it on an H100: not memory. Per element it reads x and the
// diagonals (about 2 reads of 4 bytes once the broadcast diagonals hit in
// L1/L2) and writes y, plus i1 and i2 with residuals, against about
// 2 log2 D shared-memory adds, each stage behind a block barrier: at
// D = 4096 K1 reaches 0.17 of HBM (PERF.md). The design keeps the whole
// row in shared memory between the two transforms, so each element
// crosses device memory once in and once per output; the bf16 mode adds
// two rounding passes over the row (D >= 2048) and four rounded writes.
//
// Left for later: the butterfly as mma/wgmma Kronecker factors (as the
// TPU kernel does on its MXU; bf16 operands make that exact here), TMA
// loads of the rows, register-resident first stages for small D, and
// fusing the backward's batch reductions.
#include <cuda_bf16.h>

#include "fwht_core.cuh"

namespace whvi {

constexpr int kLaneLog2 = 7;        // H_128, the TPU's lane factor
constexpr int kOneFactorLog2 = 10;  // D <= 1024: one factor (_factor_pair)

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Round the row to bf16 in place, then sync. Every thread of the block
// calls it.
__device__ __forceinline__ void round_row(float* row, int D, int lane, int tpr) {
  for (int e = lane; e < D; e += tpr) row[e] = round_bf16(row[e]);
  __syncthreads();
}

template <bool kResiduals, bool kBf16>
__global__ void __launch_bounds__(kBlockThreads)
    whvi_fused_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                      const float* __restrict__ u, const float* __restrict__ s2,
                      float* __restrict__ y, float* __restrict__ i1,
                      float* __restrict__ i2, int64_t n_rows, int log2d,
                      Geometry geom) {
  extern __shared__ float smem[];
  const int D = 1 << log2d;
  const int tpr = threads_per_row(log2d);
  const int local_row = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const int64_t row = (int64_t)blockIdx.x * (kBlockThreads / tpr) + local_row;
  const bool active = row < n_rows;
  float* buf = smem + (size_t)local_row * D;
  // bf16 with two factors: stages [0, lo) are H_128, [lo, log2d) are H_a
  const bool two_factor = kBf16 && log2d > kOneFactorLog2;
  const int lo = two_factor ? kLaneLog2 : log2d;

  // base offsets of x, s1, u, s2 for this row
  int64_t off[4] = {0, 0, 0, 0};
  if (active) {
    int64_t r = row;
    for (int d = 3; d >= 0; --d) {
      const int64_t idx = r % geom.size[d];
      r /= geom.size[d];
      for (int k = 0; k < 4; ++k) off[k] += idx * geom.stride[k][d];
    }
  }
  const int64_t out = row * D;

  for (int e = lane; e < D; e += tpr) {
    const float v = active ? x[off[0] + e] * s2[off[3] + e] : 0.f;
    buf[e] = kBf16 ? round_bf16(v) : v;
  }
  __syncthreads();
  // first transform: H_128 then H_a (or H_D whole)
  butterflies(buf, log2d, lane, tpr, 0, lo);
  if (two_factor) {
    round_row(buf, D, lane, tpr);
    butterflies(buf, log2d, lane, tpr, lo, log2d);
  }

  for (int e = lane; e < D; e += tpr) {
    if (active) {
      const float v = buf[e];
      if (kResiduals) i1[out + e] = v;
      const float t = v * u[off[2] + e];
      buf[e] = kBf16 ? round_bf16(t) : t;
    }
  }
  __syncthreads();
  // second transform: H_a then H_128 (or H_D whole)
  if (two_factor) {
    butterflies(buf, log2d, lane, tpr, lo, log2d);
    round_row(buf, D, lane, tpr);
    butterflies(buf, log2d, lane, tpr, 0, lo);
  } else {
    butterflies(buf, log2d, lane, tpr);
  }

  for (int e = lane; e < D; e += tpr) {
    if (active) {
      const float v = buf[e];
      if (kResiduals) i2[out + e] = v;
      y[out + e] = v * s1[off[1] + e];
    }
  }
}

template <bool kResiduals, bool kBf16>
cudaError_t launch_fused(const float* x, const float* s1, const float* u,
                         const float* s2, float* y, float* i1, float* i2,
                         int64_t n_rows, int log2d, const Geometry& geom,
                         cudaStream_t stream) {
  const int rows_per_block = kBlockThreads / threads_per_row(log2d);
  const size_t smem = (size_t)rows_per_block * ((size_t)1 << log2d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        whvi_fused_kernel<kResiduals, kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  whvi_fused_kernel<kResiduals, kBf16><<<(unsigned)blocks, kBlockThreads, smem, stream>>>(
      x, s1, u, s2, y, i1, i2, n_rows, log2d, geom);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const float*, const float*, const float*,
                                 const float*, float*, float*, float*, int64_t,
                                 int, const Geometry&, cudaStream_t);

// [want_residuals][bf16]
const LaunchFn kLaunch[2][2] = {
    {launch_fused<false, false>, launch_fused<false, true>},
    {launch_fused<true, false>, launch_fused<true, true>},
};

}  // namespace whvi

// y (and, when want_residuals, i1 and i2) are contiguous (n_rows, D).
// bf16 selects the Pallas kernels' precision="bf16" (D >= 4), else "fp32".
// Returns the launch's cudaError_t (0 on success).
extern "C" int whvi_fused_f32(const void* x, const void* s1, const void* u,
                              const void* s2, void* y, void* i1, void* i2,
                              int want_residuals, int bf16, int64_t n_rows,
                              int log2d, const whvi::Geometry* geom,
                              void* stream) {
  if (log2d < (bf16 ? 2 : 1) || log2d > whvi::kMaxLog2D || n_rows < 0 ||
      n_rows > (int64_t)0x7fffffff * (whvi::kBlockThreads / whvi::threads_per_row(log2d)))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  return (int)whvi::kLaunch[want_residuals != 0][bf16 != 0](
      static_cast<const float*>(x), static_cast<const float*>(s1),
      static_cast<const float*>(u), static_cast<const float*>(s2),
      static_cast<float*>(y), static_cast<float*>(i1), static_cast<float*>(i2),
      n_rows, log2d, *geom, static_cast<cudaStream_t>(stream));
}
