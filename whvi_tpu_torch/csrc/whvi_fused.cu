// Fused WHVI structured product y = s1 * H(u * H(s2 * x)), fp32.
//
// Replaces the Pallas kernels of whvi_tpu/ops/fwht_pallas.py:
//   _kernel_1f_y / _kernel_2f_y  (y only; WANT_RESIDUALS = false),
//   _kernel_1f   / _kernel_2f    (y plus i1 = H(s2*x), i2 = H(u*i1)),
// and, launched on (s2, u, s1, g), the transform half of _bwd.
// The TPU kernels spend two dense MXU matmuls per transform (H_D, or
// H_a (x) H_128 for D > 1024) because the v5e's matrix unit is what it is
// good at. Here each transform is log2 D radix-2 butterfly stages in
// shared memory: adds and subtracts only, so the result is true fp32 (the
// counterpart of the TPU's "highest" mode) and D runs from 2 to 16384
// with one code path.
//
// Broadcasting: x and the three diagonals are read through per-operand
// leading strides (0 on a broadcast axis), so the stacked matrix's
// (stack, D) diagonals, a per-sample or per-row u, and an x shared across
// the stack are never materialized per row. Each row computes its four
// base offsets once, in int64.
//
// What bounds it on an H100: memory. Per element it reads x and the
// diagonals (about 2 reads of 4 bytes once the broadcast diagonals hit in
// L1/L2) and writes y, plus i1 and i2 with residuals (1-3 writes), against
// about 2 log2 D adds: far below the card's compute-to-bandwidth ratio.
// The design keeps the whole row in shared memory between the two
// transforms, so each element crosses device memory once in and once per
// output.
//
// Left for later: the butterfly as mma/wgmma Kronecker factors (as the
// TPU kernel does on its MXU), TMA loads of the rows, register-resident
// first stages for small D, and fusing the backward's batch reductions.
#include "fwht_core.cuh"

namespace whvi {

template <bool kResiduals>
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
    buf[e] = active ? x[off[0] + e] * s2[off[3] + e] : 0.f;
  }
  __syncthreads();
  butterflies(buf, log2d, lane, tpr);

  for (int e = lane; e < D; e += tpr) {
    if (active) {
      const float v = buf[e];
      if (kResiduals) i1[out + e] = v;
      buf[e] = v * u[off[2] + e];
    }
  }
  __syncthreads();
  butterflies(buf, log2d, lane, tpr);

  for (int e = lane; e < D; e += tpr) {
    if (active) {
      const float v = buf[e];
      if (kResiduals) i2[out + e] = v;
      y[out + e] = v * s1[off[1] + e];
    }
  }
}

template <bool kResiduals>
cudaError_t launch_fused(const float* x, const float* s1, const float* u,
                         const float* s2, float* y, float* i1, float* i2,
                         int64_t n_rows, int log2d, const Geometry& geom,
                         cudaStream_t stream) {
  const int rows_per_block = kBlockThreads / threads_per_row(log2d);
  const size_t smem = (size_t)rows_per_block * ((size_t)1 << log2d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        whvi_fused_kernel<kResiduals>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  whvi_fused_kernel<kResiduals><<<(unsigned)blocks, kBlockThreads, smem, stream>>>(
      x, s1, u, s2, y, i1, i2, n_rows, log2d, geom);
  return cudaGetLastError();
}

}  // namespace whvi

// y (and, when want_residuals, i1 and i2) are contiguous (n_rows, D).
// Returns the launch's cudaError_t (0 on success).
extern "C" int whvi_fused_f32(const void* x, const void* s1, const void* u,
                              const void* s2, void* y, void* i1, void* i2,
                              int want_residuals, int64_t n_rows, int log2d,
                              const whvi::Geometry* geom, void* stream) {
  if (log2d < 1 || log2d > whvi::kMaxLog2D || n_rows < 0 ||
      n_rows > (int64_t)0x7fffffff * (whvi::kBlockThreads / whvi::threads_per_row(log2d)))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const auto* fx = static_cast<const float*>(x);
  const auto* fs1 = static_cast<const float*>(s1);
  const auto* fu = static_cast<const float*>(u);
  const auto* fs2 = static_cast<const float*>(s2);
  auto* fy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (want_residuals) {
    return (int)whvi::launch_fused<true>(fx, fs1, fu, fs2, fy,
                                         static_cast<float*>(i1),
                                         static_cast<float*>(i2), n_rows,
                                         log2d, *geom, st);
  }
  return (int)whvi::launch_fused<false>(fx, fs1, fu, fs2, fy, nullptr, nullptr,
                                        n_rows, log2d, *geom, st);
}
