// Bare batched FWHT y = x @ H_D along the last axis, fp32.
//
// Replaces _kernel_1f_t and _kernel_2f_t of whvi_tpu/ops/fwht_pallas.py
// (launched by _fwht_raw / fwht_pallas, whose VJP is the transform
// itself). On the main path it carries ColumnMatrix.column_given_g, the
// n_out == 1 head, forward and backward.
//
// The TPU kernels run the transform as one or two dense MXU matmuls.
// Here it is log2 D radix-2 butterfly stages on one row in shared memory
// (fwht_core.cuh): adds and subtracts only, D from 2 to 16384. Nothing is
// rounded below fp32, which is fwht_pallas's own default,
// precision="fp32" (H stored fp32, Precision.HIGHEST).
//
// What bounds it on an H100: memory. One read and one write of 4 bytes
// per element against log2 D adds. Small D packs many rows into a block
// so that a block is not a handful of active threads.
//
// Left for later: mma/wgmma Kronecker factors, TMA loads, and the first
// stages in registers for small D.
#include "fwht_core.cuh"

namespace whvi {

__global__ void __launch_bounds__(kBlockThreads)
    fwht_kernel(const float* __restrict__ x, float* __restrict__ y,
                int64_t n_rows, int log2d) {
  extern __shared__ float smem[];
  const int D = 1 << log2d;
  const int tpr = threads_per_row(log2d);
  const int local_row = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const int64_t row = (int64_t)blockIdx.x * (kBlockThreads / tpr) + local_row;
  const bool active = row < n_rows;
  float* buf = smem + (size_t)local_row * D;
  const int64_t base = row * D;

  for (int e = lane; e < D; e += tpr) buf[e] = active ? x[base + e] : 0.f;
  __syncthreads();
  butterflies(buf, log2d, lane, tpr);
  if (active) {
    for (int e = lane; e < D; e += tpr) y[base + e] = buf[e];
  }
}

}  // namespace whvi

// x and y are contiguous (n_rows, D). Returns the launch's cudaError_t.
extern "C" int fwht_f32(const void* x, void* y, int64_t n_rows, int log2d,
                        void* stream) {
  using namespace whvi;
  if (log2d < 1 || log2d > kMaxLog2D || n_rows < 0 ||
      n_rows > (int64_t)0x7fffffff * (kBlockThreads / threads_per_row(log2d)))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int rows_per_block = kBlockThreads / threads_per_row(log2d);
  const size_t smem = (size_t)rows_per_block * ((size_t)1 << log2d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwht_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  fwht_kernel<<<(unsigned)blocks, kBlockThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n_rows, log2d);
  return (int)cudaGetLastError();
}
