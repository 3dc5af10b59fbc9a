// Copy floors of the kernel-diagnosis path, fp32.
//
// Replaces benchmarks/pallas_diag.py:
//   make_hbm_copy (:269): one whole-array HBM -> HBM DMA, the TPU's raw
//     DMA floor. Here a grid-stride copy, 16 bytes a thread, written by
//     hand: the card's streaming floor for the bytes every variant moves.
//   make_copy_2d (:296): the copy in (tb, D) blocks. Here block b copies
//     rows [b*tb, (b+1)*tb), staged through 64 KB of shared memory at a
//     time.
//
// What bounds both on an H100: HBM, 8 bytes an element (one read, one
// write) against 3.35 TB/s. copy_2d also has only B / tb blocks, and its
// staging serialises load and store inside a block.
#include <cstdint>

#include <cuda_runtime.h>

namespace kron_copy {

constexpr int kThreads = 256;
constexpr int kStageFloats = 16384;  // 64 KB of shared memory

__global__ void __launch_bounds__(kThreads)
    hbm_copy_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                    int64_t n4) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x; q < n4; q += stride)
    y[q] = x[q];
}

__global__ void __launch_bounds__(kThreads)
    copy_2d_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                   int64_t tile4) {
  extern __shared__ float4 stage[];
  const float4* xb = x + blockIdx.x * tile4;
  float4* yb = y + blockIdx.x * tile4;
  constexpr int kStage4 = kStageFloats / 4;
  for (int64_t off = 0; off < tile4; off += kStage4) {
    const int n = (int)(tile4 - off < kStage4 ? tile4 - off : kStage4);
    for (int q = threadIdx.x; q < n; q += kThreads) stage[q] = xb[off + q];
    __syncthreads();
    for (int q = threadIdx.x; q < n; q += kThreads) yb[off + q] = stage[q];
    __syncthreads();
  }
}

}  // namespace kron_copy

// x, y contiguous, n fp32 elements, n % 4 == 0. Returns the launch's
// cudaError_t.
extern "C" int copy_hbm_f32(const void* x, void* y, int64_t n, void* stream) {
  using namespace kron_copy;
  if (n < 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n4 = n / 4;
  const int64_t need = (n4 + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 8;  // 8 resident blocks of 256 an SM
  hbm_copy_kernel<<<(unsigned)(need < cap ? need : cap), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), n4);
  return (int)cudaGetLastError();
}

// x, y contiguous (B, D) fp32, D % 4 == 0, B % tb == 0. Returns the
// launch's cudaError_t.
extern "C" int copy_2d_f32(const void* x, void* y, int64_t B, int D, int tb,
                           void* stream) {
  using namespace kron_copy;
  if (B < 0 || D <= 0 || D % 4 != 0 || tb < 1 || B % tb != 0 ||
      B / tb > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int64_t tile4 = (int64_t)tb * D / 4;
  const size_t smem = (size_t)(tile4 < kStageFloats / 4 ? tile4 * 4 : kStageFloats) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        copy_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  copy_2d_kernel<<<(unsigned)(B / tb), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y), tile4);
  return (int)cudaGetLastError();
}
