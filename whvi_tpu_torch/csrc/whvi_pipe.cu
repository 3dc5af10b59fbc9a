// The fused Kronecker product, and a copy, streamed through a two-stage
// shared-memory ring by a persistent kernel.
//
// Replaces benchmarks/pallas_diag.py:
//   make_emit_full (the kernel at :130): k_full's body with x and y
//     streamed through a manual double-buffered emit_pipeline, the
//     diagonals and the H factors resident;
//   make_emit_copy (:322): the same pipeline with y = x.
// The TPU harness paired them: what lies between the two is the compute.
//
// Skeleton: a grid of min(#SMs, B / tb) blocks, one a SM. Block b walks
// the row tiles b, b + grid, ... of tb rows each, a ring stage of up to
// 16384 / D rows at a time (one 64 KB fp32 stage holds one row at
// D = 16384). Every thread issues 16-byte cp.async copies of the next
// stage before the block works on the current one, so one stage's compute
// (or copy-out) overlaps the next stage's load. The compute is the flat
// tensor-core product of kron_core.cuh on its two bf16 buffers: 128 KB of
// ring plus 68 KB, one block an SM.
//
// "Resident" here: H is generated in registers from popcount, so nothing
// is loaded for it. The diagonals (3 x 64 KB at D = 16384) do not fit
// beside the ring and the compute buffers; they are read through the
// L1/L2 caches, where they stay.
//
// What bounds it on an H100: the copy, the 3.35 TB/s of HBM; the product,
// as in whvi_kron.cu's flat layout, its tensor-core work (fragments built
// with scalar shared loads). With B / tb tiles below the SM count, SMs
// stay idle.
//
// Left for later: TMA bulk copies with an mbarrier in place of cp.async,
// a deeper ring, and warp-specialised loading.
#include "kron_core.cuh"

namespace kron {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <bool kCompute>
__global__ void __launch_bounds__(kThreads)
    pipe_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                const float* __restrict__ u, const float* __restrict__ s2,
                float* __restrict__ y, int64_t n_tiles, int log2d, int tb) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [2][kGroupElems]
  bf16* bufA = reinterpret_cast<bf16*>(ring + 2 * kGroupElems);
  const int64_t D = (int64_t)1 << log2d;
  const int rows = min(kGroupElems >> log2d, tb);  // rows a ring stage holds
  const int per_tile = (tb + rows - 1) / rows;
  const int64_t my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int64_t n_groups = my_tiles * per_tile;

  // first row and row count of this block's group j
  auto group = [&](int64_t j, int& nr) {
    const int64_t tile = blockIdx.x + (j / per_tile) * gridDim.x;
    const int sub = (int)(j % per_tile);
    nr = min(rows, tb - sub * rows);
    return tile * tb + (int64_t)sub * rows;
  };
  auto issue = [&](int64_t j) {
    int nr;
    const float* src = x + group(j, nr) * D;
    float* dst = ring + (j & 1) * kGroupElems;
    const int n4 = (int)(((int64_t)nr * D) >> 2);
    for (int q = threadIdx.x; q < n4; q += kThreads) cp_async16(dst + 4 * q, src + 4 * q);
    cp_async_commit();
  };

  if (n_groups > 0) issue(0);
  for (int64_t j = 0; j < n_groups; ++j) {
    if (j + 1 < n_groups) {
      issue(j + 1);  // into the stage that group j - 1 released
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of group j have landed
    int nr;
    float* yg = y + group(j, nr) * D;
    const float* xs = ring + (j & 1) * kGroupElems;
    if constexpr (kCompute) {
      load_scaled_bf16(xs, s2, bufA, nr, log2d);
      flat_group<kFull>(bufA, bufA + kGroupRows * kPitch, yg, nr, log2d, s1, u);
    } else {
      const int n4 = (int)(((int64_t)nr * D) >> 2);
      for (int q = threadIdx.x; q < n4; q += kThreads)
        reinterpret_cast<float4*>(yg)[q] = reinterpret_cast<const float4*>(xs)[q];
      __syncthreads();  // stage j & 1 is free for group j + 2
    }
  }
}

template <bool kCompute>
cudaError_t launch_pipe(const float* x, const float* s1, const float* u,
                        const float* s2, float* y, int64_t B, int log2d,
                        int tb, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = B / tb;
  const unsigned grid = (unsigned)(n_tiles < sms ? n_tiles : sms);
  const size_t smem = 2 * (size_t)kGroupElems * sizeof(float) + (kCompute ? kFlatSmem : 0);
  auto kernel = pipe_kernel<kCompute>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(x, s1, u, s2, y, n_tiles, log2d, tb);
  return cudaGetLastError();
}

}  // namespace kron

// x, y contiguous (B, D = 2^log2d) fp32; with compute, s1, u, s2 (D,) fp32
// and y = s1 * H(u * H(s2 * x)) (kron_core.cuh), else y = x and the
// diagonals are not read. Returns the launch's cudaError_t.
extern "C" int kron_pipe_f32(const void* x, const void* s1, const void* u,
                             const void* s2, void* y, int64_t B, int log2d,
                             int tb, int compute, void* stream) {
  using namespace kron;
  if (!valid_tiling(B, log2d, tb)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const auto* fx = static_cast<const float*>(x);
  const auto* fs1 = static_cast<const float*>(s1);
  const auto* fu = static_cast<const float*>(u);
  const auto* fs2 = static_cast<const float*>(s2);
  auto* fy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (compute) return (int)launch_pipe<true>(fx, fs1, fu, fs2, fy, B, log2d, tb, st);
  return (int)launch_pipe<false>(fx, fs1, fu, fs2, fy, B, log2d, tb, st);
}
