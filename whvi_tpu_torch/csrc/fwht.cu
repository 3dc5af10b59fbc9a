// Bare batched FWHT y = x @ H_D along the last axis, in fp32 storage
// (fwht_f32) and in bf16 storage (fwht_bf16s).
//
// Replaces _kernel_1f_t and _kernel_2f_t of whvi_tpu/ops/fwht_pallas.py
// (launched by _fwht_raw / fwht_pallas, whose VJP is the transform
// itself). On the main path it carries ColumnMatrix.column_given_g, the
// n_out == 1 head, forward and backward.
//
// The TPU kernels run the transform as one or two dense MXU matmuls.
// Here it is log2 D radix-2 butterfly stages held in registers between a
// few shared-memory exchanges (fwht_core.cuh): adds and subtracts only, D
// from 2 to 16384, in the plain version's order, so the result equals
// fwht_plain's bit for bit. Nothing is rounded below fp32, which is
// fwht_pallas's own default, precision="fp32" (H stored fp32,
// Precision.HIGHEST).
//
// bf16 storage: rows load as bf16, 4 to an 8-byte access (fwht_core.cuh),
// the transform sums in fp32 registers and the store rounds once to bf16
// (nearest even): R(H x), what the JAX package's fwht computes on bf16
// leaves (fp32 accumulation, one cast) and what the column head of a
// bf16 net runs (whvi_tpu/models/weights.py:341-346). Bit for bit the
// plain version's, which transforms in fp32 and rounds once.
//
// What bounds it on an H100: memory. One read and one write of 4 bytes
// per element, in 16-byte accesses, against log2 D adds. Small D packs
// many rows into a block so that a block is not a handful of active
// threads.
//
// Left for later: TMA loads, and mma/wgmma Kronecker factors.
#include "fwht_core.cuh"

namespace whvi {

template <int L, typename T>
__global__ void __launch_bounds__(RowShape<L>::kBlock, RowShape<L>::kMinBlocks)
    fwht_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n_rows) {
  using S = RowShape<L>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int64_t row = (int64_t)blockIdx.x * S::kRows + tid / S::kTpr;
  const bool active = row < n_rows;
  const int64_t at = (row << L) + (tid % S::kTpr) * 4;  // the thread's first group of 4
  RowExchange<L> ex{smem, tid};

  float v[S::R];
  if (active) {
    load_regs<S::R, S::kTpr>(v, x + at);
  } else {
#pragma unroll
    for (int j = 0; j < S::R; ++j) v[j] = 0.f;
  }
  butterflies<L, kSplit, 0, L, 1>(v, ex);
  to_io_window<L, S::after(kSplit, 0, L, 1)>(v, ex);
  if (active) store_regs<S::R, S::kTpr>(y + at, v);
}

// The launch at L = log2 D.
template <typename T>
struct FwhtLaunch {
  const T* x;
  T* y;
  int64_t n_rows;
  cudaStream_t stream;

  template <int L>
  cudaError_t operator()() const {
    using S = RowShape<L>;
    const size_t smem = exchange_bytes(L);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fwht_kernel<L, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    const int64_t blocks = (n_rows + S::kRows - 1) / S::kRows;
    fwht_kernel<L, T><<<(unsigned)blocks, S::kBlock, smem, stream>>>(x, y, n_rows);
    return cudaGetLastError();
  }
};

}  // namespace whvi

// x and y are contiguous (n_rows, D), x starting on a multiple of
// min(D, 4) floats (the wrapper checks). Returns the launch's cudaError_t.
extern "C" int fwht_f32(const void* x, void* y, int64_t n_rows, int log2d,
                        void* stream) {
  using namespace whvi;
  if (log2d < 1 || log2d > kMaxLog2D || n_rows < 0 ||
      n_rows > (int64_t)0x7fffffff * rows_per_block(log2d))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const FwhtLaunch<float> launch{static_cast<const float*>(x), static_cast<float*>(y), n_rows,
                                 static_cast<cudaStream_t>(stream)};
  return (int)dispatch_log2d(log2d, launch);
}

// bf16 storage: x and y contiguous (n_rows, D) bf16. Refuses x or y off
// min(2 D, 16) bytes (cudaErrorInvalidValue, nothing launched).
extern "C" int fwht_bf16s(const void* x, void* y, int64_t n_rows, int log2d,
                          void* stream) {
  using namespace whvi;
  using T = __nv_bfloat16;
  if (log2d < 1 || log2d > kMaxLog2D || n_rows < 0 ||
      n_rows > (int64_t)0x7fffffff * rows_per_block(log2d))
    return (int)cudaErrorInvalidValue;
  const uintptr_t width = (2 << log2d) < 16 ? (2 << log2d) : 16;
  if (reinterpret_cast<uintptr_t>(x) % width || reinterpret_cast<uintptr_t>(y) % width)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const FwhtLaunch<T> launch{static_cast<const T*>(x), static_cast<T*>(y), n_rows,
                             static_cast<cudaStream_t>(stream)};
  return (int)dispatch_log2d(log2d, launch);
}
