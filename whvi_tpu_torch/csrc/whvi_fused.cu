// Fused WHVI structured product y = s1 * H(u * H(s2 * x)), in fp32 storage
// in both operand precisions of the Pallas kernels it replaces, and in bf16
// storage.
//
// Replaces the Pallas kernels of whvi_tpu/ops/fwht_pallas.py:
//   _kernel_1f_y / _kernel_2f_y  (y only; kResiduals = false),
//   _kernel_1f   / _kernel_2f    (y plus i1 = H(s2*x), i2 = H(u*i1)),
// and, launched on (s2, u, s1, g), the transform half of _bwd.
// The TPU kernels spend two dense MXU matmuls per transform (H_D, or
// H_a (x) H_128 for D > 1024) because the v5e's matrix unit is what it is
// good at. Here each transform is log2 D radix-2 butterfly stages, adds
// and subtracts only, held in registers between a few shared-memory
// exchanges (fwht_core.cuh), with one code path for D from 2 to 16384.
//
// Precision: the Pallas kernels take precision="fp32" | "bf16"; "bf16" is
// the default of _fused_raw and whvi_mul_pallas (fwht_pallas.py:259-260,
// :385) and the only mode the JAX main path reaches (whvi_op.py:172).
// - kBf16 = false reproduces precision="fp32" (H stored fp32, matmuls at
//   Precision.HIGHEST): nothing is rounded below fp32. The diagonal
//   products are __fmul_rn, never contracted into the butterflies' adds,
//   so y, i1 and i2 equal the plain version's bit for bit.
// - kBf16 = true reproduces precision="bf16" (4 <= D <= 16384): the
//   operand of every contraction is rounded to bf16 (R, to nearest even,
//   as _dot/_dotg's astype, fwht_pallas.py:93-149) and the sums stay fp32:
//     D <= 1024 (_kernel_1f*, one factor):  i1 = H_D R(s2 x),
//                                           i2 = H_D R(u i1);
//     D >= 2048 (_kernel_2f*, H_D = H_a (x) H_128, a = D / 128):
//       i1 = H_a R(H_128 R(s2 x)),  i2 = H_128 R(H_a R(u i1)),
//   H_128 being butterfly stages 0-6 (the low 7 index bits) and H_a the
//   stages above. The second transform contracts H_a first, as
//   _kernel_2f's does. Every rounding is of registers: it costs no pass
//   over shared memory and no barrier. i1 and i2 are the fp32 sums,
//   stored unrounded and in natural layout (the TPU's swapped i1 layout is
//   not ported). The sums of +-1 * bf16 values run in another order than
//   the MXU's, so a sum can land on the other side of a bf16 rounding
//   boundary; ops/fwht_cuda.py (bf16_tol) states what that allows.
//
// bf16 storage (T = __nv_bfloat16, entry whvi_fused_bf16s): x, the
// diagonals, y, i1 and i2 are bf16. What the JAX package computes on bf16
// leaves (dtype=bfloat16) is the XLA expression s1 * fwht(u * fwht(s2 * x)),
// each op rounding to bf16 (R) and each transform summing in fp32:
//   t0 = R(s2 x), i1 = R(H t0), t1 = R(u i1), i2 = R(H t1), y = R(s1 i2).
// Rows load as bf16, 4 to an 8-byte access (fwht_core.cuh; 16-byte
// accesses through lane pairs measured slower), and are computed in fp32
// registers, rounded at those five points: the products
// of two bf16 are exact in fp32, so each rounding is the one of the bf16
// op, and the butterflies keep the plain order, so y, i1 and i2 equal the
// plain version's bit for bit. The JAX Pallas kernels cannot store bf16
// (their output stores raise on bf16 refs), so there is no bf16-storage
// form of precision="bf16": the entry refuses it.
//
// Broadcasting: x and the three diagonals are read through per-operand
// leading strides (0 on a broadcast axis), so the stacked matrix's
// (stack, D) diagonals, a per-sample or per-row u, and an x shared across
// the stack are never materialized per row. Each row computes its four
// base offsets once, in int64.
//
// What bounds it on an H100. Per element it reads x and the diagonals
// (these from L1/L2 once broadcast) and writes y, plus i1 and i2 with
// residuals: in 16-byte accesses, the row crossing device memory once in
// and once per output. In between the row lives in registers, and at D =
// 4096 a transform costs 3 exchanges through shared memory (fwht_core.cuh),
// each behind one barrier, in both precisions. Those exchanges are 192 KB
// of shared-memory traffic a row, about as long on the card as the row's
// device-memory traffic and its 24 add stages (PERF.md).
//
// Left for later: fewer exchanges (a wider register window where the
// registers allow it), the butterfly as mma/wgmma Kronecker factors, and
// fusing the backward's batch reductions.
#include <type_traits>

#include "fwht_core.cuh"

namespace whvi {

constexpr int kLaneLog2 = 7;        // H_128, the TPU's lane factor
constexpr int kOneFactorLog2 = 10;  // D <= 1024: one factor (_factor_pair)

// v <- v * d[0 .. R), each product rounded once and never fused into an add
template <int R>
__device__ __forceinline__ void scale(float (&v)[R], const float (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = __fmul_rn(v[j], d[j]);
}

// One block a row group: the thread's row is blockIdx.x * kRows + tid /
// kTpr. s2 comes with x; u and s1 are loaded where they are used, so that
// no more than two shares of a row are held in registers at once. T is the
// storage type (float or __nv_bfloat16); kBf16 the operand precision,
// with float storage only.
template <int L, bool kResiduals, bool kBf16, typename T>
__global__ void __launch_bounds__(RowShape<L>::kBlock, RowShape<L>::kMinBlocks)
    whvi_fused_kernel(const T* __restrict__ x, const T* __restrict__ s1,
                      const T* __restrict__ u, const T* __restrict__ s2,
                      T* __restrict__ y, T* __restrict__ i1,
                      T* __restrict__ i2, int64_t n_rows, Geometry geom) {
  using S = RowShape<L>;
  constexpr bool kHalf = !std::is_same_v<T, float>;  // bf16 storage
  static_assert(!(kHalf && kBf16), "bf16 storage has fp32 operands only");
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int64_t row = (int64_t)blockIdx.x * S::kRows + tid / S::kTpr;
  const bool active = row < n_rows;
  const int col = (tid % S::kTpr) * 4;  // the thread's first group of 4 of the row
  const int64_t out = (row << L) + col;
  RowExchange<L> ex{smem, tid};
  // bf16 with two factors: stages [0, kLo) are H_128, [kLo, L) are H_a
  constexpr bool kTwo = kBf16 && L > kOneFactorLog2;
  constexpr int kLo = kTwo ? kLaneLog2 : L;

  int64_t off[4];  // offsets of the thread's share of x, s1, u, s2
  float v[S::R], d[S::R];
  if (active) {
    row_offsets(row, geom, off);
#pragma unroll
    for (int k = 0; k < 4; ++k) off[k] += col;
    load_regs<S::R, S::kTpr>(v, x + off[0]);
    load_regs<S::R, S::kTpr>(d, s2 + off[3]);
    scale(v, d);
    if (kBf16 || kHalf) round_bf16(v);  // kHalf: t0 = R(s2 x)
  } else {
#pragma unroll
    for (int j = 0; j < S::R; ++j) v[j] = 0.f;
  }

  // first transform, stages upwards: H_128 then H_a (or H_D whole)
  butterflies<L, kSplit, 0, kLo, 1>(v, ex);
  constexpr int w1 = S::after(kSplit, 0, kLo, 1);
  if constexpr (kTwo) {
    round_bf16(v);
    butterflies<L, w1, kLo, L, 1>(v, ex);
    to_io_window<L, S::after(w1, kLo, L, 1)>(v, ex);
  } else {
    to_io_window<L, w1>(v, ex);
  }
  if (kHalf) round_bf16(v);  // i1 = R(H t0)

  if (active) {
    if (kResiduals) store_regs<S::R, S::kTpr>(i1 + out, v);
    load_regs<S::R, S::kTpr>(d, u + off[2]);
    scale(v, d);
    if (kBf16 || kHalf) round_bf16(v);  // kHalf: t1 = R(u i1)
  }
  if constexpr (kTwo) {
    // second transform, H_a then H_128, stages downwards: the I/O window
    // holds the top stages first and the bottom ones last
    butterflies<L, kSplit, L - 1, kLo - 1, -1>(v, ex);
    constexpr int w2 = S::after(kSplit, L - 1, kLo - 1, -1);
    round_bf16(v);
    butterflies<L, w2, kLo - 1, -1, -1>(v, ex);
    to_io_window<L, S::after(w2, kLo - 1, -1, -1)>(v, ex);
  } else {
    butterflies<L, kSplit, 0, L, 1>(v, ex);
    to_io_window<L, S::after(kSplit, 0, L, 1)>(v, ex);
  }
  if (kHalf) round_bf16(v);  // i2 = R(H t1)

  if (active) {
    if (kResiduals) store_regs<S::R, S::kTpr>(i2 + out, v);
    load_regs<S::R, S::kTpr>(d, s1 + off[1]);
    scale(v, d);
    store_regs<S::R, S::kTpr>(y + out, v);  // kHalf: y = R(s1 i2), by the store
  }
}

template <int L, bool kResiduals, bool kBf16, typename T>
cudaError_t launch_fused(const T* x, const T* s1, const T* u, const T* s2, T* y, T* i1,
                         T* i2, int64_t n_rows, const Geometry& geom, cudaStream_t stream) {
  using S = RowShape<L>;
  const auto kernel = whvi_fused_kernel<L, kResiduals, kBf16, T>;
  const size_t smem = exchange_bytes(L);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n_rows + S::kRows - 1) / S::kRows;
  kernel<<<(unsigned)blocks, S::kBlock, smem, stream>>>(x, s1, u, s2, y, i1, i2, n_rows, geom);
  return cudaGetLastError();
}

// The launch at L = log2 D for the two flags (bf16 precision with float
// storage only).
template <typename T>
struct FusedLaunch {
  bool residuals, bf16;
  const T *x, *s1, *u, *s2;
  T *y, *i1, *i2;
  int64_t n_rows;
  const Geometry& geom;
  cudaStream_t stream;

  template <int L>
  cudaError_t operator()() const {
    if constexpr (std::is_same_v<T, float>) {
      if (residuals)
        return bf16 ? launch_fused<L, true, true>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream)
                    : launch_fused<L, true, false>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream);
      return bf16 ? launch_fused<L, false, true>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream)
                  : launch_fused<L, false, false>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream);
    } else {
      return residuals
                 ? launch_fused<L, true, false>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream)
                 : launch_fused<L, false, false>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream);
    }
  }
};

// Whether every row of the operands starts on a multiple of `width` bytes:
// the base pointers and, for the inputs, each leading stride read through.
inline bool rows_aligned(const void* const* ptrs, int n_ptrs, const Geometry& g,
                         int64_t elem_bytes, int64_t width) {
  for (int k = 0; k < n_ptrs; ++k)
    if (ptrs[k] != nullptr && reinterpret_cast<uintptr_t>(ptrs[k]) % width) return false;
  for (int k = 0; k < 4; ++k)
    for (int d = 0; d < 4; ++d)
      if (g.size[d] > 1 && (g.stride[k][d] * elem_bytes) % width) return false;
  return true;
}

}  // namespace whvi

// y (and, when want_residuals, i1 and i2) are contiguous (n_rows, D).
// Every operand's row starts on a multiple of min(D, 4) floats (the
// wrapper checks). bf16 selects the Pallas kernels' precision="bf16"
// (D >= 4), else "fp32". Returns the launch's cudaError_t (0 on success).
extern "C" int whvi_fused_f32(const void* x, const void* s1, const void* u,
                              const void* s2, void* y, void* i1, void* i2,
                              int want_residuals, int bf16, int64_t n_rows,
                              int log2d, const whvi::Geometry* geom,
                              void* stream) {
  if (log2d < (bf16 ? 2 : 1) || log2d > whvi::kMaxLog2D || n_rows < 0 ||
      n_rows > (int64_t)0x7fffffff * whvi::rows_per_block(log2d))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const whvi::FusedLaunch<float> launch{
      want_residuals != 0, bf16 != 0,
      static_cast<const float*>(x), static_cast<const float*>(s1),
      static_cast<const float*>(u), static_cast<const float*>(s2),
      static_cast<float*>(y), static_cast<float*>(i1), static_cast<float*>(i2),
      n_rows, *geom, static_cast<cudaStream_t>(stream)};
  return (int)whvi::dispatch_log2d(log2d, launch);
}

// bf16 storage: the same arguments, every tensor bf16, rounded as the
// header says. Refuses bf16 != 0 (the Pallas kernels have no bf16-storage
// form) and any operand whose rows are off min(2 D, 16) bytes (the
// 16-byte accesses would fault): cudaErrorInvalidValue, nothing launched.
extern "C" int whvi_fused_bf16s(const void* x, const void* s1, const void* u,
                                const void* s2, void* y, void* i1, void* i2,
                                int want_residuals, int bf16, int64_t n_rows,
                                int log2d, const whvi::Geometry* geom,
                                void* stream) {
  using T = __nv_bfloat16;
  if (bf16 != 0 || log2d < 1 || log2d > whvi::kMaxLog2D || n_rows < 0 ||
      n_rows > (int64_t)0x7fffffff * whvi::rows_per_block(log2d))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[7] = {x, s1, u, s2, y, want_residuals ? i1 : nullptr,
                         want_residuals ? i2 : nullptr};
  const int64_t width = (2 << log2d) < 16 ? (2 << log2d) : 16;
  if (!whvi::rows_aligned(ptrs, 7, *geom, sizeof(T), width)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const whvi::FusedLaunch<T> launch{
      want_residuals != 0, false,
      static_cast<const T*>(x), static_cast<const T*>(s1),
      static_cast<const T*>(u), static_cast<const T*>(s2),
      static_cast<T*>(y), static_cast<T*>(i1), static_cast<T*>(i2),
      n_rows, *geom, static_cast<cudaStream_t>(stream)};
  return (int)whvi::dispatch_log2d(log2d, launch);
}
