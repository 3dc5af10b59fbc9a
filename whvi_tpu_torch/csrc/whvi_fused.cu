// Fused WHVI structured product y = s1 * H(u * H(s2 * x)), fp32 storage,
// in both operand precisions of the Pallas kernels it replaces.
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
// no more than two shares of a row are held in registers at once.
template <int L, bool kResiduals, bool kBf16>
__global__ void __launch_bounds__(RowShape<L>::kBlock, RowShape<L>::kMinBlocks)
    whvi_fused_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                      const float* __restrict__ u, const float* __restrict__ s2,
                      float* __restrict__ y, float* __restrict__ i1,
                      float* __restrict__ i2, int64_t n_rows, Geometry geom) {
  using S = RowShape<L>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int64_t row = (int64_t)blockIdx.x * S::kRows + tid / S::kTpr;
  const bool active = row < n_rows;
  const int col = (tid % S::kTpr) * 4;  // the thread's first float4 of the row
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
    if (kBf16) round_bf16(v);
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

  if (active) {
    if (kResiduals) store_regs<S::R, S::kTpr>(i1 + out, v);
    load_regs<S::R, S::kTpr>(d, u + off[2]);
    scale(v, d);
    if (kBf16) round_bf16(v);
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

  if (active) {
    if (kResiduals) store_regs<S::R, S::kTpr>(i2 + out, v);
    load_regs<S::R, S::kTpr>(d, s1 + off[1]);
    scale(v, d);
    store_regs<S::R, S::kTpr>(y + out, v);
  }
}

template <int L, bool kResiduals, bool kBf16>
cudaError_t launch_fused(const float* x, const float* s1, const float* u,
                         const float* s2, float* y, float* i1, float* i2,
                         int64_t n_rows, const Geometry& geom, cudaStream_t stream) {
  using S = RowShape<L>;
  const auto kernel = whvi_fused_kernel<L, kResiduals, kBf16>;
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

// The launch at L = log2 D for the two flags.
struct FusedLaunch {
  bool residuals, bf16;
  const float *x, *s1, *u, *s2;
  float *y, *i1, *i2;
  int64_t n_rows;
  const Geometry& geom;
  cudaStream_t stream;

  template <int L>
  cudaError_t operator()() const {
    if (residuals)
      return bf16 ? launch_fused<L, true, true>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream)
                  : launch_fused<L, true, false>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream);
    return bf16 ? launch_fused<L, false, true>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream)
                : launch_fused<L, false, false>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream);
  }
};

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
  const whvi::FusedLaunch launch{
      want_residuals != 0, bf16 != 0,
      static_cast<const float*>(x), static_cast<const float*>(s1),
      static_cast<const float*>(u), static_cast<const float*>(s2),
      static_cast<float*>(y), static_cast<float*>(i1), static_cast<float*>(i2),
      n_rows, *geom, static_cast<cudaStream_t>(stream)};
  return (int)whvi::dispatch_log2d(log2d, launch);
}
