// Fused WHVI structured product y = s1 * H(u * H(s2 * x)), in fp32 storage
// in both operand precisions of the Pallas kernels it replaces (bf16
// storage: whvi_bf16s.cu).
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
// The backward's batch reductions run in K3's reduce mode (below) where
// the operands make them sums over runs of rows.
//
// Left for later: fewer exchanges (a wider register window where the
// registers allow it) and the butterfly as mma/wgmma Kronecker factors.
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

// The first transform, from the I/O window back to it, stages upwards:
// H_D, or with bf16 operands and two factors (D >= 2048) H_128, the
// rounding, then H_a. Every thread of the block calls it.
template <int L, bool kBf16>
__device__ __forceinline__ void first_transform(float (&v)[RowShape<L>::R], RowExchange<L>& ex) {
  using S = RowShape<L>;
  constexpr bool kTwo = kBf16 && L > kOneFactorLog2;
  constexpr int kLo = kTwo ? kLaneLog2 : L;  // stages [0, kLo) are H_128, [kLo, L) H_a
  butterflies<L, kSplit, 0, kLo, 1>(v, ex);
  constexpr int w1 = S::after(kSplit, 0, kLo, 1);
  if constexpr (kTwo) {
    round_bf16(v);
    butterflies<L, w1, kLo, L, 1>(v, ex);
    to_io_window<L, S::after(w1, kLo, L, 1)>(v, ex);
  } else {
    to_io_window<L, w1>(v, ex);
  }
}

// The second transform, from the I/O window back to it: H_D, or with two
// bf16 factors H_a, the rounding, then H_128, stages downwards (the I/O
// window holds the top stages first and the bottom ones last).
template <int L, bool kBf16>
__device__ __forceinline__ void second_transform(float (&v)[RowShape<L>::R], RowExchange<L>& ex) {
  using S = RowShape<L>;
  constexpr bool kTwo = kBf16 && L > kOneFactorLog2;
  constexpr int kLo = kTwo ? kLaneLog2 : L;
  if constexpr (kTwo) {
    butterflies<L, kSplit, L - 1, kLo - 1, -1>(v, ex);
    constexpr int w2 = S::after(kSplit, L - 1, kLo - 1, -1);
    round_bf16(v);
    butterflies<L, w2, kLo - 1, -1, -1>(v, ex);
    to_io_window<L, S::after(w2, kLo - 1, -1, -1)>(v, ex);
  } else {
    butterflies<L, kSplit, 0, L, 1>(v, ex);
    to_io_window<L, S::after(kSplit, 0, L, 1)>(v, ex);
  }
}

// One block a row group: the thread's row is blockIdx.x * kRows + tid /
// kTpr. s2 comes with x; u and s1 are loaded where they are used, so that
// no more than two shares of a row are held in registers at once. kBf16 is
// the operand precision.
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
  const int col = (tid % S::kTpr) * 4;  // the thread's first group of 4 of the row
  const int64_t out = (row << L) + col;
  RowExchange<L> ex{smem, tid};

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

  first_transform<L, kBf16>(v, ex);

  if (active) {
    if (kResiduals) store_regs<S::R, S::kTpr>(i1 + out, v);
    load_regs<S::R, S::kTpr>(d, u + off[2]);
    scale(v, d);
    if (kBf16) round_bf16(v);
  }
  second_transform<L, kBf16>(v, ex);

  if (active) {
    if (kResiduals) store_regs<S::R, S::kTpr>(i2 + out, v);
    load_regs<S::R, S::kTpr>(d, s1 + off[1]);
    scale(v, d);
    store_regs<S::R, S::kTpr>(y + out, v);
  }
}

template <int L, bool kResiduals, bool kBf16>
cudaError_t launch_fused(const float* x, const float* s1, const float* u, const float* s2,
                         float* y, float* i1, float* i2, int64_t n_rows, const Geometry& geom,
                         cudaStream_t stream) {
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

// ------------------------------------------------ K3's reduce mode
//
// The backward of a square product whose s1 and s2 are each one (D,) row
// and whose u has one row for every `group` consecutive output rows (one
// for all, or one a sample): K3 on (s2, u, s1, g) that also sums the
// batch reductions of _bwd (fwht_pallas.py:403-418) from its registers,
//   ds1 = sum g * i2,  du = sum w1 * i1 (over a group),  ds2 = sum x * t2,
// with w1 = H(s1 g) and t2 = H(u w1) as K3 computes them, i1 and i2 the
// forward's residuals and x its input. Each product is rounded once
// (__fmul_rn) and added into an fp32 accumulator, as the plain version's
// (g * i2).sum(..) rounds it; the order of the sums is another. w1, t2 and
// the products never reach device memory; dx = s2 t2 is stored only where
// x needs a gradient. What bounds it: reading g, i1, i2 and x (x from L2
// where it is shared across samples) and writing dx, once each.
//
// A thread's row slot walks a run of `run` consecutive rows (a run lies
// within one group), its three accumulators in registers, and stores one
// partial row a run for each sum: part[3][n_runs][D]. The second pass
// (whvi_sum_runs_kernel) adds the runs in fixed order, so two launches
// give the same sums bit for bit; no atomics. The accumulators are three
// more shares of a row a thread: at 32 elements a thread (D = 8192) the
// kernel takes 255 registers, so one block an SM there (sums_min_blocks),
// and the next row's loads are staged in shared memory (RowStage); at
// D = 16384 a row's 512 threads may take 128 registers each, which cannot
// hold them, and the wrapper keeps K3 and PyTorch's reductions.

constexpr int kSumsMaxLog2D = 13;

__host__ __device__ constexpr int sums_min_blocks(int log2d) {
  return log2_regs(log2d) < kLargeLog2Regs ? min_blocks(log2d) : 1;
}

// a[j] += v[j] * d[j], the product rounded once and never fused into the add
template <int R>
__device__ __forceinline__ void accumulate(float (&a)[R], const float (&v)[R], const float (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) a[j] += __fmul_rn(v[j], d[j]);
}

// The next row's g, i2, i1 and x are copied into shared memory (cp.async)
// while the current row is transformed, one buffer each: a thread copies
// its own share in the I/O window's layout (group j at j kBlock + tid) and
// reads back only what it copied, so cp.async.wait_group alone orders the
// two. With one 256-thread block an SM at D = 8192 nothing else would hide
// the loads behind the butterflies.
template <int L>
struct RowStage {
  using S = RowShape<L>;
  float* buf;  // kBlock * R floats
  int tid;

  __device__ __forceinline__ void copy(const float* __restrict__ p) const {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(buf);
    if constexpr (S::R >= 4) {
#pragma unroll
      for (int j = 0; j < S::R / 4; ++j)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a + 16 * (j * S::kBlock + tid)),
                     "l"(p + 4 * j * S::kTpr) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(a + 8 * tid), "l"(p) : "memory");
    }
  }

  __device__ __forceinline__ void read(float (&v)[S::R]) const {
    if constexpr (S::R >= 4) {
#pragma unroll
      for (int j = 0; j < S::R / 4; ++j) {
        const float4 q = reinterpret_cast<const float4*>(buf)[j * S::kBlock + tid];
        v[4 * j] = q.x; v[4 * j + 1] = q.y; v[4 * j + 2] = q.z; v[4 * j + 3] = q.w;
      }
    } else {
      const float2 q = reinterpret_cast<const float2*>(buf)[tid];
      v[0] = q.x; v[1] = q.y;
    }
  }
};

__device__ __forceinline__ void stage_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Three groups are committed a row (g and i2; i1; x), each right after its
// buffer is read: the one a phase reads is the third newest.
__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_group 2;" ::: "memory"); }

// Dynamic shared memory of the reduce mode: the exchange buffers and four
// staging buffers.
inline size_t sums_smem_bytes(int log2d) {
  return exchange_bytes(log2d) + 4 * ((size_t)block_threads(log2d) << log2_regs(log2d)) * sizeof(float);
}

// One block kRows row slots; slot s takes rows [s run, (s + 1) run).
// geom holds the strides of x, s1, u, s2 (the forward's operands) over
// the output rows; g, i1, i2 and dx are contiguous (n_runs run, D).
template <int L, bool kBf16>
__global__ void __launch_bounds__(RowShape<L>::kBlock, sums_min_blocks(L))
    whvi_bwd_sums_kernel(const float* __restrict__ g, const float* __restrict__ x,
                         const float* __restrict__ s1, const float* __restrict__ u,
                         const float* __restrict__ s2, const float* __restrict__ i1,
                         const float* __restrict__ i2, float* __restrict__ dx,
                         float* __restrict__ part, int64_t n_runs, int run, Geometry geom) {
  using S = RowShape<L>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int64_t slot = (int64_t)blockIdx.x * S::kRows + tid / S::kTpr;
  const bool active = slot < n_runs;
  const int col = (tid % S::kTpr) * 4;
  RowExchange<L> ex{smem, tid};
  float* const stage = reinterpret_cast<float*>(smem + (S::kTpr == 1 ? 0 : 2 * S::kBufBytes));
  constexpr int kBuf = S::kBlock * S::R;
  const RowStage<L> sg{stage, tid}, si2{stage + kBuf, tid}, si1{stage + 2 * kBuf, tid},
      sx{stage + 3 * kBuf, tid};

  int64_t row = slot * run;
  int64_t off[4];  // x, s1, u, s2 at the current row
  if (active) {
    row_offsets(row, geom, off);
#pragma unroll
    for (int k = 0; k < 4; ++k) off[k] += col;
    sg.copy(g + (row << L) + col);
    si2.copy(i2 + (row << L) + col);
  }
  stage_commit();
  if (active) si1.copy(i1 + (row << L) + col);
  stage_commit();
  if (active) sx.copy(x + off[0]);
  stage_commit();

  float a1[S::R], au[S::R], a2[S::R], v[S::R], d[S::R];
#pragma unroll
  for (int j = 0; j < S::R; ++j) a1[j] = au[j] = a2[j] = 0.f;
  for (int it = 0; it < run; ++it, ++row) {
    const int64_t out = (row << L) + col;
    const bool next = active && it + 1 < run;
    stage_wait();
    if (active) {
      sg.read(v);
      si2.read(d);
      accumulate(a1, v, d);
    }
    if (next) {
      sg.copy(g + out + (1 << L));
      si2.copy(i2 + out + (1 << L));
    }
    stage_commit();
    if (active) {
      load_regs<S::R, S::kTpr>(d, s1 + off[1]);
      scale(v, d);
      if (kBf16) round_bf16(v);
    } else {
#pragma unroll
      for (int j = 0; j < S::R; ++j) v[j] = 0.f;
    }

    first_transform<L, kBf16>(v, ex);  // w1

    stage_wait();
    if (active) {
      si1.read(d);
      accumulate(au, v, d);
    }
    if (next) si1.copy(i1 + out + (1 << L));
    stage_commit();
    if (active) {
      load_regs<S::R, S::kTpr>(d, u + off[2]);
      scale(v, d);
      if (kBf16) round_bf16(v);
    }

    second_transform<L, kBf16>(v, ex);  // t2

    stage_wait();
    if (active) {
      sx.read(d);
      accumulate(a2, v, d);
      if (dx != nullptr) {
        load_regs<S::R, S::kTpr>(d, s2 + off[3]);
        scale(v, d);
        store_regs<S::R, S::kTpr>(dx + out, v);
      }
    }
    if (next) {
      row_offsets(row + 1, geom, off);
#pragma unroll
      for (int k = 0; k < 4; ++k) off[k] += col;
      sx.copy(x + off[0]);
    }
    stage_commit();
  }
  if (active) {
    float* p = part + (slot << L) + col;
    const int64_t plane = n_runs << L;
    store_regs<S::R, S::kTpr>(p, a1);
    store_regs<S::R, S::kTpr>(p + plane, au);
    store_regs<S::R, S::kTpr>(p + 2 * plane, a2);
  }
}

// The second pass: plane 0 (ds1) and 2 (ds2) add all n_runs partial rows,
// plane 1 (du) each group's n_runs / n_groups consecutive ones; a thread
// one element, the runs in order.
__global__ void __launch_bounds__(256)
    whvi_sum_runs_kernel(const float* __restrict__ part, float* __restrict__ ds1,
                         float* __restrict__ du, float* __restrict__ ds2, int64_t n_runs,
                         int64_t n_groups, int log2d) {
  const int plane = blockIdx.y;
  const int64_t rows = plane == 1 ? n_groups : 1;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (rows << log2d)) return;
  const int64_t k = n_runs / rows;
  const int64_t q = idx >> log2d, c = idx & ((int64_t(1) << log2d) - 1);
  const float* p = part + ((plane * n_runs + q * k) << log2d) + c;
  float s = p[0];
#pragma unroll 8
  for (int64_t i = 1; i < k; ++i) s += p[i << log2d];
  (plane == 0 ? ds1 : plane == 1 ? du : ds2)[idx] = s;
}

// The reduce mode's launch at L = log2 D.
struct BwdSumsLaunch {
  bool bf16;
  const float *g, *x, *s1, *u, *s2, *i1, *i2;
  float *dx, *part;
  int64_t n_runs;
  int run;
  const Geometry& geom;
  cudaStream_t stream;

  template <int L>
  cudaError_t operator()() const {
    if constexpr (L > kSumsMaxLog2D) {
      return cudaErrorInvalidValue;
    } else {
      const auto kernel = bf16 ? whvi_bwd_sums_kernel<L, true> : whvi_bwd_sums_kernel<L, false>;
      const size_t smem = sums_smem_bytes(L);
      if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
      }
      const int64_t blocks = (n_runs + RowShape<L>::kRows - 1) / RowShape<L>::kRows;
      kernel<<<(unsigned)blocks, RowShape<L>::kBlock, smem, stream>>>(
          g, x, s1, u, s2, i1, i2, dx, part, n_runs, run, geom);
      return cudaGetLastError();
    }
  }
};

}  // namespace whvi

// K3's reduce mode: dx (where not null; contiguous (n_runs * run, D)) and
// the partial sums part (contiguous (3, n_runs, D)) from the cotangent g
// and the forward's residuals i1, i2 (contiguous as g) and operands x, s1,
// u, s2 read through geom. s1 and s2 must be one row (stride 0 over every
// output row) and u constant over each run (the wrapper's rule). Every
// row start is aligned to min(D, 4) floats. log2d in [1, 13] (2 for bf16).
extern "C" int whvi_bwd_sums_f32(const void* g, const void* x, const void* s1, const void* u,
                                 const void* s2, const void* i1, const void* i2, void* dx,
                                 void* part, int64_t n_runs, int run, int bf16, int log2d,
                                 const whvi::Geometry* geom, void* stream) {
  if (log2d < (bf16 ? 2 : 1) || log2d > whvi::kSumsMaxLog2D || n_runs < 0 || run < 1 ||
      n_runs > (int64_t)0x7fffffff * whvi::rows_per_block(log2d))
    return (int)cudaErrorInvalidValue;
  if (n_runs == 0) return (int)cudaSuccess;
  const whvi::BwdSumsLaunch launch{
      bf16 != 0,
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<const float*>(s1), static_cast<const float*>(u),
      static_cast<const float*>(s2), static_cast<const float*>(i1),
      static_cast<const float*>(i2), static_cast<float*>(dx), static_cast<float*>(part),
      n_runs, run, *geom, static_cast<cudaStream_t>(stream)};
  return (int)whvi::dispatch_log2d(log2d, launch);
}

// The reduce mode's second pass: ds1, ds2 (D,) and du (n_groups, D), all
// contiguous, from part (3, n_runs, D); n_groups divides n_runs.
extern "C" int whvi_sum_runs_f32(const void* part, void* ds1, void* du, void* ds2, int64_t n_runs,
                                 int64_t n_groups, int log2d, void* stream) {
  if (log2d < 1 || log2d > whvi::kMaxLog2D || n_groups < 1 || n_runs < n_groups ||
      n_runs % n_groups != 0 || (n_groups << log2d) > (int64_t)0x7fffffff * 256)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((n_groups << log2d) + 255) / 256;
  whvi::whvi_sum_runs_kernel<<<dim3((unsigned)blocks, 3), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(ds1), static_cast<float*>(du),
      static_cast<float*>(ds2), n_runs, n_groups, log2d);
  return (int)cudaGetLastError();
}

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
