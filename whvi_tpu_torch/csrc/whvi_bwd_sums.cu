// K3's reduce mode: the backward of the fused WHVI product with its batch
// reductions summed on the card, in its square and its stacked form, and
// the second pass that adds the runs' partial sums. It inlines the
// transforms of whvi_fused.cuh, as K1-K3 (whvi_fused.cu) do; a file of its
// own, so that nvcc compiles it beside K1-K3 and not after them.
#include "whvi_fused.cuh"

namespace whvi {

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
//
// The stacked form (kStacked) is the backward of a stacked product: s1 and
// s2 are (stack, D), one row a block, the outputs (.., stack, D), block k
// of leading row m at output row m stack + k, and u one (stack, D) row for
// all or one a sample. Each sum then runs over the rows of one block k (and
// for du of one sample): a slot j stack + k walks rows (j run + i) stack + k,
// i < run, with a stride of `stack` rows, so its three accumulators stay
// one block's. Neighbouring slots take neighbouring blocks of the same
// rows, so x, which broadcasts over the stack axis, comes from L2 for all
// but the first of them. The second pass adds each block's runs in the
// same fixed order. The square form is kStacked = false, its own
// instance: nothing of the stride reaches its code.

constexpr int kSumsMaxLog2D = 13;

__host__ __device__ constexpr int sums_min_blocks(int log2d) {
  return log2_regs(log2d) < kLargeLog2Regs ? min_blocks(log2d) : 1;
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

// One block kRows row slots; slot s takes rows [s run, (s + 1) run), or in
// the stacked form rows (j run + i) stack + k, s = j stack + k, i < run.
// geom holds the strides of x, s1, u, s2 (the forward's operands) over
// the output rows; g, i1, i2 and dx are contiguous (n_runs run, D).
template <int L, bool kBf16, bool kStacked>
__global__ void __launch_bounds__(RowShape<L>::kBlock, sums_min_blocks(L))
    whvi_bwd_sums_kernel(const float* __restrict__ g, const float* __restrict__ x,
                         const float* __restrict__ s1, const float* __restrict__ u,
                         const float* __restrict__ s2, const float* __restrict__ i1,
                         const float* __restrict__ i2, float* __restrict__ dx,
                         float* __restrict__ part, int64_t n_runs, int run, Geometry geom,
                         int stack) {
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

  const int64_t step = kStacked ? stack : 1;  // rows from one of the slot's rows to the next
  int64_t row = slot * run;
  if constexpr (kStacked) row = (slot - slot % stack) * run + slot % stack;
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
  for (int it = 0; it < run; ++it, row += step) {
    const int64_t out = (row << L) + col;
    const bool next = active && it + 1 < run;
    stage_wait();
    if (active) {
      sg.read(v);
      si2.read(d);
      accumulate(a1, v, d);
    }
    if (next) {
      sg.copy(g + out + (step << L));
      si2.copy(i2 + out + (step << L));
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
    if (next) si1.copy(i1 + out + (step << L));
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
      row_offsets(row + step, geom, off);
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
// one element, the runs in order. The stacked form: plane 0 and 2 add the
// runs j stack + k of each block k, plane 1 those of each group and block,
// (n_groups, stack, D) as u's rows lie.
template <bool kStacked>
__global__ void __launch_bounds__(256)
    whvi_sum_runs_kernel(const float* __restrict__ part, float* __restrict__ ds1,
                         float* __restrict__ du, float* __restrict__ ds2, int64_t n_runs,
                         int64_t n_groups, int log2d, int stack) {
  const int plane = blockIdx.y;
  const int64_t rows = (plane == 1 ? n_groups : 1) * (kStacked ? stack : 1);
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (rows << log2d)) return;
  const int64_t k = n_runs / rows;
  const int64_t q = idx >> log2d, c = idx & ((int64_t(1) << log2d) - 1);
  if constexpr (kStacked) {
    const int64_t b = q % stack;  // the block; runs (q / stack k + i) stack + b, i < k
    const float* p = part + ((plane * n_runs + (q - b) * k + b) << log2d) + c;
    float s = p[0];
#pragma unroll 8
    for (int64_t i = 1; i < k; ++i) s += p[(i * stack) << log2d];
    (plane == 0 ? ds1 : plane == 1 ? du : ds2)[idx] = s;
  } else {
    const float* p = part + ((plane * n_runs + q * k) << log2d) + c;
    float s = p[0];
#pragma unroll 8
    for (int64_t i = 1; i < k; ++i) s += p[i << log2d];
    (plane == 0 ? ds1 : plane == 1 ? du : ds2)[idx] = s;
  }
}

// The reduce mode's launch at L = log2 D: the square form where stack is
// 0, else the stacked form, which has no bf16 instance (no product with
// (stack, D) diagonals runs in the bf16 precision: whvi_op.bf16_eligible).
struct BwdSumsLaunch {
  bool bf16;
  const float *g, *x, *s1, *u, *s2, *i1, *i2;
  float *dx, *part;
  int64_t n_runs;
  int run, stack;
  const Geometry& geom;
  cudaStream_t stream;

  template <int L>
  cudaError_t operator()() const {
    if constexpr (L > kSumsMaxLog2D) {
      return cudaErrorInvalidValue;
    } else {
      const auto kernel = stack > 0 ? whvi_bwd_sums_kernel<L, false, true>
                          : bf16      ? whvi_bwd_sums_kernel<L, true, false>
                                      : whvi_bwd_sums_kernel<L, false, false>;
      const size_t smem = sums_smem_bytes(L);
      if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
      }
      const int64_t blocks = (n_runs + RowShape<L>::kRows - 1) / RowShape<L>::kRows;
      kernel<<<(unsigned)blocks, RowShape<L>::kBlock, smem, stream>>>(
          g, x, s1, u, s2, i1, i2, dx, part, n_runs, run, geom, stack);
      return cudaGetLastError();
    }
  }
};

// The C entries' checks and launches (stack 0: the square form).
inline int bwd_sums(const void* g, const void* x, const void* s1, const void* u, const void* s2,
                    const void* i1, const void* i2, void* dx, void* part, int64_t n_runs, int run,
                    int stack, int bf16, int log2d, const Geometry* geom, void* stream) {
  if (log2d < (bf16 ? 2 : 1) || log2d > kSumsMaxLog2D || n_runs < 0 || run < 1 || stack < 0 ||
      (stack > 0 && bf16) ||
      (stack > 0 && n_runs % stack != 0) || n_runs > (int64_t)0x7fffffff * rows_per_block(log2d))
    return (int)cudaErrorInvalidValue;
  if (n_runs == 0) return (int)cudaSuccess;
  const BwdSumsLaunch launch{
      bf16 != 0,
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<const float*>(s1), static_cast<const float*>(u),
      static_cast<const float*>(s2), static_cast<const float*>(i1),
      static_cast<const float*>(i2), static_cast<float*>(dx), static_cast<float*>(part),
      n_runs, run, stack, *geom, static_cast<cudaStream_t>(stream)};
  return (int)dispatch_log2d(log2d, launch);
}

inline int sum_runs(const void* part, void* ds1, void* du, void* ds2, int64_t n_runs,
                    int64_t n_groups, int stack, int log2d, void* stream) {
  const int64_t rows = n_groups * (stack > 0 ? stack : 1);  // of du
  if (log2d < 1 || log2d > kMaxLog2D || n_groups < 1 || stack < 0 || n_runs < rows ||
      n_runs % rows != 0 || (rows << log2d) > (int64_t)0x7fffffff * 256)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((rows << log2d) + 255) / 256;
  const auto kernel = stack > 0 ? whvi_sum_runs_kernel<true> : whvi_sum_runs_kernel<false>;
  kernel<<<dim3((unsigned)blocks, 3), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(ds1), static_cast<float*>(du),
      static_cast<float*>(ds2), n_runs, n_groups, log2d, stack);
  return (int)cudaGetLastError();
}

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
  return whvi::bwd_sums(g, x, s1, u, s2, i1, i2, dx, part, n_runs, run, 0, bf16, log2d, geom,
                        stream);
}

// The stacked form, fp32 operands only: the same over outputs (.., stack,
// D) whose s1 and s2 are one row a block (stride 0 over the leading rows)
// and whose u is constant over each run of a block; stack >= 1 divides
// n_runs, a slot j stack + k taking rows (j run + i) stack + k.
extern "C" int whvi_bwd_sums_stacked_f32(const void* g, const void* x, const void* s1,
                                         const void* u, const void* s2, const void* i1,
                                         const void* i2, void* dx, void* part, int64_t n_runs,
                                         int run, int stack, int log2d,
                                         const whvi::Geometry* geom, void* stream) {
  if (stack < 1) return (int)cudaErrorInvalidValue;
  return whvi::bwd_sums(g, x, s1, u, s2, i1, i2, dx, part, n_runs, run, stack, 0, log2d, geom,
                        stream);
}

// The reduce mode's second pass: ds1, ds2 (D,) and du (n_groups, D), all
// contiguous, from part (3, n_runs, D); n_groups divides n_runs.
extern "C" int whvi_sum_runs_f32(const void* part, void* ds1, void* du, void* ds2, int64_t n_runs,
                                 int64_t n_groups, int log2d, void* stream) {
  return whvi::sum_runs(part, ds1, du, ds2, n_runs, n_groups, 0, log2d, stream);
}

// The stacked form's second pass: ds1, ds2 (stack, D) and du (n_groups,
// stack, D), all contiguous, from part (3, n_runs, D) of the stacked
// slots; n_groups stack divides n_runs.
extern "C" int whvi_sum_runs_stacked_f32(const void* part, void* ds1, void* du, void* ds2,
                                         int64_t n_runs, int64_t n_groups, int stack, int log2d,
                                         void* stream) {
  if (stack < 1) return (int)cudaErrorInvalidValue;
  return whvi::sum_runs(part, ds1, du, ds2, n_runs, n_groups, stack, log2d, stream);
}
