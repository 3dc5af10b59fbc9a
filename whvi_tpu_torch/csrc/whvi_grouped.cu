// Grouped WHVI product, in fp32 storage and both operand precisions of the
// fused product (whvi_fused.cu):
//
//   y[r] = s1[e] * H(u[g] * H(s2[e] * x[src(r)])),   offsets[g] <= r < offsets[g + 1],
//
// for rows sorted by segment g, e = g / per_expert the segment's matrix and
// src(r) = index[r] (a gather) or r. It is the expert layer's product: a
// segment is one (expert, MC sample), each expert has its own s1 and s2
// and each segment its own u, all read once a row from their own rows of
// (n_mat, D) and (n_seg, D) tensors, never copied a row. The segment table
// `offsets` (n_seg + 1 int64, nondecreasing, offsets[0] = 0) lives in
// device memory and is read by the kernels themselves, so the host never
// learns how many rows a segment has: rows at or past offsets[n_seg] lie
// outside every segment, and their y is written 0 (their residuals are
// left as they are). A row finds its segment by a binary search of the
// table (upper bound, so empty segments are skipped).
//
// Three kernels:
// - grouped_fused_kernel<L, kResiduals, kBf16>: K1 (y) and K2 (y, i1, i2)
//   on the row shape of fwht_core.cuh, one block a row group, as
//   whvi_fused_kernel; a block wholly past the segments writes zeros and
//   returns.
// - grouped_bwd_sums_kernel<L, kBf16>: K3 on (s2, u, s1, g) with the batch
//   reductions of K3's reduce mode: ds1 = sum g * i2 and ds2 = sum x * t2
//   over an expert's rows, du = sum w1 * i1 over a segment's. A thread's
//   row slot walks a run of at most `run` rows of one segment (runs are cut
//   at segment edges; run_offsets, the runs before each segment, is made on
//   the device from offsets), its three accumulators in registers, and
//   stores one partial row a run and sum. dx = s2 t2 is stored at row r, or
//   added (atomicAdd) into row index[r] of a zeroed dx where x was
//   gathered.
// - grouped_sum_runs_kernel: the second pass, each segment's runs added in
//   fixed order into (3, n_seg, D); the wrapper sums ds1 and ds2 over an
//   expert's segments.
//
// Widths D = 4 .. 4096 (L = 2 .. 12): three accumulators and the row take
// 5 R registers a thread, R = 16 there, under the 128-register cap of two
// 256-thread blocks an SM.
#include "whvi_fused.cuh"

namespace whvi {

constexpr int kGroupedMinLog2D = 2;
constexpr int kGroupedMaxLog2D = 12;

// The segment that holds `row`: the largest s < n_seg with table[s] <= row,
// for table[0] <= row < table[n_seg].
__device__ __forceinline__ int segment_of(const int64_t* __restrict__ table, int n_seg, int64_t row) {
  int lo = 0, hi = n_seg;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (table[mid] <= row) lo = mid;
    else hi = mid;
  }
  return lo;
}

template <int R, int kTpr>
__device__ __forceinline__ void store_zeros(float* __restrict__ p) {
  float z[R];
#pragma unroll
  for (int j = 0; j < R; ++j) z[j] = 0.f;
  store_regs<R, kTpr>(p, z);
}

template <int L, bool kResiduals, bool kBf16>
__global__ void __launch_bounds__(RowShape<L>::kBlock, RowShape<L>::kMinBlocks)
    grouped_fused_kernel(const float* __restrict__ x, const int64_t* __restrict__ index,
                         const float* __restrict__ s1, const float* __restrict__ u,
                         const float* __restrict__ s2, const int64_t* __restrict__ offsets,
                         float* __restrict__ y, float* __restrict__ i1, float* __restrict__ i2,
                         int64_t n_rows, int n_seg, int per_expert) {
  using S = RowShape<L>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int64_t first = (int64_t)blockIdx.x * S::kRows;
  const int64_t row = first + tid / S::kTpr;
  const int col = (tid % S::kTpr) * 4;
  const int64_t out = (row << L) + col;
  const int64_t count = offsets[n_seg];
  if (first >= count) {  // the whole block past the segments
    if (row < n_rows) store_zeros<S::R, S::kTpr>(y + out);
    return;
  }
  const bool active = row < count;
  RowExchange<L> ex{smem, tid};

  int64_t mat = 0, seg = 0;  // the row's offsets into s1, s2 and into u
  float v[S::R], d[S::R];
  if (active) {
    const int g = segment_of(offsets, n_seg, row);
    seg = ((int64_t)g << L) + col;
    mat = ((int64_t)(g / per_expert) << L) + col;
    const int64_t src = index != nullptr ? index[row] : row;
    load_regs<S::R, S::kTpr>(v, x + (src << L) + col);
    load_regs<S::R, S::kTpr>(d, s2 + mat);
    scale(v, d);
    if (kBf16) round_bf16(v);
  } else {
#pragma unroll
    for (int j = 0; j < S::R; ++j) v[j] = 0.f;
  }

  first_transform<L, kBf16>(v, ex);

  if (active) {
    if (kResiduals) store_regs<S::R, S::kTpr>(i1 + out, v);
    load_regs<S::R, S::kTpr>(d, u + seg);
    scale(v, d);
    if (kBf16) round_bf16(v);
  }
  second_transform<L, kBf16>(v, ex);

  if (active) {
    if (kResiduals) store_regs<S::R, S::kTpr>(i2 + out, v);
    load_regs<S::R, S::kTpr>(d, s1 + mat);
    scale(v, d);
    store_regs<S::R, S::kTpr>(y + out, v);
  } else if (row < n_rows) {
    store_zeros<S::R, S::kTpr>(y + out);
  }
}

// v added into p in the I/O window's layout (load_regs'), one atomic an element
template <int R, int kTpr>
__device__ __forceinline__ void add_regs(float* __restrict__ p, const float (&v)[R]) {
#pragma unroll
  for (int g = 0; g < R / 4; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(p + 4 * g * kTpr + j, v[4 * g + j]);
}

// One block kRows run slots; slot s takes run s of run_offsets' numbering.
// g, i1, i2 are contiguous (n_rows, D) in segment order; x is read at row
// index[r] (or r); dx is (rows of x, D), zeroed by the wrapper where x is
// gathered.
template <int L, bool kBf16>
__global__ void __launch_bounds__(RowShape<L>::kBlock, RowShape<L>::kMinBlocks)
    grouped_bwd_sums_kernel(const float* __restrict__ g, const float* __restrict__ x,
                            const int64_t* __restrict__ index, const float* __restrict__ s1,
                            const float* __restrict__ u, const float* __restrict__ s2,
                            const float* __restrict__ i1, const float* __restrict__ i2,
                            const int64_t* __restrict__ offsets,
                            const int64_t* __restrict__ run_offsets, float* __restrict__ dx,
                            float* __restrict__ part, int64_t n_slots, int n_seg, int per_expert,
                            int run) {
  using S = RowShape<L>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int64_t first = (int64_t)blockIdx.x * S::kRows;
  const int64_t slot = first + tid / S::kTpr;
  const int col = (tid % S::kTpr) * 4;
  const int64_t n_runs = run_offsets[n_seg];
  if (first >= n_runs) return;  // the whole block past the runs
  const bool active = slot < n_runs;
  RowExchange<L> ex{smem, tid};

  int64_t mat = 0, seg = 0, row = 0, end = 0;
  if (active) {
    const int s = segment_of(run_offsets, n_seg, slot);
    seg = ((int64_t)s << L) + col;
    mat = ((int64_t)(s / per_expert) << L) + col;
    row = offsets[s] + (slot - run_offsets[s]) * run;
    end = row + run < offsets[s + 1] ? row + run : offsets[s + 1];
  }

  float a1[S::R], au[S::R], a2[S::R], v[S::R], d[S::R];
#pragma unroll
  for (int j = 0; j < S::R; ++j) a1[j] = au[j] = a2[j] = 0.f;
  // every thread of the block runs as many transforms as the longest run
  // of its rows; a row slot past its own run transforms zeros
  for (; __syncthreads_or(active && row < end); ++row) {
    const bool live = active && row < end;
    const int64_t out = (row << L) + col;
    if (live) {
      load_regs<S::R, S::kTpr>(v, g + out);
      load_regs<S::R, S::kTpr>(d, i2 + out);
      accumulate(a1, v, d);
      load_regs<S::R, S::kTpr>(d, s1 + mat);
      scale(v, d);
      if (kBf16) round_bf16(v);
    } else {
#pragma unroll
      for (int j = 0; j < S::R; ++j) v[j] = 0.f;
    }

    first_transform<L, kBf16>(v, ex);  // w1

    if (live) {
      load_regs<S::R, S::kTpr>(d, i1 + out);
      accumulate(au, v, d);
      load_regs<S::R, S::kTpr>(d, u + seg);
      scale(v, d);
      if (kBf16) round_bf16(v);
    }

    second_transform<L, kBf16>(v, ex);  // t2

    if (live) {
      const int64_t src = index != nullptr ? index[row] : row;
      load_regs<S::R, S::kTpr>(d, x + (src << L) + col);
      accumulate(a2, v, d);
      load_regs<S::R, S::kTpr>(d, s2 + mat);
      scale(v, d);
      if (index != nullptr) add_regs<S::R, S::kTpr>(dx + (src << L) + col, v);
      else store_regs<S::R, S::kTpr>(dx + out, v);
    }
  }
  if (active) {
    float* p = part + (slot << L) + col;
    const int64_t plane = n_slots << L;
    store_regs<S::R, S::kTpr>(p, a1);
    store_regs<S::R, S::kTpr>(p + plane, au);
    store_regs<S::R, S::kTpr>(p + 2 * plane, a2);
  }
}

// The second pass: sums[plane][s] = the partial rows of segment s's runs,
// added in order; a thread one element.
__global__ void __launch_bounds__(256)
    grouped_sum_runs_kernel(const float* __restrict__ part, const int64_t* __restrict__ run_offsets,
                            float* __restrict__ sums, int64_t n_slots, int n_seg, int log2d) {
  const int plane = blockIdx.y;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ((int64_t)n_seg << log2d)) return;
  const int64_t s = idx >> log2d, c = idx & ((int64_t(1) << log2d) - 1);
  const int64_t a = run_offsets[s], b = run_offsets[s + 1];
  const float* p = part + (((int64_t)plane * n_slots) << log2d) + c;
  float acc = 0.f;
  for (int64_t k = a; k < b; ++k) acc += p[k << log2d];
  sums[(((int64_t)plane * n_seg) << log2d) + idx] = acc;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

struct GroupedLaunch {
  bool residuals, bf16;
  const float* x;
  const int64_t* index;
  const float *s1, *u, *s2;
  const int64_t* offsets;
  float *y, *i1, *i2;
  int64_t n_rows;
  int n_seg, per_expert;
  cudaStream_t stream;

  template <int L, bool kRes, bool kBf16>
  cudaError_t launch() const {
    using S = RowShape<L>;
    const auto kernel = grouped_fused_kernel<L, kRes, kBf16>;
    const size_t smem = exchange_bytes(L);
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const int64_t blocks = (n_rows + S::kRows - 1) / S::kRows;
    kernel<<<(unsigned)blocks, S::kBlock, smem, stream>>>(x, index, s1, u, s2, offsets, y, i1, i2,
                                                          n_rows, n_seg, per_expert);
    return cudaGetLastError();
  }

  template <int L>
  cudaError_t operator()() const {
    if constexpr (L < kGroupedMinLog2D || L > kGroupedMaxLog2D) {
      return cudaErrorInvalidValue;
    } else {
      if (residuals) return bf16 ? launch<L, true, true>() : launch<L, true, false>();
      return bf16 ? launch<L, false, true>() : launch<L, false, false>();
    }
  }
};

struct GroupedBwdLaunch {
  bool bf16;
  const float *g, *x;
  const int64_t* index;
  const float *s1, *u, *s2, *i1, *i2;
  const int64_t *offsets, *run_offsets;
  float *dx, *part;
  int64_t n_slots;
  int n_seg, per_expert, run;
  cudaStream_t stream;

  template <int L, bool kBf16>
  cudaError_t launch() const {
    using S = RowShape<L>;
    const auto kernel = grouped_bwd_sums_kernel<L, kBf16>;
    const size_t smem = exchange_bytes(L);
    const cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const int64_t blocks = (n_slots + S::kRows - 1) / S::kRows;
    kernel<<<(unsigned)blocks, S::kBlock, smem, stream>>>(
        g, x, index, s1, u, s2, i1, i2, offsets, run_offsets, dx, part, n_slots, n_seg,
        per_expert, run);
    return cudaGetLastError();
  }

  template <int L>
  cudaError_t operator()() const {
    if constexpr (L < kGroupedMinLog2D || L > kGroupedMaxLog2D) {
      return cudaErrorInvalidValue;
    } else {
      return bf16 ? launch<L, true>() : launch<L, false>();
    }
  }
};

inline bool grouped_args(int log2d, int n_seg, int per_expert, int64_t rows) {
  return log2d >= kGroupedMinLog2D && log2d <= kGroupedMaxLog2D && n_seg >= 1 &&
         per_expert >= 1 && n_seg % per_expert == 0 && rows >= 0 &&
         rows <= (int64_t)0x7fffffff * rows_per_block(log2d);
}

}  // namespace whvi

// K1 (want_residuals 0) or K2 of the grouped product: y, and i1, i2, all
// contiguous (n_rows, D); x (rows of x, D) read at row index[r] where index
// is not null, else at row r; s1, s2 (n_seg / per_expert, D), u (n_seg, D),
// contiguous; offsets (n_seg + 1) in device memory. Row starts aligned to
// 16 bytes. bf16 selects the Pallas kernels' precision="bf16".
extern "C" int whvi_grouped_f32(const void* x, const void* index, const void* s1, const void* u,
                                const void* s2, const void* offsets, void* y, void* i1, void* i2,
                                int want_residuals, int bf16, int64_t n_rows, int n_seg,
                                int per_expert, int log2d, void* stream) {
  if (!whvi::grouped_args(log2d, n_seg, per_expert, n_rows)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const whvi::GroupedLaunch launch{
      want_residuals != 0, bf16 != 0, static_cast<const float*>(x),
      static_cast<const int64_t*>(index), static_cast<const float*>(s1),
      static_cast<const float*>(u), static_cast<const float*>(s2),
      static_cast<const int64_t*>(offsets), static_cast<float*>(y), static_cast<float*>(i1),
      static_cast<float*>(i2), n_rows, n_seg, per_expert, static_cast<cudaStream_t>(stream)};
  return (int)whvi::dispatch_log2d(log2d, launch);
}

// The grouped backward: dx (stored at row r, or added at row index[r] of a
// zeroed dx) and the partial sums part (3, n_slots, D) of the runs that
// run_offsets (n_seg + 1, in device memory) numbers, each at most `run`
// rows of one segment; n_slots bounds the runs.
extern "C" int whvi_grouped_bwd_f32(const void* g, const void* x, const void* index, const void* s1,
                                    const void* u, const void* s2, const void* i1, const void* i2,
                                    const void* offsets, const void* run_offsets, void* dx,
                                    void* part, int64_t n_slots, int n_seg, int per_expert,
                                    int run, int bf16, int log2d, void* stream) {
  if (!whvi::grouped_args(log2d, n_seg, per_expert, n_slots) || run < 1)
    return (int)cudaErrorInvalidValue;
  if (n_slots == 0) return (int)cudaSuccess;
  const whvi::GroupedBwdLaunch launch{
      bf16 != 0, static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<const int64_t*>(index), static_cast<const float*>(s1),
      static_cast<const float*>(u), static_cast<const float*>(s2),
      static_cast<const float*>(i1), static_cast<const float*>(i2),
      static_cast<const int64_t*>(offsets), static_cast<const int64_t*>(run_offsets),
      static_cast<float*>(dx), static_cast<float*>(part), n_slots, n_seg, per_expert, run,
      static_cast<cudaStream_t>(stream)};
  return (int)whvi::dispatch_log2d(log2d, launch);
}

// The grouped backward's second pass: sums (3, n_seg, D) from part.
extern "C" int whvi_grouped_sum_runs_f32(const void* part, const void* run_offsets, void* sums,
                                         int64_t n_slots, int n_seg, int log2d, void* stream) {
  if (log2d < 1 || log2d > whvi::kMaxLog2D || n_seg < 1 || n_slots < 0 ||
      ((int64_t)n_seg << log2d) > (int64_t)0x7fffffff * 256)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (((int64_t)n_seg << log2d) + 255) / 256;
  whvi::grouped_sum_runs_kernel<<<dim3((unsigned)blocks, 3), 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int64_t*>(run_offsets),
      static_cast<float*>(sums), n_slots, n_seg, log2d);
  return (int)cudaGetLastError();
}
