// The column head of a bf16-storage net in one launch a direction (entry
// column_bf16s): ColumnMatrix.column_given_g's rows s1_0 * H(g) * s2, the
// head n_out == 1 (or n_in == 1) of every WHVI net, forward and backward.
//
// Replaces, on bf16 storage, the chain the column head ran through K4
// (fwht.cu) and PyTorch's elementwise ops: its TPU counterpart is the bare
// transform, _kernel_1f_t / _kernel_2f_t of whvi_tpu/ops/fwht_pallas.py
// (launched by _fwht_raw), inside whvi_tpu/models/weights.py:333-347:
//   rows = s1[:n_rows, None] * fwht(H_rows * g[..., None, :]) * s2.
// n_rows = ceil(n / D) is 1 (D = next_pow_of_2(n) >= n) and H_rows is row
// 0 of Sylvester's H, all ones, so with R the rounding to bf16 (nearest
// even) of each op and t = R(H g) (the transform summed in fp32):
//   kColumnY    y = R(R(s1_0 t) s2)                  (a predictive call)
//   kColumnRes  y and t                               (a train step)
//   kColumnBwd  from the rows' cotangent gy and the saved t:
//               dg = R(H R(R(gy s2) s1_0)), p1 = R(R(gy s2) t),
//               p2 = R(gy R(s1_0 t))
// p1 and p2 are what the wrapper sums into the gradients of s1_0 and s2
// (PyTorch sum_to_size, as autograd over the chain sums them). Every
// product is of two bf16, exact in fp32, __fmul_rn (never contracted into
// an add) and rounded once, as PyTorch's bf16 mul rounds; the transform
// runs stages 0 .. L-1 in order as ops/hadamard.py:fwht does. So every
// output equals the plain version's (fwht_cuda.column_plain,
// column_bwd_plain) and autograd's over the chain, bit for bit.
//
// What bounds it on an H100. At the column head (8 rows of D = 4096, 64 KB
// in and out) no row count fills the card: a launch is its launch latency
// plus one row's serial chain (its loads, 12 butterfly stages, 3
// exchanges, its stores), and the bytes set nothing. The lever is the
// launches the head costs: the chain took 4 a predictive call and about 14
// a train step (2 of them K4), this kernel 1 and 2. At the column LRT's
// rows (2048 x 4096) the bytes bound it, as they bound K4: 2 bytes an
// element of g, s2 (from L2) and each output.
//
// The design: fwht_core.cuh's register rows (RowShape: 16 elements a
// thread up to D = 4096, 32 above; one row a block from D = 4096, 256
// rows a block at D <= 16) and its exchanges, in fp32 only. Every operand
// moves in the I/O window where the transform starts and ends (groups of 4
// bf16, 8-byte accesses a warp's consecutive), issued at the start of the
// launch so that their latencies overlap; s1_0 is one scalar a row; all
// rounding happens at load and store. Per-row broadcast geometry as in
// whvi_fused.cu (operands in, s1, s2, res; at most 4 strided dims, stride
// 0 on a broadcast axis): the replica axis and the LRT's (S, B, D) rows
// need no copies.
//
// PERF.md keeps the times of the designs this one was held against: a row
// split over the two blocks of a cluster (distributed shared memory), the
// backward transforming g again instead of reading t, and the forward
// loading s2 after the transform.
#include "fwht_core.cuh"

namespace whvi {

constexpr int kColumnY = 0, kColumnRes = 1, kColumnBwd = 2;  // the modes

struct ColumnArgs {
  const __nv_bfloat16* in;   // g, or the rows' cotangent gy (kColumnBwd)
  const __nv_bfloat16* s1;   // s1_0 of a row: the element at its offset
  const __nv_bfloat16* s2;
  const __nv_bfloat16* res;  // kColumnBwd: t
  __nv_bfloat16* out0;       // y, or dg
  __nv_bfloat16* out1;       // t (kColumnRes), or p1
  __nv_bfloat16* out2;       // p2
  int64_t n_rows;
  Geometry geom;             // operands in, s1, s2, res
};

// The I/O window's register groups: group k (registers kG k .. kG k + kG
// - 1) holds the kG elements at p + kG k tpr, p the thread's first (kG =
// 4; 2 where a row is 2 elements), as load_regs places them.
template <int kL>
struct ColumnIo {
  using S = RowShape<kL>;
  static constexpr int kG = S::R < 4 ? S::R : 4;
  static constexpr int kGroups = S::R / kG;

  __device__ static __forceinline__ int at(int k) { return kG * k * S::kTpr; }

  __device__ static __forceinline__ void load(float* v, const __nv_bfloat16* p) {
    if constexpr (kG == 4) {
      unpack4(*reinterpret_cast<const uint2*>(p), v);
    } else {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      v[0] = a.x;
      v[1] = a.y;
    }
  }

  // the store rounds to bf16
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    if constexpr (kG == 4) {
      *reinterpret_cast<uint2*>(p) = pack4(v);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    }
  }

  // all of a thread's share
  __device__ static __forceinline__ void load_all(float (&v)[S::R], const __nv_bfloat16* p) {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) load(v + kG * k, p + at(k));
  }
  __device__ static __forceinline__ void store_all(__nv_bfloat16* p, const float (&v)[S::R]) {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) store(p + at(k), v + kG * k);
  }
};

__device__ __forceinline__ float rn_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The transform of a row held in the I/O window, back in the I/O window:
// stages 0 .. L-1 in order.
template <int L>
__device__ __forceinline__ void column_transform(float (&v)[RowShape<L>::R], RowExchange<L>& ex) {
  butterflies<L, kSplit, 0, L, 1>(v, ex);
  to_io_window<L, RowShape<L>::after(kSplit, 0, L, 1)>(v, ex);
}

// One block a group of kRows rows: a thread's row blockIdx.x * kRows +
// tid / kTpr.
template <int L, int kMode>
__global__ void __launch_bounds__(RowShape<L>::kBlock, RowShape<L>::kMinBlocks)
    column_kernel(ColumnArgs a) {
  using S = RowShape<L>;
  using Io = ColumnIo<L>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int64_t row = (int64_t)blockIdx.x * S::kRows + tid / S::kTpr;
  const bool active = row < a.n_rows;
  const int lane = (tid % S::kTpr) * 4;  // the thread's first element in the row
  const int64_t out = (row << L) + lane;
  RowExchange<L> ex{smem, tid};

  int64_t off[4];  // row starts of in, s1, s2, res
  float v[S::R];
  float s = 0.f;  // s1_0
  if constexpr (kMode != kColumnBwd) {
    float d[S::R];  // s2, loaded beside g
    if (active) {
      row_offsets(row, a.geom, off);
      Io::load_all(v, a.in + off[0] + lane);
      Io::load_all(d, a.s2 + off[2] + lane);
      s = __bfloat162float(a.s1[off[1]]);
    } else {
#pragma unroll
      for (int j = 0; j < S::R; ++j) v[j] = d[j] = 0.f;
    }
    column_transform<L>(v, ex);
    if (!active) return;
    round_bf16(v);  // t = R(H g)
    if constexpr (kMode == kColumnRes) Io::store_all(a.out1 + out, v);
#pragma unroll
    for (int j = 0; j < S::R; ++j) v[j] = __fmul_rn(rn_bf16(__fmul_rn(s, v[j])), d[j]);
    Io::store_all(a.out0 + out, v);  // y = R(R(s1_0 t) s2), by the store
  } else {
    float gy[S::R], d[S::R], t[S::R];
    if (active) {
      row_offsets(row, a.geom, off);
      Io::load_all(gy, a.in + off[0] + lane);
      Io::load_all(d, a.s2 + off[2] + lane);
      Io::load_all(t, a.res + off[3] + lane);
      s = __bfloat162float(a.s1[off[1]]);
    } else {
#pragma unroll
      for (int j = 0; j < S::R; ++j) gy[j] = d[j] = t[j] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < Io::kGroups; ++k) {
      float p1[Io::kG], p2[Io::kG];
#pragma unroll
      for (int i = 0; i < Io::kG; ++i) {
        const int j = Io::kG * k + i;
        const float da = rn_bf16(__fmul_rn(gy[j], d[j]));  // R(gy s2)
        p1[i] = __fmul_rn(da, t[j]);                           // rounded by the store
        p2[i] = __fmul_rn(gy[j], rn_bf16(__fmul_rn(s, t[j])));
        v[j] = rn_bf16(__fmul_rn(da, s));                      // R(R(gy s2) s1_0)
      }
      if (active) {
        Io::store(a.out1 + out + Io::at(k), p1);
        Io::store(a.out2 + out + Io::at(k), p2);
      }
    }
    column_transform<L>(v, ex);
    if (active) Io::store_all(a.out0 + out, v);  // dg = R(H ..), by the store
  }
}

template <int L, int kMode>
cudaError_t launch_column(const ColumnArgs& a, cudaStream_t stream) {
  using S = RowShape<L>;
  const auto kernel = column_kernel<L, kMode>;
  const size_t smem = exchange_bytes(L);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (a.n_rows + S::kRows - 1) / S::kRows;
  kernel<<<(unsigned)blocks, S::kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

struct ColumnLaunch {
  int mode;
  const ColumnArgs& a;
  cudaStream_t stream;

  template <int L>
  cudaError_t operator()() const {
    switch (mode) {
      case kColumnY: return launch_column<L, kColumnY>(a, stream);
      case kColumnRes: return launch_column<L, kColumnRes>(a, stream);
      default: return launch_column<L, kColumnBwd>(a, stream);
    }
  }
};

// The launch floor: a kernel that does nothing, on column_bf16s's grid,
// block and shared memory at the same rows and width.
__global__ void column_nop_kernel() {}

struct NopLaunch {
  int64_t n_rows;
  cudaStream_t stream;

  template <int L>
  cudaError_t operator()() const {
    using S = RowShape<L>;
    const size_t smem = exchange_bytes(L);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          column_nop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    const int64_t blocks = (n_rows + S::kRows - 1) / S::kRows;
    column_nop_kernel<<<(unsigned)blocks, S::kBlock, smem, stream>>>();
    return cudaGetLastError();
  }
};

// Whether the rows of in, s2 and res start on multiples of `width` bytes
// (base pointers and each leading stride read through) and the outputs
// too; s1 is read a scalar a row and may lie anywhere.
inline bool column_aligned(const void* const* ptrs, int n_ptrs, const Geometry& g, int64_t width) {
  for (int k = 0; k < n_ptrs; ++k)
    if (ptrs[k] != nullptr && reinterpret_cast<uintptr_t>(ptrs[k]) % width) return false;
  for (int k = 0; k < 4; ++k)
    for (int d = 0; d < 4; ++d)
      if (k != 1 && g.size[d] > 1 && (g.stride[k][d] * 2) % width) return false;
  return true;
}

}  // namespace whvi

// mode 0 (y), 1 (y and t) or 2 (the backward: dg, p1, p2), every tensor
// bf16, the outputs contiguous (n_rows, D); operand rows through geom
// (in, s1, s2, res). Refuses a pointer the mode needs that is null, and
// in, s2, res or an output whose rows are off min(2 D, 16) bytes (the
// 8-byte accesses would fault): cudaErrorInvalidValue, nothing launched.
// Returns the launch's cudaError_t (0 on success).
extern "C" int column_bf16s(int mode, const void* in, const void* s1, const void* s2,
                            const void* res, void* out0, void* out1, void* out2,
                            int64_t n_rows, int log2d, const whvi::Geometry* geom,
                            void* stream) {
  using T = __nv_bfloat16;
  using namespace whvi;
  if (mode < kColumnY || mode > kColumnBwd || log2d < 1 || log2d > kMaxLog2D || n_rows < 0 ||
      n_rows > (int64_t)0x3fffffff)
    return (int)cudaErrorInvalidValue;
  const bool bwd = mode == kColumnBwd;
  if (!in || !s1 || !s2 || !out0 || (mode != kColumnY && !out1) || (bwd && (!res || !out2)))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {in, s2, bwd ? res : nullptr, out0, mode != kColumnY ? out1 : nullptr,
                         bwd ? out2 : nullptr};
  const int64_t width = (2 << log2d) < 16 ? (2 << log2d) : 16;
  if (!column_aligned(ptrs, 6, *geom, width)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const ColumnArgs a{static_cast<const T*>(in), static_cast<const T*>(s1),
                     static_cast<const T*>(s2), static_cast<const T*>(res),
                     static_cast<T*>(out0), static_cast<T*>(out1), static_cast<T*>(out2),
                     n_rows, *geom};
  return (int)dispatch_log2d(log2d, ColumnLaunch{mode, a, static_cast<cudaStream_t>(stream)});
}

// The launch floor at column_bf16s's grid for (n_rows, 2^log2d).
extern "C" int column_nop(int64_t n_rows, int log2d, void* stream) {
  using namespace whvi;
  if (log2d < 1 || log2d > kMaxLog2D || n_rows < 1 || n_rows > (int64_t)0x3fffffff)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_log2d(log2d, NopLaunch{n_rows, static_cast<cudaStream_t>(stream)});
}
