// Shared pieces of the Walsh-Hadamard kernels (whvi_fused.cu, fwht.cu, and
// the row kernels of whvi_kron.cu, kron_swap_kernel and kron_cur_kernel):
// the register-resident radix-2 butterfly over one row, the block shape,
// the bf16 rounding of registers, and the broadcast geometry the fused
// product receives from its Python wrapper (whvi_tpu_torch/ops/fwht_cuda.py).
//
// Layout. A row of D = 2^log2d floats is held by tpr = D / R threads, R =
// 2^log2_regs(log2d) elements in registers each (R = D up to D = 16; 16
// up to D = 4096; 32 above). A block has max(tpr, 256) threads, so it
// holds block / tpr rows: one row for D >= 4096, 256 rows for D <= 16.
//
// A window is the set of r = log2 R index bits that a thread holds in
// registers; the thread's own bits are those of E = row * D + e (its
// block's rows viewed as one index space) outside the window, low bits
// first. The I/O window holds bits 0, 1 and the top r - 2 bits of e:
// register group g is the float4 at 4 (g tpr + lane), so rows are loaded
// and stored in it with 16-byte accesses, a warp's consecutive. Any other
// window is r contiguous bits [base, base + r). Every butterfly stage
// whose bit lies in the window held runs in registers; to reach the next
// stage the block exchanges the row through shared memory once (write in
// the old window, one barrier, read in the new). At D = 4096 (R = 16) a
// transform runs stages 0-1 in the I/O window, 2-5 and 6-9 in two
// contiguous windows, and 10-11 back in the I/O window: 3 exchanges and 3
// barriers, where a barrier a stage took 12.
//
// Exchanges alternate between two buffers, so one barrier each suffices:
// the next write into a buffer follows the barrier after its reads. Rows
// of tpr <= 32 threads lie within one warp, which syncs alone. Slots are
// XOR-swizzled, slot(E) = E ^ (((E >> (r + 2)) & 7) << 2), a bijection
// that keeps float4 groups whole: from D = 128 up, a warp's accesses of
// one register index hit 32 distinct banks (8 distinct 16-byte groups a
// quarter-warp in the I/O window) in every window.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace whvi {

constexpr int kMaxLog2D = 14;
constexpr int kMinBlockThreads = 256;
constexpr int kMidLog2Regs = 4;     // D = 32 .. 4096: 16 elements a thread
constexpr int kLargeLog2Regs = 5;   // D = 8192, 16384: 32 elements a thread
constexpr int kLargeFromLog2D = 13;
// Registers a thread may take (the launch bounds ask for enough blocks an
// SM to hold it to this): two 256-thread blocks an SM, one of 512.
constexpr int kRegCap = 128;

// Element strides of the four operands (x, s1, u, s2, in that order) over
// the output's leading shape, collapsed by the wrapper to at most four
// dims, outermost first. A broadcast axis has stride 0; unused dims have
// size 1. The last (transform) axis of every operand is contiguous.
struct Geometry {
  int64_t size[4];
  int64_t stride[4][4];  // [operand][dim]
};

__host__ __device__ constexpr int log2_regs(int log2d) {
  return log2d <= kMidLog2Regs ? log2d
         : log2d < kLargeFromLog2D ? kMidLog2Regs : kLargeLog2Regs;
}

__host__ __device__ constexpr int threads_per_row(int log2d) {
  return 1 << (log2d - log2_regs(log2d));
}

__host__ __device__ constexpr int block_threads(int log2d) {
  return threads_per_row(log2d) > kMinBlockThreads ? threads_per_row(log2d)
                                                   : kMinBlockThreads;
}

__host__ __device__ constexpr int rows_per_block(int log2d) {
  return block_threads(log2d) / threads_per_row(log2d);
}

// Blocks an SM the launch bounds ask for: as many as the register cap lets in.
__host__ __device__ constexpr int min_blocks(int log2d) {
  return 65536 / (block_threads(log2d) * kRegCap) > 1
             ? 65536 / (block_threads(log2d) * kRegCap)
             : 1;
}

// Dynamic shared memory of a block: the two exchange buffers, none when a
// thread holds its whole row.
inline size_t exchange_bytes(int log2d) {
  if (threads_per_row(log2d) == 1) return 0;
  return 2 * ((size_t)block_threads(log2d) << log2_regs(log2d)) * sizeof(float);
}

// v <- the thread's share of a row in the I/O window: register group g
// (registers 4g .. 4g+3) is the float4 at p + 4 g tpr, so a warp's loads
// are consecutive 16-byte words (one 8-byte load for D = 2). The wrapper
// checks that every row start is aligned for them.
template <int R, int kTpr>
__device__ __forceinline__ void load_regs(float (&v)[R], const float* __restrict__ p) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      const float4 q = *reinterpret_cast<const float4*>(p + 4 * g * kTpr);
      v[4 * g] = q.x; v[4 * g + 1] = q.y; v[4 * g + 2] = q.z; v[4 * g + 3] = q.w;
    }
  } else {
    static_assert(R == 2 && kTpr == 1, "R is a power of two >= 2");
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int R, int kTpr>
__device__ __forceinline__ void store_regs(float* __restrict__ p, const float (&v)[R]) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int g = 0; g < R / 4; ++g)
      *reinterpret_cast<float4*>(p + 4 * g * kTpr) =
          make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

constexpr int kSplit = -1;  // the I/O window

// The compile-time shape of a row of 2^L floats and its windows. A window
// is kSplit, the I/O window (index bits 0, 1 and the top r - 2), or a
// base b >= 0, the contiguous bits [b, b + r).
template <int L>
struct RowShape {
  static constexpr int kLog2R = log2_regs(L);
  static constexpr int R = 1 << kLog2R;
  static constexpr int kTpr = 1 << (L - kLog2R);
  static constexpr int kBlock = block_threads(L);
  static constexpr int kRows = kBlock / kTpr;
  static constexpr int kTop = L - kLog2R;  // the highest contiguous window
  static constexpr int kBufBytes = kBlock * R * (int)sizeof(float);
  static constexpr int kMinBlocks = min_blocks(L);
  static constexpr int kSwizzleShift = kLog2R + 2;

  // Whether window w holds index bit s (a thread holding its whole row
  // holds every bit), and which register bit it is.
  __host__ __device__ static constexpr bool holds(int w, int s) {
    if (kTpr == 1) return true;
    return w == kSplit ? (s < 2 || s >= kTop + 2) : (s >= w && s < w + kLog2R);
  }
  __host__ __device__ static constexpr int reg_bit(int w, int s) {
    if (kTpr == 1) return s;
    return w == kSplit ? (s < 2 ? s : s - kTop) : s - w;
  }
  // The window to move to for stage s, stages running up (or down): the
  // I/O window if it holds s, else the contiguous window from s up (or
  // down to s, its base kept >= 2, which keeps the exchanges free of bank
  // conflicts).
  __host__ __device__ static constexpr int window_for(int s, bool up) {
    if (holds(kSplit, s)) return kSplit;
    const int b = up ? s : (s - kLog2R + 1 > 2 ? s - kLog2R + 1 : 2);
    return b < kTop ? b : kTop;
  }
  // The window held after stages s, s + step, .. (end excluded) from w.
  __host__ __device__ static constexpr int after(int w, int s, int end, int step) {
    for (; s != end; s += step)
      if (!holds(w, s)) w = window_for(s, step > 0);
    return w;
  }
  // Index bits of register j in window w (kTpr > 1).
  __host__ __device__ static constexpr int reg_index(int w, int j) {
    return w == kSplit ? (j & 3) | ((j >> 2) << (kTop + 2)) : j << w;
  }
  // Shared-memory slot of block index E = row * D + e: bits 2-4 XOR bits
  // kSwizzleShift .. +2, a bijection that keeps float4 groups whole and
  // linear over GF(2), so slot(a | b) = slot(a) ^ slot(b) for disjoint bits.
  __host__ __device__ static constexpr int slot(int e) {
    return e ^ (((e >> kSwizzleShift) & 7) << 2);
  }
};

// One thread's share of the block's rows, and the exchange buffer to use.
template <int L>
struct RowExchange {
  using S = RowShape<L>;
  char* smem;    // two buffers of S::kBufBytes
  int tid;
  int buf = 0;   // byte offset of the buffer the next exchange writes

  // block index E of this thread's register 0 in window kW: the thread's
  // bits are those of E outside the window, low bits first
  template <int kW>
  __device__ __forceinline__ int lane_index() const {
    if constexpr (kW == kSplit) {
      return ((tid % S::kTpr) << 2) | ((tid / S::kTpr) << L);
    } else {
      return (tid & ((1 << kW) - 1)) | ((tid >> kW) << (kW + S::kLog2R));
    }
  }

  // its byte offset in an exchange buffer
  template <int kW>
  __device__ __forceinline__ int lane_bytes() const {
    return 4 * S::slot(lane_index<kW>());
  }

  __device__ __forceinline__ void sync() const {
    if constexpr (S::kTpr <= 32) __syncwarp();
    else __syncthreads();
  }

  // Move v from window kFrom to window kTo: one address XOR a register,
  // 16-byte accesses in the I/O window.
  template <int kFrom, int kTo>
  __device__ __forceinline__ void move(float (&v)[S::R]) {
    const int w = lane_bytes<kFrom>() | buf;
    if constexpr (kFrom == kSplit) {
#pragma unroll
      for (int j = 0; j < S::R; j += 4)
        *reinterpret_cast<float4*>(smem + (w ^ (4 * S::slot(S::reg_index(kFrom, j))))) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < S::R; ++j)
        *reinterpret_cast<float*>(smem + (w ^ (4 * S::slot(S::reg_index(kFrom, j))))) = v[j];
    }
    sync();
    const int r = lane_bytes<kTo>() | buf;
    if constexpr (kTo == kSplit) {
#pragma unroll
      for (int j = 0; j < S::R; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(
            smem + (r ^ (4 * S::slot(S::reg_index(kTo, j)))));
        v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < S::R; ++j)
        v[j] = *reinterpret_cast<const float*>(smem + (r ^ (4 * S::slot(S::reg_index(kTo, j)))));
    }
    buf ^= S::kBufBytes;
  }
};

// v rounded to bf16 (to nearest even) in place, two values a conversion
template <int R>
__device__ __forceinline__ void round_bf16(float (&v)[R]) {
#pragma unroll
  for (int j = 0; j < R; j += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[j], v[j + 1]);
    v[j] = __low2float(h);
    v[j + 1] = __high2float(h);
  }
}

// The radix-2 stage on register bit k: pairs j and j + 2^k, a + b and
// a - b, as stage s pairs elements e and e + 2^s in the plain version
// (ops/hadamard.py:fwht).
template <int k, int R>
__device__ __forceinline__ void butterfly(float (&v)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (j & (1 << k)) continue;
    const float a = v[j];
    const float b = v[j | (1 << k)];
    v[j] = a + b;
    v[j | (1 << k)] = a - b;
  }
}

// Stages kS, kS + kStep, .. (kEnd excluded), starting in window kW, each
// in registers, exchanging the row whenever the window held does not hold
// the next stage (RowShape::window_for); the window held after them is
// RowShape<L>::after(kW, kS, kEnd, kStep). Stages 0 .. k-1 apply H_(2^k)
// to the low k index bits and stages k .. L-1 the factor of the high
// bits, so a range of stages is one Kronecker factor of H_D; run upwards,
// the stages add in the plain version's order. Every thread of the block
// calls it.
template <int L, int kW, int kS, int kEnd, int kStep>
__device__ __forceinline__ void butterflies(float (&v)[RowShape<L>::R], RowExchange<L>& ex) {
  using S = RowShape<L>;
  if constexpr (kS != kEnd) {
    if constexpr (S::holds(kW, kS)) {
      butterfly<S::reg_bit(kW, kS)>(v);
      butterflies<L, kW, kS + kStep, kEnd, kStep>(v, ex);
    } else {
      constexpr int nw = S::window_for(kS, kStep > 0);
      ex.template move<kW, nw>(v);
      butterflies<L, nw, kS, kEnd, kStep>(v, ex);
    }
  }
}

// From window kW back to the I/O window.
template <int L, int kW>
__device__ __forceinline__ void to_io_window(float (&v)[RowShape<L>::R], RowExchange<L>& ex) {
  if constexpr (kW != kSplit) ex.template move<kW, kSplit>(v);
}

// Base offsets (in elements) of x, s1, u, s2 for output row `row`: size-1
// dims skipped, 32-bit division where the operands fit.
__device__ __forceinline__ void row_offsets(int64_t row, const Geometry& g, int64_t (&off)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) off[k] = 0;
  uint64_t r = (uint64_t)row;
#pragma unroll
  for (int d = 3; d >= 0; --d) {
    const uint64_t n = (uint64_t)g.size[d];
    if (n == 1) continue;
    const uint64_t q = ((r | n) >> 32) == 0 ? (uint64_t)((uint32_t)r / (uint32_t)n) : r / n;
    const int64_t idx = (int64_t)(r - q * n);
    r = q;
#pragma unroll
    for (int k = 0; k < 4; ++k) off[k] += idx * g.stride[k][d];
  }
}

// Runs fn.template operator()<L>() for L = log2d in 1 .. kMaxLog2D.
template <typename Fn>
cudaError_t dispatch_log2d(int log2d, Fn&& fn) {
  switch (log2d) {
    case 1: return fn.template operator()<1>();
    case 2: return fn.template operator()<2>();
    case 3: return fn.template operator()<3>();
    case 4: return fn.template operator()<4>();
    case 5: return fn.template operator()<5>();
    case 6: return fn.template operator()<6>();
    case 7: return fn.template operator()<7>();
    case 8: return fn.template operator()<8>();
    case 9: return fn.template operator()<9>();
    case 10: return fn.template operator()<10>();
    case 11: return fn.template operator()<11>();
    case 12: return fn.template operator()<12>();
    case 13: return fn.template operator()<13>();
    case 14: return fn.template operator()<14>();
    default: return cudaErrorInvalidValue;
  }
}
static_assert(kMaxLog2D == 14, "dispatch_log2d covers L = 1 .. 14");

}  // namespace whvi
