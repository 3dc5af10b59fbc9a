// Fused WHVI structured product y = s1 * H(u * H(s2 * x)) in bf16 storage
// (entry whvi_fused_bf16s): x, the diagonals, y, i1 and i2 are bf16.
//
// Replaces, as whvi_fused.cu does in fp32 storage, the Pallas kernels of
// whvi_tpu/ops/fwht_pallas.py: _kernel_1f_y / _kernel_2f_y (y only;
// kResiduals = false), _kernel_1f / _kernel_2f (y, i1, i2) and, launched
// on (s2, u, s1, g), the transform half of _bwd. The JAX package runs bf16
// leaves (dtype=bfloat16) through the XLA expression
// s1 * fwht(u * fwht(s2 * x)) (its Pallas kernels raise on bf16 refs), each
// op rounding to bf16 (R, to nearest even) and each transform summing in
// fp32:
//   t0 = R(s2 x), i1 = R(H t0), t1 = R(u i1), i2 = R(H t1), y = R(s1 i2).
// The kernel computes in fp32 registers and rounds at those five points.
// The products of two bf16 are exact in fp32 and are __fmul_rn, never
// contracted into an add; each transform runs stages 0 .. L-1 in order,
// stage s pairing e and e + 2^s as ops/hadamard.py:fwht does. So y, i1 and
// i2 equal the plain version's (fwht_cuda.fused_plain) bit for bit.
//
// What bounds it on an H100. Per element it reads x and the diagonals (2
// bytes each, the diagonals from L2 once broadcast) and writes y, plus i1
// and i2 with residuals: at 2 bytes an element the bound is half of fp32
// storage's, while the work in the SM is not: 2 L adds, 3 products and 5
// roundings an element, and the row's crossings of shared memory between
// register windows. The fp32-storage design (whvi_fused.cu: 16 floats a
// thread, 2 rows an SM) spends 6 fp32 exchanges a product at D = 4096,
// 192 KB of shared-memory traffic a row; on bf16 storage its time was
// that of its exchanges and of the latency of its loads (PERF.md).
//
// The design. A thread holds R = 2^r elements (r = 5 up to D = 4096, 6
// above: 32 or 64 a thread), a row tpr = D / R threads (128 at D = 4096),
// a block one row (several rows of small D). A window is the set of r
// index bits a thread holds in registers. Each transform starts and ends
// in the I/O window kIo: bits 0-2 and the top r - 3 bits, so a thread's
// registers are groups of 8 consecutive elements, consecutive across a
// warp, and every row moves in 16-byte accesses a warp's consecutive. The
// I/O window holds a transform's first 3 and last r - 3 stages; the stages
// between run in contiguous windows [b, b + r) (two at D = 4096, 8192 and
// 16384): 3 fp32 exchanges a transform there, as in whvi_fused.cu, and
// every rounding point (t0, i1, t1, i2, y) falls in the I/O window, where
// rows load and store. Diagonals are applied 8 elements to a 16-byte load,
// never held as a whole share: at D = 4096 a thread takes 64 registers
// (kBf16sRegCap) and 8 rows of 4 warps share an SM, where the fp32-storage
// design's 102-109 registers left 2 rows of 8 warps. Fewer exchanges
// measured slower: 64 elements a thread (2 exchanges a transform at D =
// 4096) takes 128 registers, half the warps (PERF.md).
//
// One fp32 buffer a row (slot32: padded by 4 slots every 32 and 4 every
// 2^(r+2), free of bank conflicts in every window from D = 4096 up, a sum
// of the lane's and the register's parts, so the register's part is an
// address offset), one barrier an exchange and one more before every
// exchange but the first: a write into a buffer must follow a barrier
// after its last reads (kBf16sFp32Buffers = 2 alternates two buffers
// instead). tests/test_torch_bf16s_schedule.py simulates the schedule in
// numpy against the plain version and checks the conflicts and barriers.
//
// Other designs stay behind switches, timed by tools/kernel_variants.py
// (PERF.md): the window-0 schedule (kBf16sIoSchedule = false: each
// transform from [0, r) to [L - r, L), the exchange between the two
// carrying rounded values in bf16, i2, s1 and y through one more into the
// I/O window, or x and s2 through one from it), whose 16-byte accesses in
// window [0, r) are 2^r * 2 bytes apart across a warp; u and s1 copied
// into shared memory at the start (kBf16sPrefetch); two fp32 buffers; 16,
// 64 or 128 elements a thread; other caps and block sizes.
//
// Broadcasting as in whvi_fused.cu: per-operand leading strides (0 on a
// broadcast axis) over at most 4 dims, each row's offsets computed once
// (row_offsets), rows aligned to min(2 D, 16) bytes (the entry checks).
#include "fwht_core.cuh"

namespace whvi {

// The design's switches (tools/kernel_variants.py times other settings).
// kBf16sLoadViaIo and kBf16sStoreViaIo act under the window-0 schedule.
constexpr int kBf16sLog2Regs = 5;        // elements a thread: 2^5 up to D = 4096
constexpr int kBf16sLargeLog2Regs = 6;   // from D = 2^kBf16sLargeFromLog2D
constexpr int kBf16sLargeFromLog2D = 13;
constexpr int kBf16sMinBlock = 64;       // threads a block, at least
constexpr int kBf16sRegCap = 64;         // registers a thread the launch bounds allow (spills
                                         // of 12-28 bytes at D = 32-128 with residuals),
constexpr int kBf16sLargeRegCap = 255;   // and from D = 2^kBf16sLargeFromLog2D
constexpr bool kBf16sIoSchedule = true;  // each transform from the I/O window back to it
constexpr int kBf16sFp32Buffers = 1;     // fp32 exchanges alternate between 2 buffers, or 1
constexpr bool kBf16sPrefetch = false;   // I/O schedule: u, s1 into shared memory at the start
constexpr bool kBf16sLoadViaIo = false;  // x, s2 through a bf16 exchange from kIo
constexpr bool kBf16sStoreViaIo = true;  // i2, s1, y through one into kIo

constexpr int kIo = -1;  // the I/O window

template <int L>
struct Bf16sShape {
  static constexpr int kWant = L >= kBf16sLargeFromLog2D ? kBf16sLargeLog2Regs : kBf16sLog2Regs;
  static constexpr int kLog2R = L < kWant ? L : kWant;
  static constexpr int R = 1 << kLog2R;
  static constexpr int kTpr = 1 << (L - kLog2R);
  static constexpr int kBlock = kTpr > kBf16sMinBlock ? kTpr : kBf16sMinBlock;
  static constexpr int kRows = kBlock / kTpr;
  static constexpr int kLast = L - kLog2R;  // base of the top contiguous window
  static constexpr int kTopIo = kLast + 3;  // the I/O window's lowest top bit
  static constexpr bool kIoSchedule = kBf16sIoSchedule && kTpr > 1;
  static constexpr bool kW0Schedule = !kBf16sIoSchedule && kTpr > 1;
  static constexpr int kRegCap = L >= kBf16sLargeFromLog2D ? kBf16sLargeRegCap : kBf16sRegCap;
  static constexpr int kMinBlocks =
      65536 / (kBlock * kRegCap) > 1 ? 65536 / (kBlock * kRegCap) : 1;
  static_assert(kTpr == 1 || kLog2R >= 4, "a window holds a 16-byte group and more");

  // A transform's windows k = 0 .. kWindows-1: window(k) runs stages
  // [lo(k), lo(k + 1)). The I/O schedule: the I/O window (stages 0-2),
  // contiguous windows, the I/O window (its top bits). The window-0
  // schedule: [0, r), [r, 2r), .., the last moved down to [L - r, L).
  static constexpr int kMid = kIoSchedule ? (kTopIo - 3 + kLog2R - 1) / kLog2R : 0;
  static constexpr int kWindows = kTpr == 1    ? 1
                                  : kIoSchedule ? kMid + 2
                                                : (L + kLog2R - 1) / kLog2R;
  __host__ __device__ static constexpr int lo(int k) {
    if (k >= kWindows) return L;
    if (!kIoSchedule) return k * kLog2R;
    return k == 0 ? 0 : k == kWindows - 1 ? kTopIo : 3 + (k - 1) * kLog2R;
  }
  __host__ __device__ static constexpr int window(int k) {
    if (kTpr == 1) return 0;
    if (!kIoSchedule) return k * kLog2R < kLast ? k * kLog2R : kLast;
    if (k == 0 || k == kWindows - 1) return kIo;
    const int b = lo(k) < kTopIo - kLog2R ? lo(k) : kTopIo - kLog2R;
    return b > 0 ? b : 0;
  }
  // register bit of stage s in window w
  __host__ __device__ static constexpr int reg_bit(int w, int s) {
    return w == kIo ? (s < 3 ? s : s - kTopIo + 3) : s - w;
  }
  static constexpr int kFirst = window(0), kEnd = window(kWindows - 1);
  // the windows rows load (x, s2), meet u and store i1, store (i2, s1, y) in
  static constexpr int kIn = kW0Schedule && kBf16sLoadViaIo ? kIo : kFirst;
  static constexpr int kOut = kW0Schedule && kBf16sStoreViaIo ? kIo : kEnd;
  static constexpr bool kExIn = kIn != kFirst, kExMid = kEnd != kFirst, kExOut = kOut != kEnd;

  // Index bits of register j in window w, and of thread t (t < kTpr) and
  // row-in-block q outside it: together E = q D + e.
  __host__ __device__ static constexpr int reg_index(int w, int j) {
    return kTpr == 1 ? j
           : w == kIo ? (j & 7) | ((j >> 3) << kTopIo)
                      : j << w;
  }
  __host__ __device__ static constexpr int lane_index(int w, int t, int q) {
    return (kTpr == 1 ? 0
            : w == kIo ? t << 3
                       : (t & ((1 << w) - 1)) | ((t >> w) << (w + kLog2R))) |
           (q << L);
  }
  // Shared-memory slots of block index E, keeping float4 groups (fp32)
  // or groups of 8 (bf16) whole. Under the I/O schedule the fp32 buffer is
  // padded, 4 slots after every 32 and 4 more after every 2^(r+2) (14%
  // more memory at r = 6): free of bank conflicts at r = 5, 6, 7 from D =
  // 4096 up, and a sum of the lane's and the register's parts (slot(a | b)
  // = slot(a) + slot(b) for disjoint bits), so the register's part is an
  // address offset the compiler folds into the access. Under the window-0
  // schedule slots are XOR-swizzled (slot(a | b) = slot(a) ^ slot(b)):
  // fp32 bits 2-4 XOR bits r .. r+2, bf16 bits 3-5 XOR them.
  __host__ __device__ static constexpr int slot32(int e) {
    return kIoSchedule ? e + 4 * (e >> 5) + 4 * (e >> (kLog2R + 2)) : e ^ (((e >> kLog2R) & 7) << 2);
  }
  __host__ __device__ static constexpr int slot16(int e) {
    return e ^ (((e >> kLog2R) & 7) << 3);
  }
  // slot(lane | reg) from slot(lane) and slot(reg)
  __host__ __device__ static constexpr int join32(int lane, int reg) {
    return kIoSchedule ? lane + reg : lane ^ reg;
  }

  // Shared memory: kBf16sFp32Buffers fp32 buffers, then the bf16
  // exchanges' buffer (the window-0 schedule) or the rows of u and s1
  // (kPrefetch: 4 bytes an element).
  static constexpr bool kPrefetch = kBf16sPrefetch && kIoSchedule;
  static constexpr int kFp32Buffers = kTpr == 1 ? 0 : kBf16sFp32Buffers;
  static constexpr int kBuf32 = 4 * (kIoSchedule ? slot32((kRows << L) - 1) + 1 : kRows << L);
  static constexpr int kBuf16 = kFp32Buffers * kBuf32;
  static constexpr int kSmemBytes =
      kBuf16 + (kW0Schedule ? 2 * (kRows << L) : kPrefetch ? 4 * (kRows << L) : 0);
};

// v <- v * (8 bf16 of q), each product rounded once, never fused into an add
__device__ __forceinline__ void scale8(float* v, uint4 q) {
  float d[8];
  unpack4(make_uint2(q.x, q.y), d);
  unpack4(make_uint2(q.z, q.w), d + 4);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __fmul_rn(v[k], d[k]);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  const uint2 a = pack4(v), b = pack4(v + 4);
  return make_uint4(a.x, a.y, b.x, b.y);
}

// A thread's share of a row in window kW and device memory: p is the row's
// start, t the thread's index in its row. Window [0, r) and the I/O window
// move groups of 8 in 16-byte accesses; the last window one element an
// access, a warp's consecutive. A thread holding its whole row reads it in
// order (load_regs).
template <int L, int kW>
struct RowIo {
  using S = Bf16sShape<L>;
  static constexpr bool kGroups = S::kTpr == 1 || kW == 0 || kW == kIo;
  static_assert(kGroups || kW == S::kLast, "rows move in window 0, the I/O window or the top");

  // element offset of register group g (8 registers) or of register j
  __device__ static __forceinline__ int group(int t, int g) {
    return kW == kIo ? 8 * (g * S::kTpr + t) : (t << S::kLog2R) + 8 * g;
  }
  __device__ static __forceinline__ int single(int t, int j) { return t + (j << S::kLast); }

  __device__ static __forceinline__ void load(float (&v)[S::R], const __nv_bfloat16* p, int t) {
    if constexpr (S::kTpr == 1 || S::R < 8) {
      load_regs<S::R, 1>(v, p);
    } else if constexpr (kGroups) {
#pragma unroll
      for (int g = 0; g < S::R / 8; ++g) {
        const uint4 q = *reinterpret_cast<const uint4*>(p + group(t, g));
        unpack4(make_uint2(q.x, q.y), v + 8 * g);
        unpack4(make_uint2(q.z, q.w), v + 8 * g + 4);
      }
    } else {
#pragma unroll
      for (int j = 0; j < S::R; ++j) v[j] = __bfloat162float(p[single(t, j)]);
    }
  }

  // v <- v * d, d read in the same layout
  __device__ static __forceinline__ void scale(float (&v)[S::R], const __nv_bfloat16* p, int t) {
    if constexpr (S::R < 8) {
      float d[S::R];
      load_regs<S::R, 1>(d, p);
#pragma unroll
      for (int j = 0; j < S::R; ++j) v[j] = __fmul_rn(v[j], d[j]);
    } else if constexpr (kGroups) {
#pragma unroll
      for (int g = 0; g < S::R / 8; ++g)
        scale8(v + 8 * g, *reinterpret_cast<const uint4*>(p + (S::kTpr == 1 ? 8 * g : group(t, g))));
    } else {
#pragma unroll
      for (int j = 0; j < S::R; ++j) v[j] = __fmul_rn(v[j], __bfloat162float(p[single(t, j)]));
    }
  }

  // p's groups copied to shared memory at sp (the same order, so a
  // warp's 16-byte writes are consecutive) without a register, for
  // scale(v, sp, t) after cp_async_wait: the thread reads only its own
  // copies, so no barrier
  __device__ static __forceinline__ void prefetch(__nv_bfloat16* sp, const __nv_bfloat16* p, int t) {
    static_assert(kW == kIo && S::kTpr > 1, "prefetch is of the I/O window");
#pragma unroll
    for (int g = 0; g < S::R / 8; ++g) {
      const unsigned a = (unsigned)__cvta_generic_to_shared(sp + group(t, g));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a), "l"(p + group(t, g)) : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // the store rounds to bf16 (exactly, where v is rounded already)
  __device__ static __forceinline__ void store(__nv_bfloat16* p, const float (&v)[S::R], int t) {
    if constexpr (S::kTpr == 1 || S::R < 8) {
      store_regs<S::R, 1>(p, v);
    } else if constexpr (kGroups) {
#pragma unroll
      for (int g = 0; g < S::R / 8; ++g)
        *reinterpret_cast<uint4*>(p + group(t, g)) = pack8(v + 8 * g);
    } else {
#pragma unroll
      for (int j = 0; j < S::R; ++j) p[single(t, j)] = __float2bfloat16_rn(v[j]);
    }
  }
};

// One thread's share of the block's rows in the exchanges. A write into a
// buffer must follow a barrier after its last reads: fp32 exchange n uses
// fp32 buffer n % kFp32Buffers, and with one buffer an fp32 exchange
// right after another waits at one more barrier first (kAfter32); the
// bf16 exchanges have a buffer of their own and never follow each other.
template <int L>
struct Bf16sExchange {
  using S = Bf16sShape<L>;
  char* smem;
  int t, q;  // the thread's index in its row, its row in the block

  __device__ __forceinline__ void sync() const {
    if constexpr (S::kTpr <= 32) __syncwarp();
    else __syncthreads();
  }

  // Move v from window kFrom to window kTo through fp32 buffer kBuf (v's
  // unrounded sums): float4s in window 0 and the I/O window.
  template <int kFrom, int kTo, int kBuf, bool kAfter32>
  __device__ __forceinline__ void move32(float (&v)[S::R]) {
    char* const p = smem + kBuf * S::kBuf32;
    if constexpr (kAfter32) sync();
    constexpr int kWs = kFrom == 0 || kFrom == kIo ? 4 : 1;
    constexpr int kRs = kTo == 0 || kTo == kIo ? 4 : 1;
    const int w = S::slot32(S::lane_index(kFrom, t, q));
#pragma unroll
    for (int j = 0; j < S::R; j += kWs) {
      float* a = reinterpret_cast<float*>(p) + S::join32(w, S::slot32(S::reg_index(kFrom, j)));
      if constexpr (kWs == 4) *reinterpret_cast<float4*>(a) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      else *a = v[j];
    }
    sync();
    const int r = S::slot32(S::lane_index(kTo, t, q));
#pragma unroll
    for (int j = 0; j < S::R; j += kRs) {
      const float* a = reinterpret_cast<const float*>(p) + S::join32(r, S::slot32(S::reg_index(kTo, j)));
      if constexpr (kRs == 4) {
        const float4 f = *reinterpret_cast<const float4*>(a);
        v[j] = f.x; v[j + 1] = f.y; v[j + 2] = f.z; v[j + 3] = f.w;
      } else {
        v[j] = *a;
      }
    }
  }

  // The same through the bf16 buffer, for v rounded to bf16 (exact):
  // groups of 8 in 16-byte accesses in window 0 and the I/O window.
  template <int kFrom, int kTo>
  __device__ __forceinline__ void move16(float (&v)[S::R]) {
    char* const p = smem + S::kBuf16;
    constexpr int kWs = kFrom == 0 || kFrom == kIo ? 8 : 1;
    constexpr int kRs = kTo == 0 || kTo == kIo ? 8 : 1;
    const int w = S::slot16(S::lane_index(kFrom, t, q));
#pragma unroll
    for (int j = 0; j < S::R; j += kWs) {
      __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(p) + (w ^ S::slot16(S::reg_index(kFrom, j)));
      if constexpr (kWs == 8) *reinterpret_cast<uint4*>(a) = pack8(v + j);
      else *a = __float2bfloat16_rn(v[j]);
    }
    sync();
    const int r = S::slot16(S::lane_index(kTo, t, q));
#pragma unroll
    for (int j = 0; j < S::R; j += kRs) {
      const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(p) + (r ^ S::slot16(S::reg_index(kTo, j)));
      if constexpr (kRs == 8) {
        const uint4 f = *reinterpret_cast<const uint4*>(a);
        unpack4(make_uint2(f.x, f.y), v + j);
        unpack4(make_uint2(f.z, f.w), v + j + 4);
      } else {
        v[j] = __bfloat162float(*a);
      }
    }
  }
};

// Stages kS .. kE - 1 of window kW, in order.
template <int L, int kW, int kS, int kE>
__device__ __forceinline__ void window_stages(float (&v)[Bf16sShape<L>::R]) {
  if constexpr (kS < kE) {
    butterfly<Bf16sShape<L>::reg_bit(kW, kS)>(v);
    window_stages<L, kW, kS + 1, kE>(v);
  }
}

// One transform, stages 0 .. L-1 in order, window k = 0 .. kWindows-1,
// one fp32 exchange between windows; kN counts the product's fp32
// exchanges before this one, kAfter32 whether one comes right before.
template <int L, int kN, bool kAfter32, int k = 0>
__device__ __forceinline__ void transform(float (&v)[Bf16sShape<L>::R], Bf16sExchange<L>& ex) {
  using S = Bf16sShape<L>;
  window_stages<L, S::window(k), S::lo(k), S::lo(k + 1)>(v);
  if constexpr (k + 1 < S::kWindows) {
    ex.template move32<S::window(k), S::window(k + 1), kN % S::kFp32Buffers,
                       kAfter32 && S::kFp32Buffers == 1>(v);
    transform<L, kN + 1, true, k + 1>(v, ex);
  }
}

// One block a group of kRows rows: the thread's row is blockIdx.x * kRows
// + tid / kTpr.
template <int L, bool kResiduals>
__global__ void __launch_bounds__(Bf16sShape<L>::kBlock, Bf16sShape<L>::kMinBlocks)
    whvi_bf16s_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ s1,
                      const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ s2,
                      __nv_bfloat16* __restrict__ y, __nv_bfloat16* __restrict__ i1,
                      __nv_bfloat16* __restrict__ i2, int64_t n_rows, Geometry geom) {
  using S = Bf16sShape<L>;
  using In = RowIo<L, S::kIn>;
  using Mid = RowIo<L, S::kFirst>;
  using Out = RowIo<L, S::kOut>;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int t = tid % S::kTpr;
  const int64_t row = (int64_t)blockIdx.x * S::kRows + tid / S::kTpr;
  const bool active = row < n_rows;
  const int64_t out = row << L;
  Bf16sExchange<L> ex{smem, t, tid / S::kTpr};

  int64_t off[4];  // row starts of x, s1, u, s2
  float v[S::R];
  // kPrefetch: the row's u and s1, copied in while the first transform runs
  __nv_bfloat16* const pre =
      reinterpret_cast<__nv_bfloat16*>(smem + S::kBuf16) + 2 * (tid / S::kTpr << L);
  if (active) {
    row_offsets(row, geom, off);
    if constexpr (S::kPrefetch) {
      Mid::prefetch(pre, u + off[2], t);
      Out::prefetch(pre + (1 << L), s1 + off[1], t);
    }
    In::load(v, x + off[0], t);
    In::scale(v, s2 + off[3], t);
    round_bf16(v);  // t0 = R(s2 x)
  } else {
#pragma unroll
    for (int j = 0; j < S::R; ++j) v[j] = 0.f;
  }
  if constexpr (S::kExIn) ex.template move16<S::kIn, S::kFirst>(v);

  // the first transform's fp32 exchanges are 0 .. kWindows-2, the
  // second's follow; under the I/O schedule the second's first comes
  // right after the first's last
  constexpr int kN2 = S::kWindows - 1;
  transform<L, 0, false>(v, ex);
  round_bf16(v);  // i1 = R(H t0)
  if constexpr (S::kExMid) ex.template move16<S::kEnd, S::kFirst>(v);
  if (active) {
    if (kResiduals) Mid::store(i1 + out, v, t);
    if constexpr (S::kPrefetch) asm volatile("cp.async.wait_group 1;" ::: "memory");
    Mid::scale(v, S::kPrefetch ? pre : u + off[2], t);
    round_bf16(v);  // t1 = R(u i1)
  }

  transform<L, kN2, !S::kExMid>(v, ex);
  round_bf16(v);  // i2 = R(H t1)
  if constexpr (S::kExOut) ex.template move16<S::kEnd, S::kOut>(v);
  if (active) {
    if (kResiduals) Out::store(i2 + out, v, t);
    if constexpr (S::kPrefetch) asm volatile("cp.async.wait_group 0;" ::: "memory");
    Out::scale(v, S::kPrefetch ? pre + (1 << L) : s1 + off[1], t);
    Out::store(y + out, v, t);  // y = R(s1 i2), by the store
  }
}

template <int L, bool kResiduals>
cudaError_t launch_bf16s(const __nv_bfloat16* x, const __nv_bfloat16* s1, const __nv_bfloat16* u,
                         const __nv_bfloat16* s2, __nv_bfloat16* y, __nv_bfloat16* i1,
                         __nv_bfloat16* i2, int64_t n_rows, const Geometry& geom,
                         cudaStream_t stream) {
  using S = Bf16sShape<L>;
  const auto kernel = whvi_bf16s_kernel<L, kResiduals>;
  if (S::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n_rows + S::kRows - 1) / S::kRows;
  kernel<<<(unsigned)blocks, S::kBlock, S::kSmemBytes, stream>>>(x, s1, u, s2, y, i1, i2,
                                                                 n_rows, geom);
  return cudaGetLastError();
}

struct Bf16sLaunch {
  bool residuals;
  const __nv_bfloat16 *x, *s1, *u, *s2;
  __nv_bfloat16 *y, *i1, *i2;
  int64_t n_rows;
  const Geometry& geom;
  cudaStream_t stream;

  template <int L>
  cudaError_t operator()() const {
    return residuals ? launch_bf16s<L, true>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream)
                     : launch_bf16s<L, false>(x, s1, u, s2, y, i1, i2, n_rows, geom, stream);
  }
};

}  // namespace whvi

// y (and, when want_residuals, i1 and i2) are contiguous (n_rows, D), every
// tensor bf16, rounded as the header says. Refuses bf16 != 0 (the Pallas
// kernels' bf16 precision has no bf16-storage form) and any operand whose
// rows are off min(2 D, 16) bytes (the 16-byte accesses would fault):
// cudaErrorInvalidValue, nothing launched. Returns the launch's
// cudaError_t (0 on success).
extern "C" int whvi_fused_bf16s(const void* x, const void* s1, const void* u,
                                const void* s2, void* y, void* i1, void* i2,
                                int want_residuals, int bf16, int64_t n_rows,
                                int log2d, const whvi::Geometry* geom,
                                void* stream) {
  using T = __nv_bfloat16;
  if (bf16 != 0 || log2d < 1 || log2d > whvi::kMaxLog2D || n_rows < 0 ||
      n_rows > (int64_t)0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[7] = {x, s1, u, s2, y, want_residuals ? i1 : nullptr,
                         want_residuals ? i2 : nullptr};
  const int64_t width = (2 << log2d) < 16 ? (2 << log2d) : 16;
  if (!whvi::rows_aligned(ptrs, 7, *geom, sizeof(T), width)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const whvi::Bf16sLaunch launch{
      want_residuals != 0,
      static_cast<const T*>(x), static_cast<const T*>(s1),
      static_cast<const T*>(u), static_cast<const T*>(s2),
      static_cast<T*>(y), static_cast<T*>(i1), static_cast<T*>(i2),
      n_rows, *geom, static_cast<cudaStream_t>(stream)};
  return (int)whvi::dispatch_log2d(log2d, launch);
}
