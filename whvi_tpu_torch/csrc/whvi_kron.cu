// The stage-by-stage and layout variants of the Kronecker-factor WHVI
// product, fp32 in and out, bf16 factor operands, fp32 accumulation.
//
// Replaces the Pallas kernel bodies of the TPU diagnosis harnesses:
//   benchmarks/pallas_diag.py  k_copy, k_scale (stage = copy, scale);
//   benchmarks/pallas_tune.py  k_cur, k_swap, k_onecast
//                              (stage = full, layout = cur/swap/onecast).
// kron_kernel, templated on the stage, runs the floor of the stage ladder:
// the copy and the scale. The tensor-core stages (k_mm1, k_mm2, and the
// whole product of k_full, k_flat and emit_full) are whvi_full.cu's
// kernel. The row kernels, kron_cur_kernel (k_cur and k_onecast) and
// kron_swap_kernel (k_swap), hold each row in registers on fwht_core.cuh.
//
// Tiling, as the TPU grid: block b of kron_kernel owns rows [b*tb,
// (b+1)*tb) of x (B, D); the caller picks tb and B % tb must be 0. The
// row kernels only check tb: their grid is persistent (below).
//
// Layouts:
//   swap     CUDA cores, the row in registers (fwht_core.cuh: a row of D
//            floats over D / R threads, R = 16, or 32 from D = 8192). The
//            TPU body swaps the axes so that every contraction runs over
//            the last axis. Here a contraction runs over the index bits
//            that a thread holds in registers, and the swap is an exchange
//            of the row between register windows through XOR-swizzled
//            shared memory. The body's rounding order: R(s2 x), H_128
//            (stages 0-6), R, H_a (stages 7..L-1), x u, R, H_a (stages
//            L-1..7), R, H_128 (stages 6..0), x s1. Every rounding is of
//            registers: no pass over shared memory, no barrier. From D =
//            2048 this is K1's bf16 schedule (whvi_fused.cu); below it K1
//            contracts one factor and k_swap two, so it does not launch K1.
//   cur      CUDA cores, the row in registers as in swap, each factor
//            contracted in place, as the TPU body contracts the middle
//            axis without moving it. The row stays in the I/O window (index
//            bits 0, 1 and the top ones in registers), where a warp's lanes
//            hold bits 2-6, the rest of H_128's 128-run: H_128's stages 2-6
//            run as warp shuffles (__shfl_xor_sync), its others and H_a's
//            top stages in registers. Only H_a's bits that lie on warps
//            (from D = 1024) take shared memory: one exchange out to the
//            contiguous window from bit 7, where they run and u multiplies
//            (a warp's u for one register is 128 contiguous bytes), and one
//            back. The rounding order is swap's, with H_a's stages in
//            another order (the top ones first).
//   onecast  k_onecast's TPU body computes k_cur's bit for bit (_dotg
//            casts its operand where k_onecast's casts sit), so it launches
//            kron_cur_kernel.
//   copy and scale stream the block's tile through registers, 16 bytes an
//   access, and use no shared memory.
//
// The copy stage is the floor of the stage ladder (bench/kernel_diag.py):
// every rung above it is read as cost beyond it, so it keeps their tiling
// (one block of 256 threads a tile, B / tb blocks) and their route (x
// through registers). What bounded it on an H100 was the bytes in flight
// per SM, not HBM: a loop of one 16-byte load and its store a thread and
// iteration reached 0.74 of HBM at TB = 4 (ptxas hoists four loads, 16 KB
// a block). Here each thread issues kCopyUnroll = 8
// independent streaming loads (ld.global.cs) before their 8 stores
// (st.global.cs): 32 KB in flight a block, one block an SM at TB = 4,
// where 128 tiles leave 4 of the 132 SMs idle. The scale stage runs the
// same loop (one load of x a thread and iteration reached 0.63 of HBM):
// its thread also loads the kCopyUnroll float4s of s1 that its x float4s
// meet, through the read-only cache (__ldg; s1 is D floats, reused by
// every row of the tile), before one __fmul_rn an element, so y is
// x * s1 bit for bit. s1 staged in shared memory once a block was 1%
// slower on the H100 (bench/kron_variants.py, PERF.md).
//
// What bounds it on an H100: at D = 16384 the product moves 8 bytes an
// element (x in, y out) against 2 * 2 * (128 + 128) = 1024 matmul flops
// an element: 2 * 128 flops per byte, below the 295 of the bf16 tensor
// cores, so a tensor-core product is memory-bound once its tensor-core
// work runs near peak: whvi_full.cu's wgmma kernel. The row kernels'
// butterflies cost 2 log2 D adds an element. k_swap's 6 exchanges a row at D = 16384 move
// 6 x 2 x 64 KB through shared memory against the row's 128 KB of HBM, so
// it runs HBM and shared memory in turn; k_cur's 2 exchanges move a third
// of that, and its 10 lane stages a row take R shuffles each, which share
// the SM's shared-memory pipe (32 lanes a clock; a form with R / 2 shuffles
// a stage and the window's bits permuted in between was 2% slower on the
// H100, PERF.md). Both do two things about the HBM
// traffic: a persistent grid (as many blocks as fit on the SMs, each
// walking row blocks b, b + grid, ...), so that their time no longer
// depends on tb; and, while a row block is transformed, one thread has the
// next row block's x loaded into a stage in shared memory by a TMA bulk
// copy (RowBlocks), so the row's HBM load overlaps the previous row's
// work. On the H100 at D = 16384 that was worth 4-6% to k_swap
// (bench/kron_variants.py times each kernel without it): one 512-thread
// block an SM holds the row, so the SM still runs the row's exchanges and
// the HBM traffic in turn; at D = 8192, two blocks an SM, they overlap
// (PERF.md).
#include "fwht_core.cuh"
#include "kron_core.cuh"
#include "tma.cuh"

namespace kron {

enum Layout { kCur = 0, kSwap = 1, kFlat = 2, kOneCast = 3 };  // kFlat: copy, scale

constexpr int kCopyUnroll = 8;  // 16-byte loads in flight a thread

template <int kStage>
__global__ void __launch_bounds__(kThreads)
    kron_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                float* __restrict__ y, int log2d, int tb) {
  static_assert(kStage == kCopy || kStage == kScale);
  const int D = 1 << log2d;
  const int64_t row0 = (int64_t)blockIdx.x * tb;
  const float* xb = x + row0 * D;
  float* yb = y + row0 * D;

  if constexpr (kStage == kCopy) {
    const float4* xs = reinterpret_cast<const float4*>(xb);
    float4* ys = reinterpret_cast<float4*>(yb);
    const int64_t n4 = ((int64_t)tb << log2d) >> 2;
    for (int64_t q0 = threadIdx.x; q0 < n4; q0 += kThreads * kCopyUnroll) {
      float4 v[kCopyUnroll];
#pragma unroll
      for (int k = 0; k < kCopyUnroll; ++k) {
        const int64_t q = q0 + k * kThreads;
        if (q < n4) v[k] = __ldcs(xs + q);
      }
#pragma unroll
      for (int k = 0; k < kCopyUnroll; ++k) {
        const int64_t q = q0 + k * kThreads;
        if (q < n4) __stcs(ys + q, v[k]);
      }
    }
  } else {
    // the copy's loop with s1's float4s loaded (cached) beside x's
    const float4* xs = reinterpret_cast<const float4*>(xb);
    const float4* ss = reinterpret_cast<const float4*>(s1);
    float4* ys = reinterpret_cast<float4*>(yb);
    const int64_t n4 = ((int64_t)tb << log2d) >> 2;
    const int dmask4 = (D >> 2) - 1;
    for (int64_t q0 = threadIdx.x; q0 < n4; q0 += kThreads * kCopyUnroll) {
      float4 v[kCopyUnroll], s[kCopyUnroll];
#pragma unroll
      for (int k = 0; k < kCopyUnroll; ++k) {
        const int64_t q = q0 + k * kThreads;
        if (q < n4) v[k] = __ldcs(xs + q);
      }
#pragma unroll
      for (int k = 0; k < kCopyUnroll; ++k) {
        const int64_t q = q0 + k * kThreads;
        if (q < n4) s[k] = __ldg(ss + (q & dmask4));
      }
#pragma unroll
      for (int k = 0; k < kCopyUnroll; ++k) {
        const int64_t q = q0 + k * kThreads;
        if (q < n4)
          __stcs(ys + q, make_float4(__fmul_rn(v[k].x, s[k].x), __fmul_rn(v[k].y, s[k].y),
                                     __fmul_rn(v[k].z, s[k].z), __fmul_rn(v[k].w, s[k].w)));
      }
    }
  }
}

template <int kStage>
cudaError_t launch(const float* x, const float* s1, float* y, int64_t B, int log2d, int tb,
                   cudaStream_t stream) {
  kron_kernel<kStage><<<(unsigned)(B / tb), kThreads, 0, stream>>>(x, s1, y, log2d, tb);
  return cudaGetLastError();
}

// ------------------------------------------------------------ row kernels
//
// kron_swap_kernel and kron_cur_kernel compute the whole product on x
// (B, 2^L), L >= 7, a row block of S::kRows rows at a time (one row from
// D = 4096), row blocks b, b + grid, ... in block b. u and s1 are loaded
// where they are used, a float4 (or one float) at a time, so that a thread
// holds its share of the row and little of a diagonal.

// Design switch, one line, so that bench/kron_variants.py can time the row
// kernels without it: the TMA prefetch of the next row block's x into a
// stage in shared memory.
constexpr bool kRowPrefetch = true;
constexpr uint32_t kStageChunkBytes = 16 * 1024;  // a bulk load of the prefetch
constexpr int kLaneLog2 = 7;                      // stages [0, 7) are H_128

// v *= the diagonal d in the I/O window (d at the thread's first float4
// of the row), one product __fmul_rn, one float4 of d loaded at a time
template <int R, int kTpr>
__device__ __forceinline__ void scale_io(float (&v)[R], const float* __restrict__ d) {
#pragma unroll
  for (int g = 0; g < R / 4; ++g) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(d + 4 * g * kTpr));
    v[4 * g] = __fmul_rn(v[4 * g], q.x);
    v[4 * g + 1] = __fmul_rn(v[4 * g + 1], q.y);
    v[4 * g + 2] = __fmul_rn(v[4 * g + 2], q.z);
    v[4 * g + 3] = __fmul_rn(v[4 * g + 3], q.w);
  }
}

// Shared memory of a row kernel: two exchange buffers (kExchange), then
// (kRowPrefetch) the stage of one row block and its mbarrier.
template <int L, bool kExchange>
constexpr size_t row_smem_bytes() {
  using S = whvi::RowShape<L>;
  return (kExchange ? 2 * (size_t)S::kBufBytes : 0) +
         (kRowPrefetch ? S::kBufBytes + sizeof(uint64_t) : 0);
}

// The row blocks of x into the registers of the I/O window: from global
// memory, or (kPrefetch) from a stage in shared memory that thread 0 has
// the TMA unit fill with the block's next row block while the block works
// on this one. The stage's mbarrier completes a phase a row block.
template <int L, bool kPrefetch>
struct RowBlocks {
  using S = whvi::RowShape<L>;
  const float* x;
  int64_t B;
  int64_t n;    // row blocks
  char* stage;  // S::kBufBytes, then the mbarrier
  uint32_t parity = 0;

  __device__ RowBlocks(const float* x_, int64_t B_, char* stage_)
      : x(x_), B(B_), n((B_ + S::kRows - 1) / S::kRows), stage(stage_) {}

  __device__ __forceinline__ uint64_t* full() const {
    return reinterpret_cast<uint64_t*>(stage + S::kBufBytes);
  }

  // one thread: the rows of row block rb into the stage, counted on full
  __device__ __forceinline__ void fetch(int64_t rb) const {
    const int64_t row0 = rb * S::kRows;
    const int64_t rows = B - row0 < S::kRows ? B - row0 : S::kRows;
    const uint32_t bytes = (uint32_t)(rows << L) * (uint32_t)sizeof(float);
    const char* src = reinterpret_cast<const char*>(x + (row0 << L));
    tma::arrive_expect_tx(full(), bytes);
    for (uint32_t off = 0; off < bytes; off += kStageChunkBytes)
      tma::bulk_load(stage + off, src + off,
                     bytes - off < kStageChunkBytes ? bytes - off : kStageChunkBytes, full());
  }

  // every thread, before the first row block
  __device__ __forceinline__ void start() const {
    if constexpr (kPrefetch) {
      if (threadIdx.x == 0) {
        tma::barrier_init(full(), 1);
        tma::fence_barrier_init();
        if (blockIdx.x < n) fetch(blockIdx.x);
      }
      __syncthreads();
    }
  }

  // every thread: v = its share of row r of row block rb, from its first
  // float4 col (nothing loaded unless active: the row exists)
  __device__ __forceinline__ void load(float (&v)[S::R], int64_t rb, int r, int col,
                                       bool active) {
    if constexpr (kPrefetch) {
      tma::wait_parity(full(), parity);
      parity ^= 1;
      if (active)
        whvi::load_regs<S::R, S::kTpr>(v, reinterpret_cast<const float*>(stage) + (r << L) + col);
      __syncthreads();  // the stage is read: the next row block may land in it
      if (threadIdx.x == 0 && rb + gridDim.x < n) fetch(rb + gridDim.x);
    } else {
      if (active) whvi::load_regs<S::R, S::kTpr>(v, x + ((rb * S::kRows + r) << L) + col);
    }
  }
};

// ------------------------------------------------------------ swap layout

template <int L>
__global__ void __launch_bounds__(whvi::RowShape<L>::kBlock, whvi::RowShape<L>::kMinBlocks)
    kron_swap_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                     const float* __restrict__ u, const float* __restrict__ s2,
                     float* __restrict__ y, int64_t B) {
  using S = whvi::RowShape<L>;
  constexpr int kIo = whvi::kSplit;
  extern __shared__ __align__(128) char row_smem[];
  const int tid = threadIdx.x;
  const int r = tid / S::kTpr;          // the thread's row in a row block
  const int col = (tid % S::kTpr) * 4;  // its first float4 of the row
  whvi::RowExchange<L> ex{row_smem, tid};
  RowBlocks<L, kRowPrefetch> xs(x, B, row_smem + 2 * S::kBufBytes);
  xs.start();

  for (int64_t rb = blockIdx.x; rb < xs.n; rb += gridDim.x) {
    const int64_t row = rb * S::kRows + r;
    const bool active = row < B;
    float v[S::R];
#pragma unroll
    for (int j = 0; j < S::R; ++j) v[j] = 0.f;
    // 1. x and s2 in the I/O window, their product rounded
    xs.load(v, rb, r, col, active);
    if (active) scale_io<S::R, S::kTpr>(v, s2 + col);
    whvi::round_bf16(v);
    // 2. H_128, stages 0..6 up; round
    whvi::butterflies<L, kIo, 0, kLaneLog2, 1>(v, ex);
    constexpr int w1 = S::after(kIo, 0, kLaneLog2, 1);
    whvi::round_bf16(v);
    // 3. H_a, stages 7..L-1 up; x u; round
    whvi::butterflies<L, w1, kLaneLog2, L, 1>(v, ex);
    whvi::to_io_window<L, S::after(w1, kLaneLog2, L, 1)>(v, ex);
    if (active) scale_io<S::R, S::kTpr>(v, u + col);
    whvi::round_bf16(v);
    // 4. H_a, stages L-1..7 down; round
    whvi::butterflies<L, kIo, L - 1, kLaneLog2 - 1, -1>(v, ex);
    constexpr int w2 = S::after(kIo, L - 1, kLaneLog2 - 1, -1);
    whvi::round_bf16(v);
    // 5. H_128, stages 6..0 down; x s1; store
    whvi::butterflies<L, w2, kLaneLog2 - 1, -1, -1>(v, ex);
    whvi::to_io_window<L, S::after(w2, kLaneLog2 - 1, -1, -1)>(v, ex);
    if (active) {
      scale_io<S::R, S::kTpr>(v, s1 + col);
      whvi::store_regs<S::R, S::kTpr>(y + (row << L) + col, v);
    }
  }
}

// ------------------------------------------------------------- cur layout

// Where kron_cur_kernel<L> contracts each index bit. The I/O window's
// thread bits 0, 1, .. are index bits 2, 3, ..: H_128's stages 2 ..
// kLanes + 1 run on lane bits 0 .. kLanes - 1, its others (0, 1, and
// kLanes + 2 .. 6 below D = 512) in registers. H_a's stages kIoHa .. L - 1
// run in the I/O window's registers, and 7 .. kIoHa - 1, whose bits lie on
// warps (kExchange: from D = 1024), in window kW, the contiguous window from
// bit 7 (kTop below it).
template <int L>
struct CurShape {
  using S = whvi::RowShape<L>;
  static constexpr int kLanes = S::kTop < 5 ? S::kTop : 5;
  static constexpr int kIoHa = S::kTop + 2 > kLaneLog2 ? S::kTop + 2 : kLaneLog2;
  static constexpr bool kExchange = kIoHa > kLaneLog2;
  static constexpr int kW = S::window_for(kLaneLog2, true);
  static_assert(!kExchange || (kW <= kLaneLog2 && kIoHa <= kW + S::kLog2R),
                "window kW holds every stage whose bit lies on a warp");
};

// Radix-2 stages kS, kS + kStep, .. (kEnd excluded) in registers, stage s
// on register bit s - kBase.
template <int kBase, int kS, int kEnd, int kStep, int R>
__device__ __forceinline__ void reg_stages(float (&v)[R]) {
  if constexpr (kS != kEnd) {
    whvi::butterfly<kS - kBase>(v);
    reg_stages<kBase, kS + kStep, kEnd, kStep>(v);
  }
}

// The radix-2 stage on lane bit k: lanes l and l ^ 2^k hold the pair's
// two elements in each register. The lane with the bit clear keeps a + b,
// the other a - b, as the plain stage; one FFMA each, b * -1 being exact.
template <int k, int R>
__device__ __forceinline__ void lane_butterfly(float (&v)[R]) {
  const float sign = (threadIdx.x >> k) & 1 ? -1.f : 1.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float o = __shfl_xor_sync(0xffffffffu, v[j], 1 << k);
    v[j] = __fmaf_rn(sign, v[j], o);
  }
}

// Lane stages on lane bits kK, kK + kStep, .. (kEnd excluded)
template <int kK, int kEnd, int kStep, int R>
__device__ __forceinline__ void lane_stages(float (&v)[R]) {
  if constexpr (kK != kEnd) {
    lane_butterfly<kK>(v);
    lane_stages<kK + kStep, kEnd, kStep>(v);
  }
}

// H_128 (stages 0-6) on the I/O window, in the plain order upwards (kUp)
// or downwards
template <int L, bool kUp>
__device__ __forceinline__ void h128(float (&v)[whvi::RowShape<L>::R]) {
  using S = whvi::RowShape<L>;
  constexpr int kLanes = CurShape<L>::kLanes;
  if constexpr (kUp) {
    whvi::butterfly<0>(v);
    whvi::butterfly<1>(v);
    lane_stages<0, kLanes, 1>(v);
    reg_stages<S::kTop, kLanes + 2, kLaneLog2, 1>(v);
  } else {
    reg_stages<S::kTop, kLaneLog2 - 1, kLanes + 1, -1>(v);
    lane_stages<kLanes - 1, -1, -1>(v);
    whvi::butterfly<1>(v);
    whvi::butterfly<0>(v);
  }
}

// v *= the diagonal d at the elements that window kW holds: one float of
// d a register, a warp's 32 consecutive (thread bits 0-4 are index bits
// 0-4 in a contiguous window from bit 5 up).
template <int L, int kW>
__device__ __forceinline__ void scale_window(float (&v)[whvi::RowShape<L>::R],
                                             const float* __restrict__ d,
                                             const whvi::RowExchange<L>& ex) {
  const float* p = d + (ex.template lane_index<kW>() & ((1 << L) - 1));
#pragma unroll
  for (int j = 0; j < whvi::RowShape<L>::R; ++j) v[j] = __fmul_rn(v[j], __ldg(p + (j << kW)));
}

template <int L>
__global__ void __launch_bounds__(whvi::RowShape<L>::kBlock, whvi::RowShape<L>::kMinBlocks)
    kron_cur_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                    const float* __restrict__ u, const float* __restrict__ s2,
                    float* __restrict__ y, int64_t B) {
  using S = whvi::RowShape<L>;
  using C = CurShape<L>;
  extern __shared__ __align__(128) char row_smem[];
  const int tid = threadIdx.x;
  const int r = tid / S::kTpr;          // the thread's row in a row block
  const int col = (tid % S::kTpr) * 4;  // its first float4 of the row
  whvi::RowExchange<L> ex{row_smem, tid};
  RowBlocks<L, kRowPrefetch> xs(x, B, row_smem + (C::kExchange ? 2 * S::kBufBytes : 0));
  xs.start();

  for (int64_t rb = blockIdx.x; rb < xs.n; rb += gridDim.x) {
    const int64_t row = rb * S::kRows + r;
    const bool active = row < B;
    float v[S::R];
#pragma unroll
    for (int j = 0; j < S::R; ++j) v[j] = 0.f;
    // 1. x and s2 in the I/O window, their product rounded
    xs.load(v, rb, r, col, active);
    if (active) scale_io<S::R, S::kTpr>(v, s2 + col);
    whvi::round_bf16(v);
    // 2. H_128 up, its lane stages by shuffles; round
    h128<L, true>(v);
    whvi::round_bf16(v);
    // 3. H_a up: the I/O window's register bits, then the warps' bits in
    // window kW; x u where the row is; round
    reg_stages<S::kTop, C::kIoHa, L, 1>(v);
    if constexpr (C::kExchange) {
      ex.template move<whvi::kSplit, C::kW>(v);
      reg_stages<C::kW, kLaneLog2, C::kIoHa, 1>(v);
      if (active) scale_window<L, C::kW>(v, u, ex);
    } else {
      if (active) scale_io<S::R, S::kTpr>(v, u + col);
    }
    whvi::round_bf16(v);
    // 4. H_a down, in reverse; round
    if constexpr (C::kExchange) {
      reg_stages<C::kW, C::kIoHa - 1, kLaneLog2 - 1, -1>(v);
      ex.template move<C::kW, whvi::kSplit>(v);
    }
    reg_stages<S::kTop, L - 1, C::kIoHa - 1, -1>(v);
    whvi::round_bf16(v);
    // 5. H_128 down; x s1; store
    h128<L, false>(v);
    if (active) {
      scale_io<S::R, S::kTpr>(v, s1 + col);
      whvi::store_regs<S::R, S::kTpr>(y + (row << L) + col, v);
    }
  }
}

// ------------------------------------------------------------ launches

// kernel<<<min(blocks an SM x SMs, n_blocks), block, smem>>>(args...): a
// persistent grid
template <typename... P, typename... A>
cudaError_t launch_persistent(void (*kernel)(P...), int block, size_t smem, int64_t n_blocks,
                              cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t grid = (int64_t)per_sm * sms;
  kernel<<<(unsigned)(n_blocks < grid ? n_blocks : grid), block, smem, stream>>>(args...);
  return cudaGetLastError();
}

// A row kernel at L = log2 D on its persistent grid: kron_cur_kernel if
// kCurKernel, else kron_swap_kernel.
template <bool kCurKernel>
struct RowLaunch {
  const float *x, *s1, *u, *s2;
  float* y;
  int64_t B;
  cudaStream_t stream;

  template <int L>
  cudaError_t operator()() const {
    if constexpr (L < kMinLog2D) {
      return cudaErrorInvalidValue;
    } else {
      using S = whvi::RowShape<L>;
      constexpr bool kExchange = !kCurKernel || CurShape<L>::kExchange;
      return launch_persistent(kCurKernel ? kron_cur_kernel<L> : kron_swap_kernel<L>, S::kBlock,
                               row_smem_bytes<L, kExchange>(), (B + S::kRows - 1) / S::kRows,
                               stream, x, s1, u, s2, y, B);
    }
  }
};

}  // namespace kron

// x, y contiguous (B, D = 2^log2d) fp32 on 16-byte boundaries; s1, u, s2
// (D,) fp32, likewise aligned where the stage reads them (the copy stage
// reads none, the scale stage s1, full all three).
// stage: 0 copy, 1 scale, 4 full; layout: 0 cur, 1 swap, 2 flat, 3
// onecast (copy and scale take the flat layout only, the full product
// every layout but flat). The tensor-core stages, mm1 (2), mm2 (3) and the
// full product in the flat layout, are kron_full_f32's (whvi_full.cu):
// refused here. Returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue, nothing launched, for a stage or layout it does
// not run or an operand it reads off a 16-byte boundary).
extern "C" int kron_stage_f32(const void* x, const void* s1, const void* u,
                              const void* s2, void* y, int64_t B, int log2d,
                              int tb, int stage, int layout, void* stream) {
  using namespace kron;
  auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const bool reads_s1 = stage == kScale || stage == kFull;
  if (!valid_tiling(B, log2d, tb) || off16(x) || off16(y) || (reads_s1 && off16(s1)) ||
      (stage == kFull && (off16(u) || off16(s2))))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const auto* fx = static_cast<const float*>(x);
  const auto* fs1 = static_cast<const float*>(s1);
  const auto* fu = static_cast<const float*>(u);
  const auto* fs2 = static_cast<const float*>(s2);
  auto* fy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (layout == kFlat) {
    switch (stage) {
      case kCopy: return (int)launch<kCopy>(fx, fs1, fy, B, log2d, tb, st);
      case kScale: return (int)launch<kScale>(fx, fs1, fy, B, log2d, tb, st);
    }
  } else if (stage == kFull && layout == kSwap) {
    return (int)whvi::dispatch_log2d(log2d, RowLaunch<false>{fx, fs1, fu, fs2, fy, B, st});
  } else if (stage == kFull && (layout == kCur || layout == kOneCast)) {
    // k_onecast's body computes k_cur's bit for bit: one kernel serves both
    return (int)whvi::dispatch_log2d(log2d, RowLaunch<true>{fx, fs1, fu, fs2, fy, B, st});
  }
  return (int)cudaErrorInvalidValue;
}
