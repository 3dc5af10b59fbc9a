// The stage-by-stage and layout variants of the Kronecker-factor WHVI
// product, fp32 in and out, bf16 factor operands, fp32 accumulation.
//
// Replaces the Pallas kernel bodies of the TPU diagnosis harnesses:
//   benchmarks/pallas_diag.py  k_copy, k_scale, k_mm1, k_mm2, k_full
//                              (stage = copy .. full, flat layout);
//   benchmarks/pallas_tune.py  k_cur, k_swap, k_flat, k_onecast
//                              (stage = full, layout = cur/swap/flat/onecast).
// kron_kernel, templated on the stage and the layout, runs all but k_swap,
// as the bodies are one product built up a stage at a time (kron_core.cuh
// says what is rounded where); k_swap has a kernel of its own,
// kron_swap_kernel, on the register rows of fwht_core.cuh.
//
// Tiling, as the TPU grid: block b owns rows [b*tb, (b+1)*tb) of x
// (B, D); the caller picks tb and B % tb must be 0. A block walks its
// rows a group of 16384 / D rows at a time (kron_core.cuh).
// kron_swap_kernel only checks tb: its grid is persistent (below).
//
// Layouts:
//   flat     the group's 128 lane-rows are the rows of the tensor-core
//            products (mma.sync m16n8k16, bf16 in, fp32 accumulate):
//            (128, 128) @ H_128, and H_a @ (a, 128) per row. Two bf16
//            buffers, 68 KB of shared memory.
//   cur      CUDA cores. The row stays in place in fp32 shared memory
//            (64 KB a group); H_128 is radix-2 stages 0-6 of the row
//            (within each 128-run), H_a is stages 7.. (the strided middle
//            axis). H is +-1, so a contraction is sign flips and adds;
//            the butterfly does them in 7 stages instead of 128 terms. The
//            scale and the bf16 cast are separate passes, as the multiply
//            and _dotg's astype are in k_cur.
//   onecast  cur with each scaled activation cast to bf16 in the pass that
//            scales it (k_onecast's single cast).
//   swap     CUDA cores, the row in registers. The TPU body swaps the
//            axes so that every contraction runs over the last axis. Here
//            a contraction runs over the index bits that a thread holds in
//            registers, and the swap is an exchange of the row between
//            register windows through XOR-swizzled shared memory
//            (fwht_core.cuh: a row of D floats over D / R threads, R = 16,
//            or 32 from D = 8192). The body's rounding order: R(s2 x),
//            H_128 (stages 0-6), R, H_a (stages 7..L-1), x u, R, H_a
//            (stages L-1..7), R, H_128 (stages 6..0), x s1. Every rounding
//            is of registers: no pass over shared memory, no barrier. From
//            D = 2048 this is K1's bf16 schedule (whvi_fused.cu); below
//            it K1 contracts one factor and k_swap two, so it does not
//            launch K1.
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
// cores, so the flat layout is memory-bound once its tensor-core work runs
// near peak. This first version builds every fragment with scalar shared
// loads and generates H from popcount, so it is compute-bound; cur and
// onecast are compute-bound by their shared-memory passes, and small tb
// leaves SMs idle (B / tb blocks). The swap kernel's butterflies cost
// 2 log2 D adds an element, but its 6 exchanges a row at D = 16384 move
// 6 x 2 x 64 KB through shared memory against the row's 128 KB of HBM, so
// it runs HBM and shared memory in turn. Its design does two things
// about that: a persistent grid (as many blocks as fit on the SMs, each
// walking row blocks b, b + grid, ...), so that its time no longer
// depends on tb; and, while a row block is transformed, one thread has the
// next row block's x loaded into a stage in shared memory by a TMA bulk
// copy (kSwapPrefetch), so the row's HBM load overlaps the previous row's
// exchanges. On the H100 at D = 16384 that is worth 4-6%
// (bench/kron_variants.py times it without): one 512-thread block an SM
// holds the row, so the SM still runs the row's exchanges and the HBM
// traffic in turn; at D = 8192, two blocks an SM, they overlap (PERF.md).
//
// Left for later: ldmatrix and wgmma for the flat layout, warp shuffles
// for cur's strided stages, and bulk stores of y.
#include "fwht_core.cuh"
#include "kron_core.cuh"
#include "tma.cuh"

namespace kron {

enum Layout { kCur = 0, kSwap = 1, kFlat = 2, kOneCast = 3 };

// Radix-2 stages s in [s_lo, s_hi) of the Hadamard transform of length
// 2^log2n over nvec vectors laid at buf + v * pitch. Ends in a barrier.
__device__ __forceinline__ void butterfly_stages(float* buf, int nvec,
                                                 int log2n, int pitch,
                                                 int s_lo, int s_hi) {
  if (s_lo >= s_hi) return;
  const int half_log2 = log2n - 1;
  const int half = 1 << half_log2;
  const int total = nvec * half;
  for (int s = s_lo; s < s_hi; ++s) {
    const int h = 1 << s;
    for (int p = threadIdx.x; p < total; p += kThreads) {
      const int v = p >> half_log2, q = p & (half - 1);
      float* row = buf + (size_t)v * pitch;
      const int i0 = ((q >> s) << (s + 1)) | (q & (h - 1));
      const float x0 = row[i0], x1 = row[i0 + h];
      row[i0] = x0 + x1;
      row[i0 + h] = x0 - x1;
    }
    __syncthreads();
  }
}

// buf[e] = f(buf[e], e) for e < n; ends in a barrier
template <class F>
__device__ __forceinline__ void pass(float* buf, int n, F f) {
  for (int e = threadIdx.x; e < n; e += kThreads) buf[e] = f(buf[e], e);
  __syncthreads();
}

// y = buf * s1 over the group's nr rows, 16 bytes a thread
__device__ __forceinline__ void store_scaled(const float* buf, float* y,
                                             const float* __restrict__ s1,
                                             int n, int dmask) {
  for (int q = threadIdx.x; q < (n >> 2); q += kThreads) {
    const float4 v = reinterpret_cast<const float4*>(buf)[q];
    const float4 s = __ldg(reinterpret_cast<const float4*>(s1 + ((q << 2) & dmask)));
    reinterpret_cast<float4*>(y)[q] =
        make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
  }
}

// buf = x * s2 (rounded to bf16 when kRound) over the group, fp32
template <bool kRound>
__device__ __forceinline__ void load_scaled(float* buf, const float* x,
                                            const float* __restrict__ s2,
                                            int n, int dmask) {
  for (int q = threadIdx.x; q < (n >> 2); q += kThreads) {
    const float4 v = reinterpret_cast<const float4*>(x)[q];
    const float4 s = __ldg(reinterpret_cast<const float4*>(s2 + ((q << 2) & dmask)));
    float4 w = make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
    if (kRound) {
      w = make_float4(round_bf16(w.x), round_bf16(w.y), round_bf16(w.z),
                      round_bf16(w.w));
    }
    reinterpret_cast<float4*>(buf)[q] = w;
  }
  __syncthreads();
}

template <bool kOneCastPass>
__device__ __forceinline__ void cur_group(float* buf, const float* x, float* y,
                                          int nr, int log2d,
                                          const float* __restrict__ s1,
                                          const float* __restrict__ u,
                                          const float* __restrict__ s2) {
  const int D = 1 << log2d, n = nr << log2d, dmask = D - 1;
  auto cast = [](float v, int) { return round_bf16(v); };
  load_scaled<kOneCastPass>(buf, x, s2, n, dmask);
  if (!kOneCastPass) pass(buf, n, cast);
  butterfly_stages(buf, nr, log2d, D, 0, 7);  // H_128 on the last axis
  pass(buf, n, cast);
  butterfly_stages(buf, nr, log2d, D, 7, log2d);  // H_a on the middle axis
  if (kOneCastPass) {
    pass(buf, n, [&](float v, int e) { return round_bf16(v * __ldg(u + (e & dmask))); });
  } else {
    pass(buf, n, [&](float v, int e) { return v * __ldg(u + (e & dmask)); });
    pass(buf, n, cast);
  }
  butterfly_stages(buf, nr, log2d, D, 7, log2d);
  pass(buf, n, cast);
  butterfly_stages(buf, nr, log2d, D, 0, 7);
  store_scaled(buf, y, s1, n, dmask);
}

constexpr int kCopyUnroll = 8;  // 16-byte loads in flight a thread

template <int kStage, int kLayout>
__global__ void __launch_bounds__(kThreads)
    kron_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                const float* __restrict__ u, const float* __restrict__ s2,
                float* __restrict__ y, int log2d, int tb) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  } else if constexpr (kStage == kScale) {
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
  } else {
    const int rows = kGroupElems >> log2d;
    for (int g0 = 0; g0 < tb; g0 += rows) {
      const int nr = min(rows, tb - g0);
      const float* xg = xb + (int64_t)g0 * D;
      float* yg = yb + (int64_t)g0 * D;
      if constexpr (kLayout == kFlat) {
        bf16* bufA = reinterpret_cast<bf16*>(smem);
        load_scaled_bf16(xg, s2, bufA, nr, log2d);
        flat_group<kStage>(bufA, bufA + kGroupRows * kPitch, yg, nr, log2d, s1, u);
      } else {
        cur_group<kLayout == kOneCast>(reinterpret_cast<float*>(smem), xg, yg,
                                       nr, log2d, s1, u, s2);
      }
      __syncthreads();  // the next group overwrites the buffers
    }
  }
}

size_t smem_bytes(int stage, int layout) {
  if (stage == kCopy || stage == kScale) return 0;
  if (layout == kFlat) return kFlatSmem;
  return (size_t)kGroupElems * sizeof(float);
}

template <int kStage, int kLayout>
cudaError_t launch(const float* x, const float* s1, const float* u,
                   const float* s2, float* y, int64_t B, int log2d, int tb,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(kStage, kLayout);
  auto kernel = kron_kernel<kStage, kLayout>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)(B / tb), kThreads, smem, stream>>>(x, s1, u, s2, y,
                                                         log2d, tb);
  return cudaGetLastError();
}

// ------------------------------------------------------------ swap layout

// Whether kron_swap_kernel prefetches the next row block's x by TMA (one
// line, so that bench/kron_variants.py can time the kernel without it).
constexpr bool kSwapPrefetch = true;
constexpr uint32_t kSwapChunkBytes = 16 * 1024;  // a bulk load of the prefetch
constexpr int kLaneLog2 = 7;                     // stages [0, 7) are H_128

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

// Shared memory of kron_swap_kernel<L>: the two exchange buffers, then
// (with the prefetch) the stage of one row block and its mbarrier.
template <int L>
constexpr size_t swap_smem_bytes() {
  using S = whvi::RowShape<L>;
  return 3 * (size_t)S::kBufBytes - (kSwapPrefetch ? 0 : S::kBufBytes) +
         (kSwapPrefetch ? sizeof(uint64_t) : 0);
}

// The whole product on x (B, 2^L), L >= 7, a row block of S::kRows rows
// at a time (one row from D = 4096), row blocks b, b + grid, ... in block
// b. u and s1 are loaded where they are used, a float4 at a time, so that
// a thread holds its share of the row and one float4 of a diagonal.
template <int L>
__global__ void __launch_bounds__(whvi::RowShape<L>::kBlock, whvi::RowShape<L>::kMinBlocks)
    kron_swap_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                     const float* __restrict__ u, const float* __restrict__ s2,
                     float* __restrict__ y, int64_t B) {
  using S = whvi::RowShape<L>;
  constexpr int kIo = whvi::kSplit;
  // named apart from kron_kernel's smem: one extern array, one type
  extern __shared__ __align__(128) char swap_smem[];
  const int tid = threadIdx.x;
  const int r = tid / S::kTpr;          // the thread's row in a row block
  const int col = (tid % S::kTpr) * 4;  // its first float4 of the row
  const int64_t n_blocks = (B + S::kRows - 1) / S::kRows;
  whvi::RowExchange<L> ex{swap_smem, tid};
  char* stage = swap_smem + 2 * S::kBufBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + S::kBufBytes);

  // one thread: the rows of row block rb into the stage, counted on full
  auto prefetch = [&](int64_t rb) {
    const int64_t row0 = rb * S::kRows;
    const int64_t rows = B - row0 < S::kRows ? B - row0 : S::kRows;
    const uint32_t bytes = (uint32_t)(rows << L) * (uint32_t)sizeof(float);
    const char* src = reinterpret_cast<const char*>(x + (row0 << L));
    tma::arrive_expect_tx(full, bytes);
    for (uint32_t off = 0; off < bytes; off += kSwapChunkBytes)
      tma::bulk_load(stage + off, src + off,
                     bytes - off < kSwapChunkBytes ? bytes - off : kSwapChunkBytes, full);
  };
  if constexpr (kSwapPrefetch) {
    if (tid == 0) {
      tma::barrier_init(full, 1);
      tma::fence_barrier_init();
      if (blockIdx.x < n_blocks) prefetch(blockIdx.x);
    }
    __syncthreads();
  }

  uint32_t parity = 0;
  for (int64_t rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const int64_t row = rb * S::kRows + r;
    const bool active = row < B;
    const int64_t at = (row << L) + col;
    float v[S::R];
#pragma unroll
    for (int j = 0; j < S::R; ++j) v[j] = 0.f;
    // 1. x and s2 in the I/O window, their product rounded
    if constexpr (kSwapPrefetch) {
      tma::wait_parity(full, parity);
      parity ^= 1;
      if (active)
        whvi::load_regs<S::R, S::kTpr>(v, reinterpret_cast<const float*>(stage) + (r << L) + col);
      __syncthreads();  // the stage is read: the next row block may land in it
      if (tid == 0 && rb + gridDim.x < n_blocks) prefetch(rb + gridDim.x);
    } else {
      if (active) whvi::load_regs<S::R, S::kTpr>(v, x + at);
    }
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
      whvi::store_regs<S::R, S::kTpr>(y + at, v);
    }
  }
}

// kron_swap_kernel<L> on a persistent grid: as many blocks as fit on the
// SMs, at most one a row block.
struct SwapLaunch {
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
      const auto kernel = kron_swap_kernel<L>;
      constexpr size_t smem = swap_smem_bytes<L>();
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      int device = 0, sms = 0, per_sm = 0;
      if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S::kBlock, smem);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      const int64_t n_blocks = (B + S::kRows - 1) / S::kRows;
      const int64_t grid = (int64_t)per_sm * sms;
      kernel<<<(unsigned)(n_blocks < grid ? n_blocks : grid), S::kBlock, smem, stream>>>(
          x, s1, u, s2, y, B);
      return cudaGetLastError();
    }
  }
};

}  // namespace kron

// x, y contiguous (B, D = 2^log2d) fp32 on 16-byte boundaries; s1, u, s2
// (D,) fp32, likewise aligned where the stage reads them (the copy stage
// reads none, the scale stage s1, mm1 and mm2 s2, full all three).
// stage: 0 copy, 1 scale, 2 mm1, 3 mm2, 4 full; layout: 0 cur, 1 swap,
// 2 flat, 3 onecast (the stages below full take the flat layout only).
// Returns the launch's cudaError_t (0 on success; cudaErrorInvalidValue,
// nothing launched, for an operand it reads off a 16-byte boundary).
extern "C" int kron_stage_f32(const void* x, const void* s1, const void* u,
                              const void* s2, void* y, int64_t B, int log2d,
                              int tb, int stage, int layout, void* stream) {
  using namespace kron;
  auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const bool reads_s1 = stage == kScale || stage == kFull;
  const bool reads_s2 = stage == kMm1 || stage == kMm2 || stage == kFull;
  if (!valid_tiling(B, log2d, tb) || off16(x) || off16(y) || (reads_s1 && off16(s1)) ||
      (stage == kFull && off16(u)) || (reads_s2 && off16(s2)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const auto* fx = static_cast<const float*>(x);
  const auto* fs1 = static_cast<const float*>(s1);
  const auto* fu = static_cast<const float*>(u);
  const auto* fs2 = static_cast<const float*>(s2);
  auto* fy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
#define KRON_LAUNCH(S, L) \
  (int)launch<S, L>(fx, fs1, fu, fs2, fy, B, log2d, tb, st)
  if (layout == kFlat) {
    switch (stage) {
      case kCopy: return KRON_LAUNCH(kCopy, kFlat);
      case kScale: return KRON_LAUNCH(kScale, kFlat);
      case kMm1: return KRON_LAUNCH(kMm1, kFlat);
      case kMm2: return KRON_LAUNCH(kMm2, kFlat);
      case kFull: return KRON_LAUNCH(kFull, kFlat);
    }
  } else if (stage == kFull) {
    switch (layout) {
      case kCur: return KRON_LAUNCH(kFull, kCur);
      case kSwap: return (int)whvi::dispatch_log2d(log2d, SwapLaunch{fx, fs1, fu, fs2, fy, B, st});
      case kOneCast: return KRON_LAUNCH(kFull, kOneCast);
    }
  }
#undef KRON_LAUNCH
  return (int)cudaErrorInvalidValue;
}
