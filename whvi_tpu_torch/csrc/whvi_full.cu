// The whole Kronecker-factor WHVI product y = s1 * H(u * H(s2 * x)) on the
// tensor cores, fp32 in and out, bf16 factor operands, fp32 accumulation:
// one persistent kernel of two warpgroups whose four factor contractions a
// group are wgmma products on H tiles resident in shared memory.
//
// Replaces three TPU bodies that compute one function statement for
// statement, so all three wrappers launch this kernel:
//   benchmarks/pallas_diag.py  k_full (:98), and make_emit_full's inner
//                              (:130), k_full's body under a manual
//                              emit_pipeline;
//   benchmarks/pallas_tune.py  k_flat (:69), k_full again.
//
// The group (kron_core.cuh). x (B, D) is contiguous, so group g, 16384 /
// D rows, is the contiguous span [g * 16384, (g + 1) * 16384) of x: a
// 128 x 128 tile T whose lane-row m = r * a + i holds row r's elements
// [i * 128, (i + 1) * 128), a = D / 128. In the tile's terms the TPU body
// is four 128 x 128 x 128 products, at every D:
//   T1 = R(s2 * T) @ H_128                 (right)
//   T2 = G @ R(T1)                         (left)
//   T3 = G @ R(T2 * u)                     (left)
//   y  = (R(T3) @ H_128) * s1              (right)
// with G = I_{128/a} (x) H_a, block-diagonal: one a x a block H_a a row,
// every a from 1 to 128 in one matrix. Its zeros add exactly 0 to an fp32
// sum, so the rounding is the body's (R rounds to bf16; the diagonals'
// index of lane-row m, column k is (m & (a - 1)) * 128 + k). From a <= 64
// the 64 rows of one wgmma meet only G's diagonal 64 x 64 blocks, and the
// zero blocks are skipped: half the left products' work.
//
// Layout. Every bf16 tile in shared memory (H_128, G, the group's
// operand) is two 64-column halves of 128 rows of 128 bytes, each row's
// 16-byte groups XOR-swizzled by row & 7 (tile_offset; wgmma.cuh). A
// right product reads the operand K-major as A and H_128 K-major as B; a
// left product reads G K-major as A and the operand MN-major as B (the
// transpose flag), so one layout serves all four, and every epilogue
// writes its rounded result back into the operand in place.
//
// Roles. A block of two warpgroups, one block an SM, works on the groups
// b, b + grid, .. (grid = as many as there are groups, up to the SMs), one
// at a time: warpgroup h owns the tile's rows 64h .. 64h + 63, its
// products' output rows (one wgmma m64n128k16 a k16 step, 64 fp32
// accumulators a thread). A right product and a left product at a <= 64
// read only the warpgroup's own rows; at a = 128 a left product reads all
// 128, and the two warpgroups meet before and after it.
//
// The diagonals. Every group needs the same elements of u and s1 at the
// same accumulator, so each thread holds its 64 of each in registers for
// the whole kernel (kFullDiagRegs), loaded once instead of from L2 every
// group (3 x 64 KB a group at D = 16384); s2 is read from shared memory,
// loaded once a block. That takes 244 registers a thread: 8 warps, two a
// quarter of the SM, may have 255, where a ninth warp (a producer warp
// beside two consumer warpgroups) would cap every thread at 168.
//
// The stream. x flows through a ring of 3 slots in shared memory, each a
// warpgroup's half of a group (32 KB): once warpgroup h has formed R(s2 *
// x) of its half of group k, its thread 0 has the TMA unit load the
// half-group 3 places on into the slot (one full barrier a slot), so 1.5
// groups' loads are in flight while one is computed. The epilogues work in
// registers: the rounding (and * u after the second) written back into the
// tile in place, and after the last * s1 stored to y from registers
// (st.global.cs), or (kFullTmaStore) through the tile and TMA bulk stores.
// The row tile tb is checked, not used: the time does not depend on the
// TPU's tile.
//
// What bounds it on an H100: per group 4 x 2 x 128^3 = 16.8 MFLOP (about
// 2.2 us of an SM's share of the bf16 peak) against 128 KB of HBM (about
// 5.2 us of an SM's share of 3.35 TB/s), so it is HBM-bound once a group's
// serial chain (R(s2 * x), four products and their epilogues, the
// warpgroups' meetings, the stores) fits under its loads. It does not yet:
// about half the bound (PERF.md).
//
// Shared memory: H_128 and the operand tile (32 KB each), the ring (96
// KB), then G (32 KB) and s2 (4 D bytes, up to 32 KB) or, at D = 16384
// where G is H_128, s2 alone (64 KB); the ring's barriers: 225 KB.
#include "kron_core.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace kron {

// Design switches, one line each, so that bench/kron_variants.py can time
// the kernel without them: u and s1 held in registers for the whole
// kernel (false: loaded from L2 every group, under the product before
// their epilogue); y through shared memory and TMA bulk stores (false:
// st.global.cs from registers).
constexpr bool kFullDiagRegs = true;
constexpr bool kFullTmaStore = false;

constexpr int kFullThreads = 256;  // two warpgroups
constexpr uint32_t kTileBytes = kGroupRows * kLane * sizeof(bf16);  // 32 KB
constexpr uint32_t kHalfBytes = kTileBytes / 2;  // 64 columns
constexpr int kSlots = 3;
constexpr uint32_t kSlotElems = kGroupElems / 2;  // a warpgroup's half of a group
constexpr size_t kRingOffset = 2 * (size_t)kTileBytes;
constexpr size_t kTailOffset = kRingOffset + kSlots * kSlotElems * sizeof(float);  // G, s2
constexpr size_t kFullSmem =
    1024 + kTailOffset + kGroupElems * sizeof(float) + kSlots * sizeof(uint64_t);
static_assert(kFullSmem <= 232448, "a block's shared memory");

// Byte offset of element (m, j) of a 128 x 128 bf16 tile: column half j /
// 64, row m at 128 bytes, its 16-byte group (j / 8) % 8 stored at that
// group ^ (m % 8). The tests hold a Python copy (kron_cuda.tile_offset).
__device__ __forceinline__ uint32_t tile_offset(int m, int j) {
  return (uint32_t)((j >> 6) * kHalfBytes + m * 128 + ((((j >> 3) & 7) ^ (m & 7)) << 4) +
                    (j & 7) * 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the 128 threads of warpgroup wg meet (named barrier wg + 1)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// bf16 bits of H_128[m][j], or (left) of G[m][j] = H_a[m % a][j % a] in
// G's diagonal blocks and 0 elsewhere
__device__ __forceinline__ uint32_t factor_bits(bool left, int m, int j, int amask) {
  if (!left) return sign_bits(m, j);
  return (m ^ j) & ~amask & (kLane - 1) ? 0u : sign_bits(m & amask, j);
}

// H_128 and (a < 128) G into their tiles, by all the block's threads
__device__ __forceinline__ void build_factors(char* h128, char* g, int amask) {
  const int n = (amask == kLane - 1 ? 1 : 2) * kGroupRows * 16;
  for (int o = threadIdx.x; o < n; o += kFullThreads) {  // 8 elements each
    const bool left = o >= kGroupRows * 16;
    const int m = (o >> 4) & (kGroupRows - 1), j = (o & 15) << 3;
    uint32_t w[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      w[p] = factor_bits(left, m, j + 2 * p, amask) |
             factor_bits(left, m, j + 2 * p + 1, amask) << 16;
    *reinterpret_cast<uint4*>((left ? g : h128) + tile_offset(m, j)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The warpgroup's half of the operand tile (lane-rows 64h .. 64h + 63) =
// R(src * s2), src its fp32 in a ring slot, s2 in shared memory; float4 f
// of the half at thread f % 128 (a warp reads 512 contiguous bytes of
// each). Lane-rows at or past `rows` (past the end of x) are zero, so that
// G's zeros meet no stale NaN.
__device__ __forceinline__ void scale_half(const float* src, const float* s2, char* tile, int h,
                                           int rows, int dmask) {
  const int t = threadIdx.x & 127;
#pragma unroll 4
  for (int q = 0; q < kSlotElems / 4 / 128; ++q) {
    const int f = t + 128 * q, m = 64 * h + (f >> 5), j = (f & 31) << 2;
    const float4 v = reinterpret_cast<const float4*>(src)[f];
    const float4 a = *reinterpret_cast<const float4*>(s2 + ((m * kLane + j) & dmask));
    *reinterpret_cast<uint2*>(tile + tile_offset(m, j)) =
        m < rows ? make_uint2(pack_bf16(v.x * a.x, v.y * a.y), pack_bf16(v.z * a.z, v.w * a.w))
                 : make_uint2(0u, 0u);
  }
}

// descriptor of a K-major tile at k16 step kk, rows from 64 * mh
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int mh, int kk) {
  return wgmma::smem_desc(tile + (kk >> 2) * kHalfBytes + (kk & 3) * 32 + mh * 64 * 128, 16,
                          1024);
}

// descriptor of a tile read MN-major at k16 step kk (its rows 16kk..)
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return wgmma::smem_desc(tile + kk * 16 * 128, kHalfBytes, 1024);
}

// d = rows 64h .. 64h + 63 of a product of two tiles: kLeft false, A @
// H_128 (a the operand, b H_128); kLeft true, G @ B (a G, b the operand
// read MN-major; diag_blocks: only G's diagonal 64 x 64 blocks are
// nonzero, a <= 64, so only the operand's rows 64h .. meet them). pre()
// runs while the products do. Returns once the warp's products are done.
template <bool kLeft, class Pre>
__device__ __forceinline__ void contract(float (&d)[64], uint32_t a, uint32_t b, int h,
                                         bool diag_blocks, Pre pre) {
  wgmma::fence_operand(d);
  wgmma::fence();
  if (kLeft && diag_blocks) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::mma_m64n128k16<true>(d, k_major(a, h, 4 * h + kk), mn_major(b, 4 * h + kk), kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma::mma_m64n128k16<kLeft>(d, k_major(a, h, kk),
                                   kLeft ? mn_major(b, kk) : k_major(b, 0, kk), kk > 0);
  }
  wgmma::commit();
  pre();
  wgmma::wait<0>();
  wgmma::fence_operand(d);
}

// The thread's 32 pairs of a diagonal at its accumulators (wgmma.cuh's
// layout, rows from 64h): v[2n + r] its elements (m & amask) * 128 + k,
// k + 1 for row m = 64h + 16 (t / 32) + (t % 32) / 4 + 8r, column k = 8n +
// 2 (t % 4).
struct Diag {
  float2 v[32];

  __device__ __forceinline__ void load(const float* __restrict__ diag, int h, int amask) {
    const int t = threadIdx.x & 127;
    const int r = 64 * h + 16 * (t >> 5) + ((t & 31) >> 2), c = 2 * (t & 3);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        v[2 * n + i] =
            __ldg(reinterpret_cast<const float2*>(diag + (((r + 8 * i) & amask) << 7) + 8 * n + c));
    }
  }
};

// epi(m, k, d[m][k], d[m][k + 1], p) for each of the thread's 32 pairs p
// (Diag's order), rows from 64h
template <class Epi>
__device__ __forceinline__ void for_pairs(const float (&d)[64], int h, Epi epi) {
  const int t = threadIdx.x & 127;
  const int r = 64 * h + 16 * (t >> 5) + ((t & 31) >> 2), c = 2 * (t & 3);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      epi(r + 8 * i, 8 * n + c, d[4 * n + 2 * i], d[4 * n + 2 * i + 1], 2 * n + i);
  }
}

// R(d) (kScale: R(d * w)) back into the operand tile
template <bool kScale>
__device__ __forceinline__ void round_into(const float (&d)[64], int h, char* tile,
                                           const Diag& w) {
  for_pairs(d, h, [&](int m, int k, float v0, float v1, int p) {
    if constexpr (kScale) {
      v0 *= w.v[p].x;
      v1 *= w.v[p].y;
    }
    *reinterpret_cast<uint32_t*>(tile + tile_offset(m, k)) = pack_bf16(v0, v1);
  });
}

// y's lane-rows below `rows` (of rows 64h ..) = d (kScale: d * s1)
template <bool kScale>
__device__ __forceinline__ void store_y(const float (&d)[64], int h, float* yg, int rows,
                                        const Diag& s1, char* tile) {
  auto value = [&](float& v0, float& v1, int p) {
    if constexpr (kScale) {
      v0 = __fmul_rn(v0, s1.v[p].x);
      v1 = __fmul_rn(v1, s1.v[p].y);
    }
  };
  if constexpr (!kFullTmaStore) {
    for_pairs(d, h, [&](int m, int k, float v0, float v1, int p) {
      if (m < rows) {
        value(v0, v1, p);
        __stcs(reinterpret_cast<float2*>(yg + m * kLane + k), make_float2(v0, v1));
      }
    });
  } else {
    // Each warp's 16 rows (8 KB of fp32) through a piece of the warpgroup's
    // rows of the tile (8 KB in each column half): warps 0 and 1, then 2
    // and 3, each bulk-storing its own piece.
    const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
    float* piece = reinterpret_cast<float*>(tile + (warp & 1) * kHalfBytes + 64 * h * 128);
    const int m0 = 64 * h + 16 * warp;
#pragma unroll
    for (int turn = 0; turn < 2; ++turn) {
      if (warp >> 1 == turn) {
        for_pairs(d, h, [&](int m, int k, float v0, float v1, int p) {
          value(v0, v1, p);
          *reinterpret_cast<float2*>(piece + (m - m0) * kLane + k) = make_float2(v0, v1);
        });
        tma::fence_proxy_async();
        __syncwarp();
        const int n = min(max(rows - m0, 0), 16);
        if (lane == 0 && n > 0) {
          tma::bulk_store(yg + m0 * kLane, piece, (uint32_t)n * kLane * sizeof(float));
          tma::bulk_commit();
          tma::bulk_wait_read<0>();
        }
      }
      wg_sync(h);  // the pieces are read: they may be written again
    }
  }
}

// x, y (n_elems / D, D = 2^log2d) contiguous; the product's first
// kContractions contractions (4: the whole product; 1 and 2 are k_mm1's
// and k_mm2's functions, y written after the first or second)
template <int kContractions>
__global__ void __launch_bounds__(kFullThreads, 1)
    kron_full_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                     const float* __restrict__ u, const float* __restrict__ s2,
                     float* __restrict__ y, int64_t n_elems, int log2d) {
  static_assert(kContractions == 1 || kContractions == 2 || kContractions == 4);
  extern __shared__ __align__(1024) char full_smem[];
  char* base = full_smem + ((1024 - tma::smem_addr(full_smem) % 1024) % 1024);
  const int a = 1 << (log2d - 7), amask = a - 1, dmask = (1 << log2d) - 1;
  char* h128 = base;
  char* tile = base + kTileBytes;
  float* ring = reinterpret_cast<float*>(base + kRingOffset);
  char* g = a == kLane ? h128 : base + kTailOffset;
  float* s2s = reinterpret_cast<float*>(base + kTailOffset + (a == kLane ? 0 : kTileBytes));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kTailOffset + kGroupElems * sizeof(float));
  const int64_t n_groups = (n_elems + kGroupElems - 1) / kGroupElems;
  const int64_t mine = (n_groups - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int h = threadIdx.x >> 7, t = threadIdx.x & 127;
  const bool diag_blocks = a <= 64, all_rows = !diag_blocks;
  // the warpgroups meet where a product reads the other's rows
  auto sync_tile = [&] {
    if (all_rows)
      __syncthreads();
    else
      wg_sync(h);
  };

  // half-group q of the block (half q % 2 of its group q / 2) into slot q %
  // kSlots, counted on its barrier (a half past the end of x lands 0 bytes)
  auto fetch = [&](int64_t q) {
    const int64_t off = (blockIdx.x + (q >> 1) * gridDim.x) * kGroupElems + (q & 1) * kSlotElems;
    const int64_t left = n_elems - off;
    const uint32_t bytes = left <= 0 ? 0u
                                     : (uint32_t)(left < kSlotElems ? left : kSlotElems) *
                                           (uint32_t)sizeof(float);
    uint64_t* bar = &full[q % kSlots];
    tma::arrive_expect_tx(bar, bytes);
    if (bytes > 0) tma::bulk_load(ring + (q % kSlots) * kSlotElems, x + off, bytes, bar);
  };

  build_factors(h128, g, amask);
  for (int f = threadIdx.x; f < (1 << log2d) / 4; f += kFullThreads)
    reinterpret_cast<float4*>(s2s)[f] = __ldg(reinterpret_cast<const float4*>(s2) + f);
  tma::fence_proxy_async();  // the tiles are read by wgmma (the async proxy)
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i) tma::barrier_init(&full[i], 1);
    tma::fence_barrier_init();
    for (int64_t q = 0; q < kSlots && q < 2 * mine; ++q) fetch(q);
  }
  __syncthreads();

  Diag du, ds1;
  if constexpr (kFullDiagRegs && kContractions == 4) {
    du.load(u, h, amask);
    ds1.load(s1, h, amask);
  }
  const uint32_t tile_s = tma::smem_addr(tile), h_s = tma::smem_addr(h128),
                 g_s = tma::smem_addr(g);
  for (int64_t i = 0; i < mine; ++i) {
    const int64_t first = (blockIdx.x + i * gridDim.x) * kGroupElems;
    const int rows = (int)(n_elems - first < kGroupElems ? n_elems - first : kGroupElems) >> 7;
    float* yg = y + first;
    // 1. R(s2 * x) of the warpgroup's half; then its slot takes the
    // half-group kSlots on
    const int64_t q = 2 * i + h;
    tma::wait_parity(&full[q % kSlots], (uint32_t)((q / kSlots) & 1));
    scale_half(ring + (q % kSlots) * kSlotElems, s2s, tile, h, rows, dmask);
    tma::fence_proxy_async();
    wg_sync(h);
    if (t == 0 && q + kSlots < 2 * mine) fetch(q + kSlots);
    // 2. the products; each epilogue writes only after every warp that reads
    // the rows is done, and the next product waits for the writes
    float d[64];
    auto nothing = [] {};
    contract<false>(d, tile_s, h_s, h, false, nothing);
    wg_sync(h);
    if constexpr (kContractions == 1) {
      store_y<false>(d, h, yg, rows, ds1, tile);
      continue;
    }
    round_into<false>(d, h, tile, du);
    tma::fence_proxy_async();
    sync_tile();
    contract<true>(d, g_s, tile_s, h, diag_blocks, [&] {
      if constexpr (!kFullDiagRegs && kContractions == 4) du.load(u, h, amask);
    });
    sync_tile();
    if constexpr (kContractions == 2) {
      store_y<false>(d, h, yg, rows, ds1, tile);
      continue;
    }
    round_into<true>(d, h, tile, du);
    tma::fence_proxy_async();
    sync_tile();
    contract<true>(d, g_s, tile_s, h, diag_blocks, nothing);
    sync_tile();
    round_into<false>(d, h, tile, du);
    tma::fence_proxy_async();
    wg_sync(h);
    contract<false>(d, tile_s, h_s, h, false, [&] {
      if constexpr (!kFullDiagRegs) ds1.load(s1, h, amask);
    });
    wg_sync(h);
    store_y<true>(d, h, yg, rows, ds1, tile);
  }
  if constexpr (kFullTmaStore) {
    if ((t & 31) == 0) tma::bulk_wait_all();
  }
}

template <int kContractions>
cudaError_t launch_full(const float* x, const float* s1, const float* u, const float* s2,
                        float* y, int64_t B, int log2d, cudaStream_t stream) {
  auto kernel = kron_full_kernel<kContractions>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFullSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFullThreads, kFullSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t n_elems = B << log2d;
  const int64_t groups = (n_elems + kGroupElems - 1) / kGroupElems, grid = (int64_t)per_sm * sms;
  kernel<<<(unsigned)(groups < grid ? groups : grid), kFullThreads, kFullSmem, stream>>>(
      x, s1, u, s2, y, n_elems, log2d);
  return cudaGetLastError();
}

}  // namespace kron

// x, y contiguous (B, D = 2^log2d) fp32, s1, u, s2 (D,) fp32, every one on
// a 16-byte boundary; B % tb == 0 (tb is checked, not used). y = s1 * H(u
// * H(s2 * x)) with the TPU bodies' roundings. Returns the launch's
// cudaError_t (cudaErrorInvalidValue, nothing launched, for an operand
// off the boundary or a tiling the kernels do not take).
extern "C" int kron_full_f32(const void* x, const void* s1, const void* u, const void* s2,
                             void* y, int64_t B, int log2d, int tb, void* stream) {
  auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (!kron::valid_tiling(B, log2d, tb) || off16(x) || off16(y) || off16(s1) || off16(u) ||
      off16(s2))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  return (int)kron::launch_full<4>(
      static_cast<const float*>(x), static_cast<const float*>(s1), static_cast<const float*>(u),
      static_cast<const float*>(s2), static_cast<float*>(y), B, log2d,
      static_cast<cudaStream_t>(stream));
}
