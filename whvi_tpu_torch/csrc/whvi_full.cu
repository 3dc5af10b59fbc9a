// The Kronecker-factor WHVI product y = s1 * H(u * H(s2 * x)) and its
// first one or two factor contractions on the tensor cores, fp32 in and
// out, bf16 factor operands, fp32 accumulation: one persistent kernel of
// two warpgroups whose contractions a group are wgmma products on H tiles
// resident in shared memory.
//
// Replaces, by the number of contractions: 1, k_mm1 (:81 of
// benchmarks/pallas_diag.py); 2, k_mm2 (:88); 4, k_full (:98),
// make_emit_full's inner (:130, k_full's body under a manual
// emit_pipeline) and k_flat (benchmarks/pallas_tune.py:69, k_full again):
// one function statement for statement, so their wrappers launch one
// instance.
//
// The group (kron_core.cuh). x (B, D) is contiguous, so group g, 16384 /
// D rows, is the contiguous span [g * 16384, (g + 1) * 16384) of x: a
// 128 x 128 tile T whose lane-row m = r * a + i holds row r's elements
// [i * 128, (i + 1) * 128), a = D / 128. In the tile's terms the TPU body
// is four 128 x 128 x 128 products, at every D:
//   T1 = R(s2 * T) @ H_128                 (right; k_mm1's y)
//   T2 = G @ R(T1)                         (left; k_mm2's y)
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
// same accumulator, so at 4 contractions each thread holds its 64 of each
// in registers for the whole kernel (kFullDiagRegs), loaded once instead
// of from L2 every group (3 x 64 KB a group at D = 16384); s2 is read from
// shared memory, loaded once a block. That takes 244 registers a thread: 8
// warps, two a quarter of the SM, may have 255, where a ninth warp (a
// producer warp beside two consumer warpgroups) would cap every thread at
// 168. At 1 and 2 contractions u and s1 are not read: k_mm1's threads
// hold their 64 elements of s2 there (kMmS2Regs; k_mm2 gained nothing).
//
// The stream. x flows through a ring of 3 slots in shared memory, each a
// warpgroup's half of a group (32 KB): once warpgroup h has formed R(s2 *
// x) of its half of group k, its thread 0 has the TMA unit load the
// half-group 3 places on into the slot (one full barrier a slot), so 1.5
// groups' loads are in flight while one is computed (k_mm1 has room for
// 5, but each slot past 3 cost it 2-3%, PERF.md). The epilogues work in registers: the rounding (and * u after the second)
// written back into the tile in place, and after the last contraction (*
// s1 at 4) stored to y from registers (st.global.cs), or (kFullTmaStore,
// kMmTmaStore) through the tile and TMA bulk stores. The row tile tb is
// checked, not used: the time does not depend on the TPU's tile.
//
// kron_whole_kernel (kMmWholeGroup, off: slower on the H100) gives each
// warpgroup whole groups in its own tile and two slots instead, so the
// warpgroups never meet; s2 comes from L2, and k_mm2 below D = 16384
// (no room for G) keeps the split rows.
//
// What bounds it on an H100: per group 4 x 2 x 128^3 = 16.8 MFLOP at 4
// contractions (about 2.2 us of an SM's share of the bf16 peak; 0.56 us a
// contraction) against 128 KB of HBM (about 5.2 us of an SM's share of
// 3.35 TB/s), so it is HBM-bound once a group's serial chain (R(s2 * x),
// the products and their epilogues, the warpgroups' meetings, the stores)
// fits under its loads: about half the bound at 4 contractions, 0.72 and
// 0.65 at 1 and 2, where the copies reach 0.85 (PERF.md).
//
// Shared memory: H_128 and the operand tile (32 KB each), the ring (96
// KB), then G (32 KB) and s2 (4 D bytes, up to 32 KB) or, at D = 16384
// where G is H_128, s2 alone (64 KB); the ring's barriers: 225 KB.
#include "kron_core.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace kron {

// Design switches, one line each, so that bench/kron_variants.py can time
// the kernel without them. At 4 contractions: u and s1 held in registers
// for the whole kernel (false: loaded from L2 every group, under the
// product before their epilogue); y through shared memory and TMA bulk
// stores (false: st.global.cs from registers). At 1 and 2: s2 in
// registers at up to kMmS2Regs contractions (else in shared memory),
// there beside kMmSlots slots (then G); y by TMA bulk stores; whole groups
// a warpgroup (kron_whole_kernel).
constexpr bool kFullDiagRegs = true;
constexpr bool kFullTmaStore = false;
constexpr int kMmS2Regs = 1;
constexpr int kMmSlots = 3;
constexpr bool kMmTmaStore = false;
constexpr bool kMmWholeGroup = false;

constexpr int kFullThreads = 256;  // two warpgroups
constexpr uint32_t kTileBytes = kGroupRows * kLane * sizeof(bf16);  // 32 KB
constexpr uint32_t kHalfBytes = kTileBytes / 2;  // 64 columns
constexpr int kSlots = 3;
constexpr uint32_t kSlotElems = kGroupElems / 2;  // a warpgroup's half of a group
constexpr size_t kSlotBytes = kSlotElems * sizeof(float);
constexpr int kHalfSteps = kSlotElems / 4 / 128;  // float4s a thread in half a group
constexpr size_t kRingOffset = 2 * (size_t)kTileBytes;
constexpr size_t kTailOffset = kRingOffset + kSlots * kSlotBytes;  // G, s2
constexpr size_t kFullSmem =
    1024 + kTailOffset + kGroupElems * sizeof(float) + kSlots * sizeof(uint64_t);
constexpr size_t kMmGOffset = kRingOffset + kMmSlots * kSlotBytes;
constexpr size_t kMmBarOffset = kMmGOffset + kTileBytes;
constexpr size_t kMmSmem = 1024 + kMmBarOffset + kMmSlots * sizeof(uint64_t);
constexpr int kWholeSlots = 4;
constexpr size_t kWholeRingOffset = 3 * (size_t)kTileBytes;
constexpr size_t kWholeBarOffset = kWholeRingOffset + kWholeSlots * kSlotBytes;
constexpr size_t kWholeSmem = 1024 + kWholeBarOffset + kWholeSlots * sizeof(uint64_t);
static_assert(kFullSmem <= 232448 && kMmSmem <= 232448 && kWholeSmem <= 232448,
              "a block's shared memory");

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

// Lane-row and column of the thread's float4 q (< kHalfSteps) of a
// group's rows 64h .. 64h + 63: float4 f = t + 128 q of the half, t the
// thread's index in its warpgroup (a warp reads 512 contiguous bytes).
__device__ __forceinline__ int2 half_at(int h, int q) {
  const int f = (threadIdx.x & 127) + 128 * q;
  return make_int2(64 * h + (f >> 5), (f & 31) << 2);
}

// Rows 64h .. 64h + 63 of the operand tile = R(src * s2), src their fp32
// in a ring slot, s2at(q, m, j) the float4 of s2 at the thread's float4 q
// (lane-row m, column j). Lane-rows at or past `rows` (past the end of x)
// are zero, so that G's zeros meet no stale NaN. kUnrolled: every step
// unrolled (s2 from registers, indexed by q).
template <bool kUnrolled, class S2>
__device__ __forceinline__ void scale_half(const float* src, S2 s2at, char* tile, int h,
                                           int rows) {
  auto step = [&](int q) {
    const int2 mj = half_at(h, q);
    const float4 v = reinterpret_cast<const float4*>(src)[(threadIdx.x & 127) + 128 * q];
    const float4 a = s2at(q, mj.x, mj.y);
    *reinterpret_cast<uint2*>(tile + tile_offset(mj.x, mj.y)) =
        mj.x < rows
            ? make_uint2(pack_bf16(v.x * a.x, v.y * a.y), pack_bf16(v.z * a.z, v.w * a.w))
            : make_uint2(0u, 0u);
  };
  if constexpr (kUnrolled) {
#pragma unroll
    for (int q = 0; q < kHalfSteps; ++q) step(q);
  } else {
#pragma unroll 4
    for (int q = 0; q < kHalfSteps; ++q) step(q);
  }
}

// The thread's float4s of s2 in scale_half's order for rows 64h ..: the
// same in every group, so held in registers for the whole kernel.
struct S2Regs {
  float4 v[kHalfSteps];

  __device__ __forceinline__ void load(const float* __restrict__ s2, int h, int dmask) {
#pragma unroll
    for (int q = 0; q < kHalfSteps; ++q) {
      const int2 mj = half_at(h, q);
      v[q] = __ldg(reinterpret_cast<const float4*>(s2 + ((mj.x * kLane + mj.y) & dmask)));
    }
  }
};

// descriptor of a K-major tile at k16 step kk, rows from 64 * mh
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int mh, int kk) {
  return wgmma::smem_desc(tile + (kk >> 2) * kHalfBytes + (kk & 3) * 32 + mh * 64 * 128, 16,
                          1024);
}

// descriptor of a tile read MN-major at k16 step kk (its rows 16kk..)
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return wgmma::smem_desc(tile + kk * 16 * 128, kHalfBytes, 1024);
}

// Starts d = rows 64h .. 64h + 63 of a product of two tiles: kLeft false,
// A @ H_128 (a the operand, b H_128); kLeft true, G @ B (a G, b the
// operand read MN-major; diag_blocks: only G's diagonal 64 x 64 blocks are
// nonzero, a <= 64, so only the operand's rows 64h .. meet them).
template <bool kLeft>
__device__ __forceinline__ void start_product(float (&d)[64], uint32_t a, uint32_t b, int h,
                                              bool diag_blocks) {
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
}

// start_product()'s product; pre() runs while it does. Returns once the warp's
// products are done.
template <bool kLeft, class Pre>
__device__ __forceinline__ void contract(float (&d)[64], uint32_t a, uint32_t b, int h,
                                         bool diag_blocks, Pre pre) {
  wgmma::fence_operand(d);
  wgmma::fence();
  start_product<kLeft>(d, a, b, h, diag_blocks);
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

// R(d) (kScale: R(d * w); w is read only then) back into the operand tile
template <bool kScale>
__device__ __forceinline__ void round_into(const float (&d)[64], int h, char* tile,
                                           const Diag* w) {
  for_pairs(d, h, [&](int m, int k, float v0, float v1, int p) {
    if constexpr (kScale) {
      v0 *= w->v[p].x;
      v1 *= w->v[p].y;
    }
    *reinterpret_cast<uint32_t*>(tile + tile_offset(m, k)) = pack_bf16(v0, v1);
  });
}

// y's lane-rows below `rows` (of rows 64h ..) = d, each pair p first
// through value(v0, v1, p) (* s1 at 4 contractions, nothing at 1 and 2);
// kTma: through the tile's rows 64h .. and TMA bulk stores, the calling
// warpgroup meeting twice
template <bool kTma, class Value>
__device__ __forceinline__ void store_y(const float (&d)[64], int h, float* yg, int rows,
                                        char* tile, Value value) {
  if constexpr (!kTma) {
    for_pairs(d, h, [&](int m, int k, float v0, float v1, int p) {
      if (m < rows) {
        value(v0, v1, p);
        __stcs(reinterpret_cast<float2*>(yg + m * kLane + k), make_float2(v0, v1));
      }
    });
  } else {
    // Each warp's 16 rows (8 KB of fp32) through a piece of the rows 64h ..
    // of the tile (8 KB in each column half): warps 0 and 1, then 2 and 3,
    // each bulk-storing its own piece.
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
      wg_sync(threadIdx.x >> 7);  // the pieces are read: they may be written again
    }
  }
}

// a bulk load of x's elements [off, off + kSlotElems) (fewer at its end,
// none past it) into slot, counted on bar
__device__ __forceinline__ void fetch_half(const float* x, int64_t n_elems, int64_t off,
                                           float* slot, uint64_t* bar) {
  const int64_t left = n_elems - off;
  const uint32_t bytes = left <= 0 ? 0u
                                   : (uint32_t)(left < kSlotElems ? left : kSlotElems) *
                                         (uint32_t)sizeof(float);
  tma::arrive_expect_tx(bar, bytes);
  if (bytes > 0) tma::bulk_load(slot, x + off, bytes, bar);
}

static_assert(kMmS2Regs >= 0 && kMmS2Regs <= 2, "s2 in registers only where u and s1 are not");

// x, y (n_elems / D, D = 2^log2d) contiguous; the product's first
// kContractions contractions (4: the whole product; 1 and 2 are k_mm1's
// and k_mm2's functions, y written after the first or second; s1 and u
// are read only at 4)
template <int kContractions>
__global__ void __launch_bounds__(kFullThreads, 1)
    kron_full_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                     const float* __restrict__ u, const float* __restrict__ s2,
                     float* __restrict__ y, int64_t n_elems, int log2d) {
  static_assert(kContractions == 1 || kContractions == 2 || kContractions == 4);
  constexpr bool kS2Regs = kContractions <= kMmS2Regs;
  constexpr bool kTma = kContractions == 4 ? kFullTmaStore : kMmTmaStore;
  extern __shared__ __align__(1024) char full_smem[];
  char* base = full_smem + ((1024 - tma::smem_addr(full_smem) % 1024) % 1024);
  const int a = 1 << (log2d - 7), amask = a - 1, dmask = (1 << log2d) - 1;
  constexpr int slots = kS2Regs ? kMmSlots : kSlots;
  char* h128 = base;
  char* tile = base + kTileBytes;
  float* ring = reinterpret_cast<float*>(base + kRingOffset);
  char* g = a == kLane ? h128 : base + (kS2Regs ? kMmGOffset : kTailOffset);
  float* s2s = reinterpret_cast<float*>(base + kTailOffset + (a == kLane ? 0 : kTileBytes));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + (kS2Regs ? kMmBarOffset : kTailOffset + kGroupElems * sizeof(float)));
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
  // slots, counted on its barrier
  auto fetch = [&](int64_t q) {
    fetch_half(x, n_elems, (blockIdx.x + (q >> 1) * gridDim.x) * kGroupElems + (q & 1) * kSlotElems,
               ring + (q % slots) * kSlotElems, &full[q % slots]);
  };

  build_factors(h128, g, kContractions == 1 ? kLane - 1 : amask);  // k_mm1 needs no G
  if constexpr (!kS2Regs) {
    for (int f = threadIdx.x; f < (1 << log2d) / 4; f += kFullThreads)
      reinterpret_cast<float4*>(s2s)[f] = __ldg(reinterpret_cast<const float4*>(s2) + f);
  }
  tma::fence_proxy_async();  // the tiles are read by wgmma (the async proxy)
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) tma::barrier_init(&full[i], 1);
    tma::fence_barrier_init();
    for (int64_t q = 0; q < slots && q < 2 * mine; ++q) fetch(q);
  }
  __syncthreads();

  Diag du, ds1;
  if constexpr (kFullDiagRegs && kContractions == 4) {
    du.load(u, h, amask);
    ds1.load(s1, h, amask);
  }
  S2Regs s2r;
  if constexpr (kS2Regs) s2r.load(s2, h, dmask);
  const uint32_t tile_s = tma::smem_addr(tile), h_s = tma::smem_addr(h128),
                 g_s = tma::smem_addr(g);
  auto keep = [](float&, float&, int) {};
  for (int64_t i = 0; i < mine; ++i) {
    const int64_t first = (blockIdx.x + i * gridDim.x) * kGroupElems;
    const int rows = (int)(n_elems - first < kGroupElems ? n_elems - first : kGroupElems) >> 7;
    float* yg = y + first;
    // 1. R(s2 * x) of the warpgroup's half; then its slot takes the
    // half-group `slots` on
    const int64_t q = 2 * i + h;
    tma::wait_parity(&full[q % slots], (uint32_t)((q / slots) & 1));
    if constexpr (kS2Regs) {
      scale_half<true>(ring + (q % slots) * kSlotElems,
                       [&](int k, int, int) { return s2r.v[k]; }, tile, h, rows);
    } else {
      scale_half<false>(ring + (q % slots) * kSlotElems, [&](int, int m, int j) {
        return *reinterpret_cast<const float4*>(s2s + ((m * kLane + j) & dmask));
      }, tile, h, rows);
    }
    tma::fence_proxy_async();
    wg_sync(h);
    if (t == 0 && q + slots < 2 * mine) fetch(q + slots);
    // 2. the products; each epilogue writes only after every warp that reads
    // the rows is done, and the next product waits for the writes
    float d[64];
    auto nothing = [] {};
    contract<false>(d, tile_s, h_s, h, false, nothing);
    wg_sync(h);
    if constexpr (kContractions == 1) {
      store_y<kTma>(d, h, yg, rows, tile, keep);
      continue;
    }
    round_into<false>(d, h, tile, nullptr);
    tma::fence_proxy_async();
    sync_tile();
    contract<true>(d, g_s, tile_s, h, diag_blocks, [&] {
      if constexpr (!kFullDiagRegs && kContractions == 4) du.load(u, h, amask);
    });
    sync_tile();
    if constexpr (kContractions == 2) {
      store_y<kTma>(d, h, yg, rows, tile, keep);
      continue;
    }
    round_into<true>(d, h, tile, &du);
    tma::fence_proxy_async();
    sync_tile();
    contract<true>(d, g_s, tile_s, h, diag_blocks, nothing);
    sync_tile();
    round_into<false>(d, h, tile, nullptr);
    tma::fence_proxy_async();
    wg_sync(h);
    contract<false>(d, tile_s, h_s, h, false, [&] {
      if constexpr (!kFullDiagRegs) ds1.load(s1, h, amask);
    });
    wg_sync(h);
    store_y<kTma>(d, h, yg, rows, tile, [&](float& v0, float& v1, int p) {
      v0 = __fmul_rn(v0, ds1.v[p].x);
      v1 = __fmul_rn(v1, ds1.v[p].y);
    });
  }
  if constexpr (kTma) {
    if ((t & 31) == 0) tma::bulk_wait_all();
  }
}

// kron_full_kernel<kContractions>'s function (1 or 2 contractions; 2 only
// at D = 16384, where G is H_128) with whole groups a warpgroup: warpgroup
// h takes the block's groups h, h + 2, .., each into its own tile through
// its own two slots (its next group loads while it computes this one), as
// two m64 products a contraction; s2 from L2 every group.
template <int kContractions>
__global__ void __launch_bounds__(kFullThreads, 1)
    kron_whole_kernel(const float* __restrict__ x, const float* __restrict__ s2,
                      float* __restrict__ y, int64_t n_elems, int log2d) {
  static_assert(kContractions == 1 || kContractions == 2);
  extern __shared__ __align__(1024) char full_smem[];
  char* base = full_smem + ((1024 - tma::smem_addr(full_smem) % 1024) % 1024);
  const int dmask = (1 << log2d) - 1;
  const int h = threadIdx.x >> 7, t = threadIdx.x & 127;
  char* h128 = base;  // also G: D = 16384 at 2 contractions
  char* tile = base + (1 + h) * kTileBytes;
  float* ring = reinterpret_cast<float*>(base + kWholeRingOffset) + 2 * h * kSlotElems;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kWholeBarOffset);
  uint64_t* full = bars + 2 * h;
  const int64_t n_groups = (n_elems + kGroupElems - 1) / kGroupElems;
  const int64_t mine = (n_groups - blockIdx.x + gridDim.x - 1) / gridDim.x;

  // the block's group i into the warpgroup's two slots
  auto fetch = [&](int64_t i) {
    const int64_t first = (blockIdx.x + i * gridDim.x) * kGroupElems;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      fetch_half(x, n_elems, first + e * kSlotElems, ring + e * kSlotElems, &full[e]);
  };

  build_factors(h128, h128, kLane - 1);
  tma::fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWholeSlots; ++i) tma::barrier_init(&bars[i], 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0 && h < mine) fetch(h);

  const uint32_t tile_s = tma::smem_addr(tile), h_s = tma::smem_addr(h128);
  auto keep = [](float&, float&, int) {};
  auto s2at = [&](int, int m, int j) {
    return __ldg(reinterpret_cast<const float4*>(s2 + ((m * kLane + j) & dmask)));
  };
  for (int64_t i = h, k = 0; i < mine; i += 2, ++k) {
    const int64_t first = (blockIdx.x + i * gridDim.x) * kGroupElems;
    const int rows = (int)(n_elems - first < kGroupElems ? n_elems - first : kGroupElems) >> 7;
    float* yg = y + first;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      tma::wait_parity(&full[e], (uint32_t)(k & 1));
      scale_half<true>(ring + e * kSlotElems, s2at, tile, e, rows);
    }
    tma::fence_proxy_async();
    wg_sync(h);
    if (t == 0 && i + 2 < mine) fetch(i + 2);
    float d[2][64];
#pragma unroll
    for (int c = 0; c < kContractions; ++c) {
      if (c > 0) {  // k_mm2's left product reads all the tile's rows: the warpgroup's own
#pragma unroll
        for (int e = 0; e < 2; ++e) round_into<false>(d[e], e, tile, nullptr);
        tma::fence_proxy_async();
        wg_sync(h);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) wgmma::fence_operand(d[e]);
      wgmma::fence();
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c == 0)
          start_product<false>(d[e], tile_s, h_s, e, false);
        else
          start_product<true>(d[e], h_s, tile_s, e, false);
      }
      wgmma::commit();
      wgmma::wait<0>();
#pragma unroll
      for (int e = 0; e < 2; ++e) wgmma::fence_operand(d[e]);
      wg_sync(h);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) store_y<kMmTmaStore>(d[e], e, yg, rows, tile, keep);
  }
  if constexpr (kMmTmaStore) {
    if ((t & 31) == 0) tma::bulk_wait_all();
  }
}

// kernel<<<min(SMs x blocks an SM, groups), kFullThreads, smem>>>(args...)
template <typename... P, typename... A>
cudaError_t launch_groups(void (*kernel)(P...), size_t smem, int64_t groups,
                          cudaStream_t stream, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFullThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t grid = (int64_t)per_sm * sms;
  kernel<<<(unsigned)(groups < grid ? groups : grid), kFullThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int kContractions>
cudaError_t launch_full(const float* x, const float* s1, const float* u, const float* s2,
                        float* y, int64_t B, int log2d, cudaStream_t stream) {
  const int64_t n_elems = B << log2d, groups = (n_elems + kGroupElems - 1) / kGroupElems;
  if constexpr (kContractions < 4 && kMmWholeGroup) {
    if (kContractions == 1 || log2d == kMaxLog2D)
      return launch_groups(kron_whole_kernel<kContractions>, kWholeSmem, groups, stream, x, s2,
                           y, n_elems, log2d);
  }
  return launch_groups(kron_full_kernel<kContractions>,
                       kContractions <= kMmS2Regs ? kMmSmem : kFullSmem, groups, stream, x, s1,
                       u, s2, y, n_elems, log2d);
}

}  // namespace kron

// x, y contiguous (B, D = 2^log2d) fp32, s1, u, s2 (D,) fp32, on 16-byte
// boundaries where read (x, y and s2 always, s1 and u at 4 contractions);
// B % tb == 0 (tb is checked, not used). contractions: 4, y = s1 * H(u *
// H(s2 * x)); 1, y = R(s2 * x) @ H_128 on each lane-row (k_mm1); 2, then
// H_a over the other axis (k_mm2); with the TPU bodies' roundings. Returns
// the launch's cudaError_t (cudaErrorInvalidValue, nothing launched, for
// another count of contractions, an operand it reads off the boundary or
// a tiling the kernels do not take).
extern "C" int kron_full_f32(const void* x, const void* s1, const void* u, const void* s2,
                             void* y, int64_t B, int log2d, int tb, int contractions,
                             void* stream) {
  auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const bool product = contractions == 4;  // reads s1 and u
  if ((contractions != 1 && contractions != 2 && !product) || !kron::valid_tiling(B, log2d, tb) ||
      off16(x) || off16(y) || off16(s2) || (product && (off16(s1) || off16(u))))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const auto* fx = static_cast<const float*>(x);
  const auto* fs1 = static_cast<const float*>(s1);
  const auto* fu = static_cast<const float*>(u);
  const auto* fs2 = static_cast<const float*>(s2);
  auto* fy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (contractions) {
    case 1: return (int)kron::launch_full<1>(fx, fs1, fu, fs2, fy, B, log2d, st);
    case 2: return (int)kron::launch_full<2>(fx, fs1, fu, fs2, fy, B, log2d, st);
    default: return (int)kron::launch_full<4>(fx, fs1, fu, fs2, fy, B, log2d, st);
  }
}
