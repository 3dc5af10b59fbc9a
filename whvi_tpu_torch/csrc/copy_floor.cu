// Copy floors of the kernel-diagnosis path, fp32.
//
// Replaces benchmarks/pallas_diag.py:
//   make_hbm_copy (:269): one whole-array HBM -> HBM DMA, the TPU's raw
//     DMA floor. Its counterpart here is Hopper's DMA engine, the TMA
//     unit: the array goes as one flat tile through copy_2d's ring of
//     bulk copies, and no thread touches the data.
//   make_copy_2d (:296): the copy in (tb, D) tiles, each staged through
//     VMEM, one grid step at a time on the v5e's single TensorCore: the
//     whole chip works on one tile at a time. Its counterpart here is that
//     every byte passes through shared memory in tiles of tb rows with
//     every SM busy, through the same ring.
//
// What bounds both on an H100: HBM, 8 bytes an element (one read, one
// write) against 3.35 TB/s; the card's practical copy ceiling is about
// 0.9 of that. A copy reaches it only with enough bytes in flight on every
// SM. A grid-stride loop of one 16-byte load and its store a thread and
// iteration (hbm_copy's first version) stopped at 0.81 of HBM, slower than
// x.clone(); one block a tile (B / tb blocks, a 64 KB stage loaded, then
// stored, behind barriers) left SMs idle at the TPU's tiles (8, 4 and 2
// blocks at TB = 64, 128, 256 and B = 512) and never overlapped a block's
// loads with its stores: 0.65 of HBM at TB = 4 (PERF.md).
//
// The ring: a persistent grid of two blocks an SM. Each tile is cut into
// chunks of at most one ring stage (kStageBytes); a chunk never crosses a
// tile boundary, and a tile's last chunk may be short (a multiple of 16
// bytes, as every tile is). Block b walks chunks b, b + grid, ... through
// a ring of kStages stages in shared memory. One thread does all of it:
// it arms the stage's mbarrier and issues a bulk load (cp.async.bulk,
// global -> shared), waits on the barrier's phase, issues a bulk store of
// the stage (shared -> global, one bulk group a chunk), and refills the
// stage that the previous chunk's store has finished reading. kStages - 1
// loads stay in flight a block (160 KB an SM) while the stores drain, and
// no thread touches the data. Ring shapes measured on the H100 at D =
// 16384, B = 512 (PERF.md): 4 x 32 KB, one block an SM, 0.80 of HBM; 6 x
// 16 KB, two an SM, 0.84. For hbm_copy, k_copy's register loop over a
// persistent grid of 8 blocks an SM tied with the ring (within 1%,
// bench/kron_variants.py); the ring ships as the TPU DMA's counterpart.
#include <cstdint>

#include <cuda_runtime.h>

#include "tma.cuh"

namespace kron_copy {

// the ring: 6 x 16 KB and its barriers, two blocks an SM
constexpr int kStages = 6;
constexpr int kStageBytes = 16 * 1024;
constexpr int kBlocksPerSm = 2;
constexpr size_t kRingSmem = (size_t)kStages * kStageBytes + kStages * sizeof(uint64_t);
static_assert(kBlocksPerSm * (kRingSmem + 1024) <= 228 * 1024,
              "the rings of kBlocksPerSm blocks must fit an SM's shared memory");

// n_tiles tiles of tile_bytes each (a multiple of 16), cut into
// per_tile chunks; gridDim.x <= n_tiles * per_tile.
__global__ void __launch_bounds__(32)
    copy_2d_kernel(const char* __restrict__ x, char* __restrict__ y,
                   int64_t n_tiles, int64_t tile_bytes, int64_t per_tile) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)kStages * kStageBytes);
  const int64_t n_chunks = n_tiles * per_tile;
  const int64_t mine = (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;

  // byte offset and size of this block's j-th chunk
  auto chunk = [&](int64_t j, uint32_t& bytes) {
    const int64_t c = blockIdx.x + j * gridDim.x;
    const int64_t tile = c / per_tile;
    const int64_t off = (c - tile * per_tile) * kStageBytes;
    const int64_t left = tile_bytes - off;
    bytes = (uint32_t)(left < kStageBytes ? left : kStageBytes);
    return tile * tile_bytes + off;
  };
  auto load = [&](int64_t j) {
    uint32_t bytes;
    const int64_t off = chunk(j, bytes);
    const int s = (int)(j % kStages);
    tma::arrive_expect_tx(&full[s], bytes);
    tma::bulk_load(smem + (size_t)s * kStageBytes, x + off, bytes, &full[s]);
  };

  for (int s = 0; s < kStages; ++s) tma::barrier_init(&full[s], 1);
  tma::fence_barrier_init();
  for (int64_t j = 0; j < mine && j < kStages; ++j) load(j);
  for (int64_t j = 0; j < mine; ++j) {
    const int s = (int)(j % kStages);
    tma::wait_parity(&full[s], (uint32_t)((j / kStages) & 1));
    tma::fence_proxy_async();
    uint32_t bytes;
    const int64_t off = chunk(j, bytes);
    tma::bulk_store(y + off, smem + (size_t)s * kStageBytes, bytes);
    tma::bulk_commit();
    // chunk j - 1 + kStages goes where chunk j - 1 was, once its store
    // has read the stage; chunk j's store may still be reading
    if (j >= 1 && j - 1 + kStages < mine) {
      tma::bulk_wait_read<1>();
      load(j - 1 + kStages);
    }
  }
  tma::bulk_wait_all();
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// n_tiles tiles of tile_bytes (a multiple of 16) through the ring
cudaError_t launch_ring(const void* x, void* y, int64_t n_tiles, int64_t tile_bytes,
                        cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t per_tile = (tile_bytes + kStageBytes - 1) / kStageBytes;
  const int64_t n_chunks = n_tiles * per_tile;
  err = cudaFuncSetAttribute(copy_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kRingSmem);
  if (err != cudaSuccess) return err;
  const int64_t grid = (int64_t)kBlocksPerSm * sms;
  copy_2d_kernel<<<(unsigned)(n_chunks < grid ? n_chunks : grid), 32, kRingSmem, stream>>>(
      static_cast<const char*>(x), static_cast<char*>(y), n_tiles, tile_bytes, per_tile);
  return cudaGetLastError();
}

bool off16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace kron_copy

// x, y contiguous on 16-byte boundaries, n fp32 elements, n % 4 == 0: one
// tile of 4n bytes through the ring. Returns the launch's cudaError_t.
extern "C" int copy_hbm_f32(const void* x, void* y, int64_t n, void* stream) {
  using namespace kron_copy;
  if (n < 0 || n % 4 != 0 || off16(x) || off16(y)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return (int)launch_ring(x, y, 1, n * (int64_t)sizeof(float), static_cast<cudaStream_t>(stream));
}

// x, y contiguous (B, D) fp32 on 16-byte boundaries, D % 4 == 0,
// B % tb == 0. Returns the launch's cudaError_t.
extern "C" int copy_2d_f32(const void* x, void* y, int64_t B, int D, int tb,
                           void* stream) {
  using namespace kron_copy;
  if (B < 0 || D <= 0 || D % 4 != 0 || tb < 1 || B % tb != 0 || off16(x) || off16(y))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  return (int)launch_ring(x, y, B / tb, (int64_t)tb * D * (int64_t)sizeof(float),
                          static_cast<cudaStream_t>(stream));
}
