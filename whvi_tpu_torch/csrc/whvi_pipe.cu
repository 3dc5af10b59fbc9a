// A copy streamed by a persistent kernel through a ring of stages in
// shared memory.
//
// Replaces benchmarks/pallas_diag.py:make_emit_copy (:322): a manual
// double-buffered emit_pipeline with y = x: a DMA of each block into the
// core's memory, a body that copies it, a DMA back out. The TPU harness
// paired it with make_emit_full (:120, k_full's body under the same
// pipeline): what lies between the two is the compute. emit_full runs
// whvi_full.cu's kernel, which streams x through a ring of the same shape
// (16 KB TMA bulk loads, full/empty barriers, a producer warp).
//
// emit_copy: the emit_pipeline's shape on Hopper's TMA (tma.cuh), bound
// by HBM (8 bytes an element against 3.35 TB/s). Bytes in flight on every
// SM bound such a copy (copy_floor.cu): the emit_pipeline's shape as it
// stands, a two-stage cp.async ring, one block a tile (128 blocks at TB = 4, 8 / 4 / 2 at the
// TPU's TB = 64 / 128 / 256) and at most one 64 KB load in flight a block
// while its threads store the other stage, reached 0.78 of HBM at TB = 4
// and 0.05-0.20 at the TPU's tiles. So:
//   - a persistent grid over chunks, not tiles: each tb-row tile is cut
//     into chunks of at most one stage (kCopyStageBytes); a chunk never
//     crosses a tile boundary and a tile's last chunk may be short
//     (copy_2d's rule). The grid is min(kCopyBlocksPerSm * #SMs, chunks),
//     so every SM works at any tile;
//   - warp-specialised: lane 0 of the producer warp keeps kCopyInStages
//     bulk loads in flight into the ring (192 KB an SM), each armed on its
//     stage's `full` barrier, and refills a stage once its `empty` barrier
//     says every consumer warp has read it;
//   - the body: kCopyConsumerWarps warps wait on `full`, read the stage
//     (float4, consecutive threads on consecutive 16 bytes: no bank
//     conflicts), store it to global memory (st.global.cs), and release
//     the stage, one arrival a warp. No block-wide barrier after the
//     roles part: a __syncthreads would wait for the producer warp.
// A body that copies each stage into a second ring in shared memory and
// bulk-stores that (the skeleton a compute body would fit into) was
// measured beside it on the H100 with the ring shapes: 0-2% slower at
// equal shared memory, its in-ring smaller by the out-ring
// (bench/kron_variants.py, PERF.md).
#include "kron_core.cuh"
#include "tma.cuh"

namespace kron {

// emit_copy's ring: its stages, their barriers, blocks an SM
constexpr int kCopyStageBytes = 16 * 1024;
constexpr int kCopyInStages = 6;
constexpr int kCopyBlocksPerSm = 2;
constexpr int kCopyConsumerWarps = 4;
constexpr int kCopyConsumers = 32 * kCopyConsumerWarps;
constexpr int kCopyThreads = kCopyConsumers + 32;  // and the producer warp
constexpr size_t kCopyRingBytes = (size_t)kCopyInStages * kCopyStageBytes;
constexpr size_t kCopySmem = kCopyRingBytes + 2 * kCopyInStages * sizeof(uint64_t);
static_assert(kCopyBlocksPerSm * (kCopySmem + 1024) <= 228 * 1024,
              "the rings of kCopyBlocksPerSm blocks must fit an SM's shared memory");

// n_tiles tiles of tile_bytes each (a multiple of 16), cut into
// per_tile chunks; gridDim.x <= n_tiles * per_tile.
__global__ void __launch_bounds__(kCopyThreads)
    emit_copy_kernel(const char* __restrict__ x, char* __restrict__ y,
                     int64_t n_tiles, int64_t tile_bytes, int64_t per_tile) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* in = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kCopyRingBytes);
  uint64_t* empty = full + kCopyInStages;
  const int64_t n_chunks = n_tiles * per_tile;
  const int64_t mine = (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // byte offset and size of this block's j-th chunk
  auto chunk = [&](int64_t j, uint32_t& bytes) {
    const int64_t c = blockIdx.x + j * gridDim.x;
    const int64_t tile = c / per_tile;
    const int64_t off = (c - tile * per_tile) * kCopyStageBytes;
    const int64_t left = tile_bytes - off;
    bytes = (uint32_t)(left < kCopyStageBytes ? left : kCopyStageBytes);
    return tile * tile_bytes + off;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kCopyInStages; ++s) {
      tma::barrier_init(&full[s], 1);
      tma::barrier_init(&empty[s], kCopyConsumerWarps);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  if (warp == kCopyConsumerWarps) {  // the producer
    if (lane != 0) return;
    for (int64_t j = 0; j < mine; ++j) {
      const int s = (int)(j % kCopyInStages);
      const int64_t fill = j / kCopyInStages;  // of stage s
      // fill k of a stage goes in once the consumers released fill k - 1
      if (fill > 0) tma::wait_parity(&empty[s], (uint32_t)((fill - 1) & 1));
      uint32_t bytes;
      const int64_t off = chunk(j, bytes);
      tma::arrive_expect_tx(&full[s], bytes);
      tma::bulk_load(in + (size_t)s * kCopyStageBytes, x + off, bytes, &full[s]);
    }
    return;
  }

  // the consumers: chunk j from stage j % kCopyInStages
  for (int64_t j = 0; j < mine; ++j) {
    const int s = (int)(j % kCopyInStages);
    uint32_t bytes;
    const int64_t off = chunk(j, bytes);
    const float4* src = reinterpret_cast<const float4*>(in + (size_t)s * kCopyStageBytes);
    float4* dst = reinterpret_cast<float4*>(y + off);
    tma::wait_parity(&full[s], (uint32_t)((j / kCopyInStages) & 1));
    for (int q = threadIdx.x; q < (int)(bytes / 16); q += kCopyConsumers) __stcs(dst + q, src[q]);
    __syncwarp();  // the warp has read the stage
    if (lane == 0) tma::barrier_arrive(&empty[s]);
  }
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

cudaError_t launch_emit_copy(const float* x, float* y, int64_t B, int log2d, int tb,
                             cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = B / tb;
  const int64_t tile_bytes = ((int64_t)tb << log2d) * (int64_t)sizeof(float);
  const int64_t per_tile = (tile_bytes + kCopyStageBytes - 1) / kCopyStageBytes;
  const int64_t n_chunks = n_tiles * per_tile;
  const int64_t grid = (int64_t)kCopyBlocksPerSm * sms;
  err = cudaFuncSetAttribute(emit_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kCopySmem);
  if (err != cudaSuccess) return err;
  emit_copy_kernel<<<(unsigned)(n_chunks < grid ? n_chunks : grid), kCopyThreads, kCopySmem,
                     stream>>>(reinterpret_cast<const char*>(x), reinterpret_cast<char*>(y),
                               n_tiles, tile_bytes, per_tile);
  return cudaGetLastError();
}

}  // namespace kron

// x, y contiguous (B, D = 2^log2d) fp32 on 16-byte boundaries, B % tb
// == 0: y = x in (tb, D) tiles. Returns the launch's cudaError_t
// (cudaErrorInvalidValue, nothing launched, for an operand off the
// boundary or a tiling the kernels do not take).
extern "C" int kron_pipe_f32(const void* x, void* y, int64_t B, int log2d, int tb,
                             void* stream) {
  using namespace kron;
  auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (!valid_tiling(B, log2d, tb) || off16(x) || off16(y)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  return (int)launch_emit_copy(static_cast<const float*>(x), static_cast<float*>(y), B, log2d,
                               tb, static_cast<cudaStream_t>(stream));
}
