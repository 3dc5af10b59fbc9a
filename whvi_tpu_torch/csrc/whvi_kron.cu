// The stage-by-stage and layout variants of the Kronecker-factor WHVI
// product, fp32 in and out, bf16 factor operands, fp32 accumulation.
//
// Replaces the Pallas kernel bodies of the TPU diagnosis harnesses:
//   benchmarks/pallas_diag.py  k_copy, k_scale, k_mm1, k_mm2, k_full
//                              (stage = copy .. full, flat layout);
//   benchmarks/pallas_tune.py  k_cur, k_swap, k_flat, k_onecast
//                              (stage = full, layout = cur/swap/flat/onecast).
// One kernel, templated on the stage and the layout, as the bodies are
// one product built up a stage at a time (kron_core.cuh says what is
// rounded where).
//
// Tiling, as the TPU grid: block b owns rows [b*tb, (b+1)*tb) of x
// (B, D); the caller picks tb and B % tb must be 0. A block walks its
// rows a group of 16384 / D rows at a time (kron_core.cuh).
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
//   swap     CUDA cores. After H_128 the group is transposed through a
//            second buffer into (128, a) at a pitch of a + 1 floats (no
//            bank conflicts), so H_a runs over the contiguous axis, then
//            transposed back for the last H_128 (up to 192 KB).
//   copy and scale stream the block's tile through registers, 16 bytes a
//   thread, and use no shared memory.
//
// What bounds it on an H100: at D = 16384 the product moves 8 bytes an
// element (x in, y out) against 2 * 2 * (128 + 128) = 1024 matmul flops
// an element: 2 * 128 flops per byte, below the 295 of the bf16 tensor
// cores, so the flat layout is memory-bound once its tensor-core work runs
// near peak. This first version builds every fragment with scalar shared
// loads and generates H from popcount, so it is compute-bound; the CUDA
// core layouts are compute-bound by their shared-memory passes. Small
// tb leaves SMs idle: B / tb blocks.
//
// Left for later: ldmatrix and wgmma, TMA, and keeping the diagonals in
// shared memory.
#include "kron_core.cuh"

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

__device__ __forceinline__ void swap_group(float* buf, float* tr,
                                           const float* x, float* y, int nr,
                                           int log2d,
                                           const float* __restrict__ s1,
                                           const float* __restrict__ u,
                                           const float* __restrict__ s2) {
  const int D = 1 << log2d, n = nr << log2d, dmask = D - 1;
  const int log2a = log2d - 7, a = 1 << log2a, pitch = a + 1;
  // buf[(r, i, k)] <-> tr[(r*128 + k) * pitch + i]
  auto tr_index = [&](int e) {
    return ((e >> log2d) * kLane + (e & (kLane - 1))) * pitch + ((e >> 7) & (a - 1));
  };
  load_scaled<false>(buf, x, s2, n, dmask);
  pass(buf, n, [](float v, int) { return round_bf16(v); });
  butterfly_stages(buf, nr, log2d, D, 0, 7);  // H_128
  for (int e = threadIdx.x; e < n; e += kThreads) tr[tr_index(e)] = round_bf16(buf[e]);
  __syncthreads();
  butterfly_stages(tr, nr * kLane, log2a, pitch, 0, log2a);  // H_a
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int v = p >> log2a, i = p & (a - 1);
    float* t = tr + (size_t)v * pitch + i;
    *t = round_bf16(*t * __ldg(u + i * kLane + (v & (kLane - 1))));
  }
  __syncthreads();
  butterfly_stages(tr, nr * kLane, log2a, pitch, 0, log2a);  // H_a
  for (int e = threadIdx.x; e < n; e += kThreads) buf[e] = round_bf16(tr[tr_index(e)]);
  __syncthreads();
  butterfly_stages(buf, nr, log2d, D, 0, 7);  // H_128
  store_scaled(buf, y, s1, n, dmask);
}

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

  if constexpr (kStage == kCopy || kStage == kScale) {
    const int64_t n4 = ((int64_t)tb << log2d) >> 2;
    const int dmask4 = (D >> 2) - 1;
    for (int64_t q = threadIdx.x; q < n4; q += kThreads) {
      float4 v = reinterpret_cast<const float4*>(xb)[q];
      if constexpr (kStage == kScale) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(s1) + (q & dmask4));
        v = make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
      }
      reinterpret_cast<float4*>(yb)[q] = v;
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
      } else if constexpr (kLayout == kSwap) {
        float* buf = reinterpret_cast<float*>(smem);
        swap_group(buf, buf + kGroupElems, xg, yg, nr, log2d, s1, u, s2);
      } else {
        cur_group<kLayout == kOneCast>(reinterpret_cast<float*>(smem), xg, yg,
                                       nr, log2d, s1, u, s2);
      }
      __syncthreads();  // the next group overwrites the buffers
    }
  }
}

size_t smem_bytes(int stage, int layout, int log2d) {
  if (stage == kCopy || stage == kScale) return 0;
  if (layout == kFlat) return kFlatSmem;
  const size_t group = (size_t)kGroupElems * sizeof(float);
  if (layout == kSwap) {
    const size_t rows = (size_t)kGroupElems >> log2d;
    return group + rows * kLane * (((size_t)1 << (log2d - 7)) + 1) * sizeof(float);
  }
  return group;
}

template <int kStage, int kLayout>
cudaError_t launch(const float* x, const float* s1, const float* u,
                   const float* s2, float* y, int64_t B, int log2d, int tb,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(kStage, kLayout, log2d);
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

}  // namespace kron

// x, y contiguous (B, D = 2^log2d) fp32; s1, u, s2 (D,) fp32 (the copy
// stage reads none of them, the scale stage only s1). stage: 0 copy,
// 1 scale, 2 mm1, 3 mm2, 4 full; layout: 0 cur, 1 swap, 2 flat,
// 3 onecast (the stages below full take the flat layout only). Returns
// the launch's cudaError_t (0 on success).
extern "C" int kron_stage_f32(const void* x, const void* s1, const void* u,
                              const void* s2, void* y, int64_t B, int log2d,
                              int tb, int stage, int layout, void* stream) {
  using namespace kron;
  if (!valid_tiling(B, log2d, tb)) return (int)cudaErrorInvalidValue;
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
      case kSwap: return KRON_LAUNCH(kFull, kSwap);
      case kOneCast: return KRON_LAUNCH(kFull, kOneCast);
    }
  }
#undef KRON_LAUNCH
  return (int)cudaErrorInvalidValue;
}
