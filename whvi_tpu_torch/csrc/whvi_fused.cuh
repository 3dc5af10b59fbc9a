// The fused WHVI product's shared device code: the two transforms of
// y = s1 * H(u * H(s2 * x)) over a register row (fwht_core.cuh), in both
// operand precisions, and the rounded products the kernels scale and sum
// with. whvi_fused.cu (K1-K3), whvi_bwd_sums.cu (K3's reduce mode) and
// whvi_grouped.cu (the grouped product, a segment of rows a WHVI matrix)
// inline the same code.
#pragma once

#include "fwht_core.cuh"

namespace whvi {

constexpr int kLaneLog2 = 7;        // H_128, the TPU's lane factor
constexpr int kOneFactorLog2 = 10;  // D <= 1024: one factor (_factor_pair)

// v <- v * d[0 .. R), each product rounded once and never fused into an add
template <int R>
__device__ __forceinline__ void scale(float (&v)[R], const float (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = __fmul_rn(v[j], d[j]);
}

// The first transform, from the I/O window back to it, stages upwards:
// H_D, or with bf16 operands and two factors (D >= 2048) H_128, the
// rounding, then H_a. Every thread of the block calls it.
template <int L, bool kBf16>
__device__ __forceinline__ void first_transform(float (&v)[RowShape<L>::R], RowExchange<L>& ex) {
  using S = RowShape<L>;
  constexpr bool kTwo = kBf16 && L > kOneFactorLog2;
  constexpr int kLo = kTwo ? kLaneLog2 : L;  // stages [0, kLo) are H_128, [kLo, L) H_a
  butterflies<L, kSplit, 0, kLo, 1>(v, ex);
  constexpr int w1 = S::after(kSplit, 0, kLo, 1);
  if constexpr (kTwo) {
    round_bf16(v);
    butterflies<L, w1, kLo, L, 1>(v, ex);
    to_io_window<L, S::after(w1, kLo, L, 1)>(v, ex);
  } else {
    to_io_window<L, w1>(v, ex);
  }
}

// The second transform, from the I/O window back to it: H_D, or with two
// bf16 factors H_a, the rounding, then H_128, stages downwards (the I/O
// window holds the top stages first and the bottom ones last).
template <int L, bool kBf16>
__device__ __forceinline__ void second_transform(float (&v)[RowShape<L>::R], RowExchange<L>& ex) {
  using S = RowShape<L>;
  constexpr bool kTwo = kBf16 && L > kOneFactorLog2;
  constexpr int kLo = kTwo ? kLaneLog2 : L;
  if constexpr (kTwo) {
    butterflies<L, kSplit, L - 1, kLo - 1, -1>(v, ex);
    constexpr int w2 = S::after(kSplit, L - 1, kLo - 1, -1);
    round_bf16(v);
    butterflies<L, w2, kLo - 1, -1, -1>(v, ex);
    to_io_window<L, S::after(w2, kLo - 1, -1, -1)>(v, ex);
  } else {
    butterflies<L, kSplit, 0, L, 1>(v, ex);
    to_io_window<L, S::after(kSplit, 0, L, 1)>(v, ex);
  }
}

// a[j] += v[j] * d[j], the product rounded once and never fused into the add
template <int R>
__device__ __forceinline__ void accumulate(float (&a)[R], const float (&v)[R], const float (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) a[j] += __fmul_rn(v[j], d[j]);
}

}  // namespace whvi
