// BLS12-381 scalar field Fr as CUDA device functions.
//
// An element is 8 little-endian 32-bit words of its Montgomery form
// x*R mod r, R = 2^256, fully reduced below r: the same words that the
// port's torch tensors hold (go_curdleproofs_tpu_torch/ops/fr.py), so a
// kernel reads and writes those tensors as they are.
//
// Product, square, sum, difference and the reduction of raw words are
// straight-line PTX with hardware carry chains (fr_asm.cuh, written by
// gen_fp_asm.py with fp_asm.cuh: the same two-accumulator layout at 8
// words; r's words and -r^-1 mod 2^32 are immediates there). A Montgomery product with a canonical result is
// unique, so the kernels give the words of the plain torch versions.
#pragma once

#include <cstdint>

#include "fr_asm.cuh"

namespace curdle {

constexpr int FRW = 8;

struct Fr {
  uint32_t w[FRW];
};

// x = a + b mod r. x may alias a or b.
__device__ __forceinline__ void fr_add(Fr& x, const Fr& a, const Fr& b) {
  uint32_t t[FRW];
  fr_add_words(t, a.w, b.w);
#pragma unroll
  for (int j = 0; j < FRW; ++j) x.w[j] = t[j];
}

// x = a - b mod r. x may alias a or b.
__device__ __forceinline__ void fr_sub(Fr& x, const Fr& a, const Fr& b) {
  uint32_t t[FRW];
  fr_sub_words(t, a.w, b.w);
#pragma unroll
  for (int j = 0; j < FRW; ++j) x.w[j] = t[j];
}

// x = a * b / R mod r, fully reduced. x may alias a or b. a and b must be
// below r (fr_from_raw first where a may be raw words).
__device__ __forceinline__ void fr_mul(Fr& x, const Fr& a, const Fr& b) {
  uint32_t t[FRW];
  fr_mul_words(t, a.w, b.w);
#pragma unroll
  for (int j = 0; j < FRW; ++j) x.w[j] = t[j];
}

// x = a mod r for any a below R: raw words, which is how values enter and
// leave Montgomery form (a product with R^2 or with 1).
__device__ __forceinline__ void fr_from_raw(Fr& x, const Fr& a) {
  uint32_t t[FRW];
  fr_reduce_words(t, a.w);
#pragma unroll
  for (int j = 0; j < FRW; ++j) x.w[j] = t[j];
}

// x = a * a / R mod r: the words of fr_mul(x, a, a), from 36 of its 64
// partial products. a must be below r. x may alias a.
__device__ __forceinline__ void fr_sqr(Fr& x, const Fr& a) {
  uint32_t t[FRW];
  fr_sqr_words(t, a.w);
#pragma unroll
  for (int j = 0; j < FRW; ++j) x.w[j] = t[j];
}

}  // namespace curdle
