// BLS12-381 scalar field Fr as CUDA device functions.
//
// An element is 8 little-endian 32-bit words of its Montgomery form
// x*R mod r, R = 2^256, fully reduced below r: the same words that the
// port's torch tensors hold (go_curdleproofs_tpu_torch/ops/fr.py), so a
// kernel reads and writes those tensors as they are.
//
// Multiplication is CIOS Montgomery with 64-bit accumulators, written as
// fp.cuh writes it for 12 words. r < 2^255, so a sum of two elements has no
// carry out of the top word.
#pragma once

#include <cstdint>

namespace curdle {

constexpr int FRW = 8;

struct Fr {
  uint32_t w[FRW];
};

// r, -r^-1 mod 2^32, and R mod r (the element 1).
__constant__ uint32_t kR[FRW] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
constexpr uint32_t kRInv = 0xffffffffu;
__constant__ uint32_t kFrOne[FRW] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

// x = t - r if t >= r else t, for t < 2r.
__device__ __forceinline__ void fr_reduce_once(Fr& x, const uint32_t t[FRW]) {
  uint32_t d[FRW];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < FRW; ++j) {
    uint64_t s = (uint64_t)t[j] - kR[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = s >> 63;
  }
#pragma unroll
  for (int j = 0; j < FRW; ++j) x.w[j] = borrow ? t[j] : d[j];
}

__device__ __forceinline__ void fr_add(Fr& x, const Fr& a, const Fr& b) {
  uint32_t t[FRW];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < FRW; ++j) {
    uint64_t s = (uint64_t)a.w[j] + b.w[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  fr_reduce_once(x, t);  // a + b < 2r < 2^256: no carry out of the top word
}

__device__ __forceinline__ void fr_sub(Fr& x, const Fr& a, const Fr& b) {
  uint32_t t[FRW];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < FRW; ++j) {
    uint64_t s = (uint64_t)a.w[j] - b.w[j] - borrow;
    t[j] = (uint32_t)s;
    borrow = s >> 63;
  }
  uint32_t mask = 0u - (uint32_t)borrow;  // add r back when a < b
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < FRW; ++j) {
    uint64_t s = (uint64_t)t[j] + (kR[j] & mask) + c;
    x.w[j] = (uint32_t)s;
    c = s >> 32;
  }
}

// x = a * b / R mod r (CIOS). x may alias a or b. b must be below r; a may be
// any value below R (a * b < r * R keeps the result below 2r before the final
// subtraction), which is how raw words leave or enter Montgomery form.
__device__ __forceinline__ void fr_mul(Fr& x, const Fr& a, const Fr& b) {
  uint32_t t[FRW + 2];
#pragma unroll
  for (int j = 0; j < FRW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < FRW; ++i) {
    uint64_t c = 0;
    const uint32_t bi = b.w[i];
#pragma unroll
    for (int j = 0; j < FRW; ++j) {
      uint64_t s = (uint64_t)a.w[j] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[FRW] + c;
    t[FRW] = (uint32_t)s;
    t[FRW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * kRInv;
    s = (uint64_t)m * kR[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < FRW; ++j) {
      s = (uint64_t)m * kR[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[FRW] + c;
    t[FRW - 1] = (uint32_t)s;
    t[FRW] = t[FRW + 1] + (uint32_t)(s >> 32);
  }
  fr_reduce_once(x, t);  // t < 2r, so t[FRW] == 0
}

}  // namespace curdle
