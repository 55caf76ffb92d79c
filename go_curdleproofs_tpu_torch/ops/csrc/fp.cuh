// BLS12-381 base field Fp as CUDA device functions.
//
// An element is 12 little-endian 32-bit words of its Montgomery form
// x*R mod p, R = 2^384, fully reduced below p: the same words that the
// port's torch tensors hold (go_curdleproofs_tpu_torch/ops/fp.py), so a
// kernel reads and writes those tensors as they are.
//
// Product, square, sum and difference are straight-line PTX with hardware
// carry chains (fp_asm.cuh, written by gen_fp_asm.py: one asm statement a
// function, the multiply-adds of a row in two independent chains over even
// and odd word pairs). Every function takes and returns fully reduced
// elements, and a Montgomery product with a canonical result is unique, so
// the kernels give the words of the plain torch versions. The G1 point
// operations on these elements are in point_coop.cuh; the pointwise
// multiply of up to 4,096 elements spreads one product over a team of
// four lanes instead (fp_team.cuh), with the same canonical result.
#pragma once

#include <cstdint>

#include "fp_asm.cuh"

namespace curdle {

constexpr int NW = 12;

struct Fp {
  uint32_t w[NW];
};

// p (fp_asm.cuh has its words, and -p^-1 mod 2^32, as immediates) and
// R mod p (the element 1).
__constant__ uint32_t kP[NW] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
__constant__ uint32_t kOne[NW] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};

__device__ __forceinline__ void fp_set_zero(Fp& r) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = 0;
}

__device__ __forceinline__ void fp_set_one(Fp& r) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = kOne[j];
}

// r = a + b mod p. r may alias a or b.
__device__ __forceinline__ void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW];
  fp_add_words(t, a.w, b.w);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
}

// r = a - b mod p. r may alias a or b.
__device__ __forceinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW];
  fp_sub_words(t, a.w, b.w);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
}

// r = -a; the negation of 0 is 0, not p.
__device__ __forceinline__ void fp_neg(Fp& r, const Fp& a) {
  uint32_t nz = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) nz |= a.w[j];
  uint32_t mask = nz ? 0xffffffffu : 0u;
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)kP[j] - a.w[j] - borrow;
    r.w[j] = (uint32_t)s & mask;
    borrow = s >> 63;
  }
}

// r = a * b / R mod p, fully reduced. r may alias a or b.
__device__ __forceinline__ void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW];
  fp_mul_words(t, a.w, b.w);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
}

// r = a * a / R mod p: the same words as fp_mul(r, a, a), from 78 of its 144
// partial products. For code that every lane of a warp runs (the ladder of
// pow_fixed); the cooperative point operations, where the lanes of a group
// multiply different pairs, keep to fp_mul so that they run one instruction
// stream. r may alias a.
__device__ __forceinline__ void fp_sqr(Fp& r, const Fp& a) {
  uint32_t t[NW];
  fp_sqr_words(t, a.w);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
}

}  // namespace curdle
