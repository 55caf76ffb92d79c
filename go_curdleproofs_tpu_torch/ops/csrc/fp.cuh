// BLS12-381 base field Fp and G1 point formulas as CUDA device functions.
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
// the kernels give the words of the plain torch versions. Points are
// homogeneous projective (X : Y : Z) under the complete formulas of
// Renes-Costello-Batina 2016 (algorithms 7 and 9, a = 0, b3 = 3b = 12),
// mirroring go_curdleproofs_tpu/ops/curve.py:156-201: no branch for infinity
// or doubling, so every thread runs the same schedule.
#pragma once

#include <cstdint>

#include "fp_asm.cuh"

namespace curdle {

constexpr int NW = 12;

struct Fp {
  uint32_t w[NW];
};

struct Point {
  Fp x, y, z;
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

// r = 12 * a (the integer 12, as curve.py's mul_small(., B3)).
__device__ __forceinline__ void fp_mul12(Fp& r, const Fp& a) {
  Fp t;
  fp_add(t, a, a);  // 2a
  fp_add(t, t, a);  // 3a
  fp_add(t, t, t);  // 6a
  fp_add(r, t, t);  // 12a
}

__device__ __forceinline__ void point_set_infinity(Point& r) {
  fp_set_zero(r.x);
  fp_set_one(r.y);
  fp_set_zero(r.z);
}

// Complete addition, RCB16 algorithm 7 (a = 0), in curve.py's two stages.
// Not inlined: one copy serves every call site and keeps compile time short.
__device__ __noinline__ void point_add(Point& r, const Point& p, const Point& q) {
  Fp t0, t1, t2, m4, m5, m6, u, v;
  fp_mul(t0, p.x, q.x);
  fp_mul(t1, p.y, q.y);
  fp_mul(t2, p.z, q.z);
  fp_add(u, p.x, p.y);
  fp_add(v, q.x, q.y);
  fp_mul(m4, u, v);
  fp_add(u, p.y, p.z);
  fp_add(v, q.y, q.z);
  fp_mul(m5, u, v);
  fp_add(u, p.x, p.z);
  fp_add(v, q.x, q.z);
  fp_mul(m6, u, v);

  Fp t3, t4, y3, t03, t2b, z3, t1m, y3b;
  fp_add(u, t0, t1);
  fp_sub(t3, m4, u);
  fp_add(u, t1, t2);
  fp_sub(t4, m5, u);
  fp_add(u, t0, t2);
  fp_sub(y3, m6, u);
  fp_add(t03, t0, t0);
  fp_add(t03, t03, t0);
  fp_mul12(t2b, t2);
  fp_add(z3, t1, t2b);
  fp_sub(t1m, t1, t2b);
  fp_mul12(y3b, y3);

  Fp n1, n2;
  fp_mul(n1, t4, y3b);
  fp_mul(n2, t3, t1m);
  fp_sub(r.x, n2, n1);
  fp_mul(n1, y3b, t03);
  fp_mul(n2, t1m, z3);
  fp_add(r.y, n2, n1);
  fp_mul(n1, t03, t3);
  fp_mul(n2, z3, t4);
  fp_add(r.z, n2, n1);
}

// Complete doubling, RCB16 algorithm 9 (a = 0).
__device__ __noinline__ void point_double(Point& r, const Point& p) {
  Fp t0, t1, t2, m4, u;
  fp_mul(t0, p.y, p.y);
  fp_mul(t1, p.y, p.z);
  fp_mul(u, p.z, p.z);
  fp_mul12(t2, u);
  fp_mul(m4, p.x, p.y);

  Fp z3s, y3s, t0m;
  fp_add(z3s, t0, t0);
  fp_add(z3s, z3s, z3s);
  fp_add(z3s, z3s, z3s);  // 8 t0
  fp_add(y3s, t0, t2);
  fp_add(u, t2, t2);
  fp_add(u, u, t2);
  fp_sub(t0m, t0, u);     // t0 - 3 t2

  Fp n1, n2;
  fp_mul(n1, t0m, m4);
  fp_add(r.x, n1, n1);
  fp_mul(n1, t2, z3s);
  fp_mul(n2, t0m, y3s);
  fp_add(r.y, n1, n2);
  fp_mul(r.z, t1, z3s);
}

}  // namespace curdle
