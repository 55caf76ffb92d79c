// Cooperative G1 point operations: a group of 8 neighbouring lanes of one
// warp carries out ONE complete addition or doubling.
//
// Points are homogeneous projective (X : Y : Z) under the complete formulas
// of Renes-Costello-Batina 2016 (algorithms 7 and 9, a = 0, b3 = 3b = 12),
// mirroring go_curdleproofs_tpu/ops/curve.py:156-201: no branch for infinity
// or doubling, so every group runs the same schedule.
//
// Why: a complete RCB16 operation is two rounds of independent Montgomery
// products with only additions between them: 6 + 6 for an add, 4 + 4 for a
// double. One thread runs them one after another, 12 or 8 products deep,
// and a product is ~0.9 us for a lone warp (NVIDIA H100 80GB HBM3, 700 W;
// kernels.cu's header has the counts). The kernels that call these
// functions (pointwise.cu: point_add, point_double; kernels.cu:
// windowed_combine, msm_select_reduce, point_x16_add) run one operation or
// a chain of dependent operations on few points, so the depth of one
// operation sets their time. Here lane k of the group computes product k of
// a round: an operation is 2 products deep, and a lane holds one product's
// registers and not a whole formula's. The lanes of a group multiply
// different pairs, so they all call fp_mul, also where the pair is a
// square: fp_sqr in some lanes would make the warp run both instruction
// streams one after the other.
//
// Where the data lives: in shared memory, one GroupMem (864 bytes) a group.
// The accumulator, the incoming point, a round's products and the round-2
// operands are written by one lane and read by others, so they are handed
// over through shared memory with __syncwarp(mask) between the steps; a
// product's words stay in the registers of the lane that computes it.
// (Moving the elements by __shfl_sync would cost 12 shuffles an element and
// operand and save nothing that shows beside a product.) A group is aligned
// to 8 lanes, four groups a warp; an add uses 6 lanes of a round, a double 4,
// and the others wait at the hand-overs.
//
// The steps of one operation, each ended by __syncwarp(mask):
//   1. round 1: lane k forms the operands of product k (a coordinate, or
//      the sum of two) and multiplies;
//   2. the linear step: every round-2 operand feeds two products, so one
//      lane forms each operand once (6 for an add, 4 for a double); the
//      lanes follow one instruction sequence in which a lane skips what its
//      operand does not need, so that the warp does not run six different
//      formulas one after another;
//   3. round 2: lane k multiplies its pair of operands;
//   4. lanes 0..2 form X3, Y3, Z3 into the accumulator.
//
// The functions compute exactly what the plain versions point_add_plain and
// point_double_plain (go_curdleproofs_tpu_torch/ops/kernels.py) compute:
// the same formulas on fully reduced elements, so the same words come out.
// tests/test_torch_point_coop.py reads the index tables below and runs a
// lane-by-lane model of both functions against those plain versions.
#pragma once

#include "fp.cuh"

namespace curdle {

constexpr int kGroupLanes = 8;

struct GroupMem {
  Fp acc[3];   // the group's point (X, Y, Z): first operand and result
  Fp q[3];     // the incoming point of an add
  Fp prod[6];  // the products of a round
  Fp opd[6];   // the operands of round 2
};

// The lanes of the caller's group, as a __syncwarp mask (1-D blocks whose
// size is a multiple of 8).
__device__ __forceinline__ unsigned group_mask() {
  return 0xffu << (threadIdx.x & 24);
}

// Entry `lane` of a table of 3-bit indices packed 4 bits apart, lane 0 lowest.
__device__ __forceinline__ int pick(unsigned table, int lane) {
  return (table >> (4 * lane)) & 7;
}

// r = 3 * a. r may alias a.
__device__ __forceinline__ void fp_mul3(Fp& r, const Fp& a) {
  Fp t;
  fp_add(t, a, a);
  fp_add(r, t, a);
}

// Lanes 0..2 set the group's accumulator to infinity (0 : 1 : 0).
__device__ __forceinline__ void coop_set_infinity(GroupMem& m, int lane,
                                                  unsigned mask) {
  if (lane < 3) {
    if (lane == 1) fp_set_one(m.acc[1]); else fp_set_zero(m.acc[lane]);
  }
  __syncwarp(mask);
}

// m.acc = m.acc + m.q, complete (RCB16 algorithm 7, a = 0). Every lane of
// the group calls it, after a __syncwarp(mask) that follows the last write
// to m.acc and m.q; on return m.acc is visible to the whole group.
__device__ __forceinline__ void coop_add(GroupMem& m, int lane, unsigned mask) {
  // pairs (0,1), (1,2), (0,2): the coordinates behind m4, m5, m6 and the
  // products behind t3, t4, y3
  constexpr unsigned kPairA = 0x010, kPairB = 0x221;

  // round 1: t0 = x1 x2, t1 = y1 y2, t2 = z1 z2, m4 = (x1+y1)(x2+y2),
  // m5 = (y1+z1)(y2+z2), m6 = (x1+z1)(x2+z2)
  if (lane < 6) {
    const int i = lane < 3 ? lane : pick(kPairA, lane - 3);
    Fp u = m.acc[i], v = m.q[i];
    if (lane >= 3) {
      const int j = pick(kPairB, lane - 3);
      fp_add(u, u, m.acc[j]);
      fp_add(v, v, m.q[j]);
    }
    fp_mul(m.prod[lane], u, v);
  }
  __syncwarp(mask);

  // linear step, one operand a lane:
  //   0: t3 = m4 - (t0 + t1)      3: t03 = 3 t0
  //   1: t4 = m5 - (t1 + t2)      4: z3  = t1 + 12 t2
  //   2: y3b = 12 (m6 - (t0 + t2))  5: t1m = t1 - 12 t2
  if (lane < 6) {
    Fp s;
    if (lane < 3) {
      fp_add(s, m.prod[pick(kPairA, lane)], m.prod[pick(kPairB, lane)]);
      fp_sub(s, m.prod[3 + lane], s);
    } else {
      s = m.prod[lane == 3 ? 0 : 2];
    }
    if (lane >= 2) {
      fp_mul3(s, s);
      if (lane != 3) {
        fp_add(s, s, s);
        fp_add(s, s, s);  // 12 x
      }
    }
    if (lane == 4) fp_add(s, m.prod[1], s);
    if (lane == 5) fp_sub(s, m.prod[1], s);
    m.opd[lane] = s;
  }
  __syncwarp(mask);

  // round 2: n1 = t4 y3b, n2 = t3 t1m, n3 = y3b t03, n4 = t1m z3,
  // n5 = t03 t3, n6 = z3 t4 (round 1's products are no longer read)
  if (lane < 6) {
    const Fp u = m.opd[pick(0x435201, lane)];
    const Fp v = m.opd[pick(0x104352, lane)];
    fp_mul(m.prod[lane], u, v);
  }
  __syncwarp(mask);

  // X3 = n2 - n1, Y3 = n4 + n3, Z3 = n6 + n5
  if (lane < 3) {
    Fp a = m.prod[2 * lane + 1];
    const Fp b = m.prod[2 * lane];
    if (lane == 0) fp_sub(a, a, b); else fp_add(a, a, b);
    m.acc[lane] = a;
  }
  __syncwarp(mask);
}

// m.acc = 2 * m.acc, complete (RCB16 algorithm 9, a = 0). Called as coop_add.
__device__ __forceinline__ void coop_double(GroupMem& m, int lane,
                                            unsigned mask) {
  // round 1: t0 = y y -> prod[0], t1 = y z -> opd[4], zz = z z -> prod[2],
  // m4 = x y -> opd[5] (t1 and m4 are round-2 operands as they are)
  if (lane < 4) {
    const Fp u = m.acc[pick(0x0211, lane)];
    const Fp v = m.acc[pick(0x1221, lane)];
    Fp& dst = (lane & 1) ? m.opd[4 + (lane >> 1)] : m.prod[lane];
    fp_mul(dst, u, v);
  }
  __syncwarp(mask);

  // linear step, with t2 = 12 zz:
  //   0: t0m = t0 - 3 t2   1: z3s = 8 t0   2: y3s = t0 + t2   3: t2
  if (lane < 4) {
    const Fp a = m.prod[lane == 1 ? 0 : 2];
    Fp s;
    fp_add(s, a, a);
    if (lane != 1) fp_add(s, s, a);
    fp_add(s, s, s);
    fp_add(s, s, s);  // 12 zz, or 8 t0
    if (lane == 0) {
      Fp u;
      fp_mul3(u, s);
      fp_sub(s, m.prod[0], u);
    }
    if (lane == 2) fp_add(s, m.prod[0], s);
    m.opd[lane] = s;
  }
  __syncwarp(mask);

  // round 2: n1 = t0m m4, n2 = t2 z3s, n3 = t0m y3s, n4 = t1 z3s
  if (lane < 4) {
    const Fp u = m.opd[pick(0x4030, lane)];
    const Fp v = m.opd[pick(0x1215, lane)];
    fp_mul(m.prod[lane], u, v);
  }
  __syncwarp(mask);

  // X3 = 2 n1, Y3 = n2 + n3, Z3 = n4
  if (lane < 3) {
    Fp a = m.prod[lane == 2 ? 3 : lane];
    if (lane < 2) fp_add(a, a, m.prod[2 * lane]);
    m.acc[lane] = a;
  }
  __syncwarp(mask);
}

}  // namespace curdle
