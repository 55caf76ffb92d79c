// The Fp Montgomery product on a team of lanes: T neighbouring lanes of a
// warp (T = 2 or 4, aligned to T) compute ONE product a * b / 2^384 mod p
// together. The pointwise multiply B1 (pointwise.cu: mont_mul_kernel) runs
// on it.
//
// Why: one thread a product (fp_asm.cuh's fp_mul_words) is one chain of
// 464 dependent SASS instructions, ~0.9 us for a lone warp (NVIDIA H100
// 80GB HBM3, 700 W). The pointwise multiply's launches hold 1 to 18,432
// elements, about one warp a scheduler or fewer, so nothing hides that
// chain. Spread over T lanes an element's chain is 12 rows of K = 12 / T
// multiply-adds and three shuffles, and a launch has T times the warps.
//
// The schedule is CIOS (coarsely integrated operand scanning), as CGBN's
// "threads per instance" spreads it. Lane t holds words t*K .. t*K + K - 1
// of a, of p and of the accumulator, and one lazy carry c: the lane's
// word K, kept in 64 bits and never propagated to the next lane inside a
// row. A row i:
//   1. b_i comes to every lane by one shuffle from the lane that holds it
//      (word_lane / word_slot), or from a register when every lane holds
//      the whole of b (a broadcast operand);
//   2. each lane adds a * b_i over its K words; the carry out of its top
//      word goes into c;
//   3. q = acc_0 * (-p^-1) mod 2^32 on team lane 0, one shuffle to all;
//   4. each lane adds q * p over its K words, the carry again into c;
//   5. the accumulator moves down one word: lane t takes word 0 of lane
//      t + 1 (one shuffle) plus its own c as its new top word; c keeps the
//      carry of that sum (at most 3).
// After row 12 the lazy carries are resolved once: lane t's c goes into
// lane t + 1's word 0, and the carries that this makes are looked ahead
// across the team with two ballots (carries_in: "generates a carry",
// "passes one on"). The subtraction of p takes its borrows the same way,
// and the borrow out of the top lane says whether the sum was below p:
// one team-wide decision, no serial pass.
//
// Bounds: the team's value V = sum over lanes of (words + c * 2^(32 K))
// * 2^(32 K t) is the CIOS accumulator exactly, so V < 2p after every row
// for a, b < p (as in any Montgomery product). A multiply-add
// a_j * b_i + w_j + carry is at most 2^64 - 1 and never overflows its 64
// bits. c is at most 3 after a row, at most 3 + 2 (2^32 - 1) inside one.
// After the last row the top lane's c is 0 (V < 2^382 < 2^384) and every
// other lane's is at most 3; adding it makes at most one carry out of a
// lane, and a lane that makes one cannot also pass one on.
//
// tests/test_torch_mont_team.py runs a lane-by-lane model of team_mul over
// Python integers, with word_lane, word_slot and carries_in read from this
// file's text, against a * b / 2^384 mod p and the plain version.
#pragma once

#include <cstdint>

#include "fp.cuh"

namespace curdle {

constexpr uint32_t kTeamM0 = 0xfffcfffdu;   // -p^-1 mod 2^32

// The team lane that holds word i of an element (lane t holds words
// t * k .. t * k + k - 1), and the word's slot on that lane.
__host__ __device__ constexpr int word_lane(int i, int k) { return i / k; }
__host__ __device__ constexpr int word_slot(int i, int k) { return i % k; }

// Carry lookahead across a team: bit t of g says lane t carries out of
// its top word by itself, bit t of p that it passes an incoming carry on.
// Bit t of the result: a carry comes into lane t (bit T: out of the top).
__device__ __forceinline__ unsigned carries_in(unsigned g, unsigned p) {
  return ((g | p) + g) ^ (g | p) ^ g;
}

// Every team of a warp calls team_mul at the same time, so each shuffle
// and ballot names the whole warp (kTeamMask) and the warp issues it once:
// with one mask a team, the card ran the teams' shuffles one team after
// another (time_kernels.py --mul-team, NVIDIA H100 80GB HBM3, 700 W: 1.9
// us a launch at 1 element, 3.0 us at 8 teams a warp). A caller whose
// warp has fewer elements than teams lets the others multiply a copy and
// not store it.
constexpr unsigned kTeamMask = 0xffffffffu;

template <int T>
struct TeamLane {
  int t;           // rank in the team
  int base;        // the team's first lane in the warp
};

// 1-D blocks whose size is a multiple of 32.
template <int T>
__device__ __forceinline__ TeamLane<T> team_lane() {
  static_assert(T == 2 || T == 4, "a team is 2 or 4 lanes");
  TeamLane<T> tl;
  const int lane = threadIdx.x & 31;
  tl.t = lane & (T - 1);
  tl.base = lane - tl.t;
  return tl;
}

// The team's bits of a ballot of the warp, its lane 0 lowest.
template <int T>
__device__ __forceinline__ unsigned team_ballot(const TeamLane<T>& tl,
                                                bool v) {
  return (__ballot_sync(kTeamMask, v) >> tl.base) & ((1u << T) - 1);
}

// r = a * b / 2^384 mod p, fully reduced, for a, b below p. a, p and r are
// the lane's K words; b is the lane's K words of b (kWhole false) or all
// 12 words of it (kWhole true). Every lane of the warp calls it.
template <int T, bool kWhole>
__device__ __forceinline__ void team_mul(
    uint32_t (&r)[NW / T], const uint32_t (&a)[NW / T],
    const uint32_t (&b)[kWhole ? NW : NW / T], const uint32_t (&p)[NW / T],
    const TeamLane<T>& tl) {
  constexpr int K = NW / T;
  uint32_t w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = 0;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t bi;
    if constexpr (kWhole)
      bi = b[i];
    else
      bi = __shfl_sync(kTeamMask, b[word_slot(i, K)], word_lane(i, K), T);
    uint64_t s = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s = (uint64_t)a[j] * bi + w[j] + (s >> 32);
      w[j] = (uint32_t)s;
    }
    c += s >> 32;
    const uint32_t q = __shfl_sync(kTeamMask, w[0] * kTeamM0, 0, T);
    s = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s = (uint64_t)q * p[j] + w[j] + (s >> 32);
      w[j] = (uint32_t)s;
    }
    c += s >> 32;
    const uint32_t up = __shfl_down_sync(kTeamMask, w[0], 1, T);
    c += tl.t == T - 1 ? 0u : up;
#pragma unroll
    for (int j = 0; j + 1 < K; ++j) w[j] = w[j + 1];
    w[K - 1] = (uint32_t)c;
    c >>= 32;
  }
  // the lazy carries: lane t's c into lane t + 1's word 0
  const uint32_t cin = __shfl_up_sync(kTeamMask, (uint32_t)c, 1, T);
  uint64_t s = tl.t == 0 ? 0u : cin;
  bool ones = true;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    s += w[j];
    w[j] = (uint32_t)s;
    s >>= 32;
    ones = ones && w[j] == 0xffffffffu;
  }
  const unsigned gen = team_ballot(tl, s != 0);
  const unsigned pass = team_ballot(tl, ones);
  s = (carries_in(gen, pass) >> tl.t) & 1u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    s += w[j];
    w[j] = (uint32_t)s;
    s >>= 32;
  }
  // w - p, its borrows looked ahead the same way
  uint32_t d[K];
  uint64_t br = 0;
  bool zero = true;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint64_t v = (uint64_t)w[j] - p[j] - br;
    d[j] = (uint32_t)v;
    br = v >> 63;
    zero = zero && d[j] == 0;
  }
  const unsigned bgen = team_ballot(tl, br != 0);
  const unsigned bpass = team_ballot(tl, zero);
  const unsigned borrows = carries_in(bgen, bpass);
  br = (borrows >> tl.t) & 1u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint64_t v = (uint64_t)d[j] - br;
    d[j] = (uint32_t)v;
    br = v >> 63;
  }
  const bool below = (borrows >> T) & 1u;    // the sum is below p: keep it
#pragma unroll
  for (int j = 0; j < K; ++j) r[j] = below ? w[j] : d[j];
}

}  // namespace curdle
