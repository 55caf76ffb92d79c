// The Fiat-Shamir transcript on the card, written for Hopper (sm_90a):
// Keccak-f[1600] and the two STROBE-128 / Merlin operations the device
// prover needs, with a plain C launcher each for ctypes
// (go_curdleproofs_tpu_torch/ops/kernels.py).
//
// No TPU kernel stands behind them: the JAX package writes the permutation
// as ~30 array ops a round (go_curdleproofs_tpu/ops/keccak_dev.py:74) and
// lets XLA fuse a whole prover piece, rejection loop included
// (ops/strobe_dev.py:361-379), into one program. As separate torch ops that
// is ~700 launches a permutation, ~250 permutations a prove, and a host
// decision per squeeze attempt. Here a launch keeps the 200-byte state on
// the card from start to end and the accept/reject decision is taken
// there, so the prover never waits for the host mid-proof.
//
// There is one state and the permutations of a stream are one serial
// chain, so what bounds a launch is the latency of that chain, neither
// bytes nor the card's rate. Both kernels keep the state in one warp's
// registers from load to store: lane i < 25 holds state lane i (x + 5y) as
// two 32-bit halves, lanes 25-31 idle along, and each lane XORs the bytes
// that fall on its 8 state bytes as two words. The permutation runs on
// that warp: all 24 rounds are unrolled; a round is theta (column parity
// in three shuffles, D from two), rho (a rotation by the lane's own
// amount, funnel shifts on the halves), pi (one shuffle from the lane's
// source lane), chi (two shuffles within the row) and iota on lane 0:
// eight 64-bit shuffles. The one-thread form before it, out of shared
// memory with 63 of 64 threads waiting, took 14.3 us a permutation (NVIDIA
// H100 80GB HBM3, 700 W).
// The positions are the static-position engine's (strobe_dev.TState): the
// host knows pos / pos_begin at every point and passes them as integers.
// Every launcher enqueues on the stream it is given, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRate = 166;       // STROBE-128 rate in bytes
constexpr int kLanes = 25;       // state lanes, one a warp lane
constexpr unsigned kWarp = 0xffffffffu;

constexpr uint8_t kFlagI = 1, kFlagA = 2, kFlagC = 4, kFlagM = 16;

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

// rho: the rotation of state lane x + 5y
__constant__ int kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                             25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
// pi: state lane x + 5y takes the rotated lane (x + 3y) % 5 + 5x
__constant__ int kPiSrc[25] = {0, 6,  12, 18, 24, 3, 9,  10, 16, 22, 1,  7, 13,
                               19, 20, 4, 5, 11, 17, 23, 2, 8, 14, 15, 21};

// What a warp lane needs of the round: its source lanes and its rotation.
// Lanes 25-31 take lane 0's; nothing of theirs reaches lanes 0-24.
struct Lane {
  int lane;
  int xm1, xp1;   // the lanes that hold the column parities C[x-1], C[x+1]
  int c1, c2;     // (x+1, y) and (x+2, y) for chi
  int pi;         // the lane whose rotated value pi brings here
  bool swap;      // rho: swap the halves first (rotation >= 32) ...
  int rot;        // ... then a funnel shift by this much
};

__device__ __forceinline__ Lane lane_consts() {
  Lane l;
  l.lane = threadIdx.x & 31;
  const int i = l.lane < kLanes ? l.lane : 0;
  const int x = i % 5, y = i / 5;
  l.xm1 = (x + 4) % 5;
  l.xp1 = (x + 1) % 5;
  l.c1 = (x + 1) % 5 + 5 * y;
  l.c2 = (x + 2) % 5 + 5 * y;
  l.pi = kPiSrc[i];
  l.swap = kRho[i] >= 32;
  l.rot = kRho[i] & 31;
  return l;
}

__device__ __forceinline__ uint32_t shfl(uint32_t v, int src) {
  return __shfl_sync(kWarp, v, src);   // src >= 32 wraps: lanes 25-31 only
}

// Keccak-f[1600] on the warp: (lo, hi) is state lane `l.lane` (bytes
// 8 lane .. 8 lane + 7, little-endian). Every lane of the warp calls it.
__device__ __forceinline__ void keccak_f1600_warp(uint32_t& lo, uint32_t& hi,
                                                  const Lane& l) {
#pragma unroll
  for (int round = 0; round < 24; ++round) {
    // theta: lanes 0-4 gather the column parity C[x], every lane D[x]
    uint32_t pl = lo ^ shfl(lo, l.lane + 5), ph = hi ^ shfl(hi, l.lane + 5);
    pl ^= shfl(pl, l.lane + 10);
    ph ^= shfl(ph, l.lane + 10);
    pl ^= shfl(lo, l.lane + 20);
    ph ^= shfl(hi, l.lane + 20);
    const uint32_t ml = shfl(pl, l.xm1), mh = shfl(ph, l.xm1);
    const uint32_t nl = shfl(pl, l.xp1), nh = shfl(ph, l.xp1);
    lo ^= ml ^ __funnelshift_l(nh, nl, 1);       // C[x-1] ^ rotl(C[x+1], 1)
    hi ^= mh ^ __funnelshift_l(nl, nh, 1);
    // rho on the source lane, then pi
    const uint32_t sl = l.swap ? hi : lo, sh = l.swap ? lo : hi;
    lo = shfl(__funnelshift_l(sh, sl, l.rot), l.pi);
    hi = shfl(__funnelshift_l(sl, sh, l.rot), l.pi);
    // chi
    const uint32_t al = shfl(lo, l.c1), ah = shfl(hi, l.c1);
    const uint32_t bl = shfl(lo, l.c2), bh = shfl(hi, l.c2);
    lo ^= ~al & bl;
    hi ^= ~ah & bh;
    // iota
    if (l.lane == 0) {
      lo ^= (uint32_t)kRC[round];
      hi ^= (uint32_t)(kRC[round] >> 32);
    }
  }
}

// state byte k ^= v, on the lane that holds it
__device__ __forceinline__ void xor_byte(uint32_t& lo, uint32_t& hi,
                                         const Lane& l, int k, uint32_t v) {
  if ((k >> 3) == l.lane) {
    const int b = (k & 7) * 8;
    if (b < 32)
      lo ^= v << b;
    else
      hi ^= v << (b - 32);
  }
}

// STROBE's run_f at position `pos` of an operation that began at `pb`.
__device__ __forceinline__ void run_f(uint32_t& lo, uint32_t& hi,
                                      const Lane& l, int pos, uint32_t pb) {
  xor_byte(lo, hi, l, pos, pb);
  xor_byte(lo, hi, l, pos + 1, 0x04);
  xor_byte(lo, hi, l, kRate + 1, 0x80);
  keccak_f1600_warp(lo, hi, l);
}

// The bytes of one rate block that fall on a lane: state bytes [s0, s1)
// take src[0 ..], each byte in a register of its own until it is XORed in,
// so the loads can run during a permutation.
struct LaneBytes {
  uint32_t b[8];
};

__device__ __forceinline__ void load_block(LaneBytes& v,
                                           const uint8_t* __restrict__ src,
                                           int s0, int s1, const Lane& l) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = 8 * l.lane + j;
    v.b[j] = (k >= s0 && k < s1) ? src[k - s0] : 0u;
  }
}

__device__ __forceinline__ void xor_block(uint32_t& lo, uint32_t& hi,
                                          const LaneBytes& v) {
  lo ^= v.b[0] | v.b[1] << 8 | v.b[2] << 16 | v.b[3] << 24;
  hi ^= v.b[4] | v.b[5] << 8 | v.b[6] << 16 | v.b[7] << 24;
}

// ---------------------------------------------------------------------------
// strobe_absorb_stream: XOR an n-byte stream into the rate from `pos` on,
// running the permutation at every rate crossing with that crossing's
// pos_begin (pbs[c]); with final_f, one more permutation after the stream
// when the position is not 0 (the forced f of a PRF operation), begun at
// final_pb. The stream is the prepared byte sequence of whole Merlin
// messages (operation headers, labels, lengths, payload), so one launch
// absorbs any number of messages. One warp: lane i XORs stream bytes into
// state bytes 8i .. 8i+7 of a block as one word (lane 20's word straddles
// the rate's end at byte 166), and loads the next block's bytes and
// pos_begin before the permutation of this one.

__global__ void __launch_bounds__(32)
strobe_absorb_stream_kernel(const uint8_t* __restrict__ st_in,
                            uint8_t* __restrict__ st_out,
                            const uint8_t* __restrict__ stream, int n, int pos,
                            const uint8_t* __restrict__ pbs, int final_f,
                            int final_pb) {
  const Lane l = lane_consts();
  uint32_t lo = 0, hi = 0;
  if (l.lane < kLanes) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= (uint32_t)st_in[8 * l.lane + j] << (8 * j);
      hi |= (uint32_t)st_in[8 * l.lane + 4 + j] << (8 * j);
    }
  }
  const int crossings = (pos + n) / kRate;
  int off = 0, crossing = 0;
  int take = min(kRate - pos, n);
  LaneBytes next;
  load_block(next, stream, pos, pos + take, l);
  uint32_t pb_next = crossings > 0 ? pbs[0] : 0u;
  while (off < n) {
    xor_block(lo, hi, next);
    pos += take;
    off += take;
    if (pos == kRate) {
      const uint32_t pb = pb_next;
      ++crossing;
      pb_next = crossing < crossings ? pbs[crossing] : 0u;
      take = min(kRate, n - off);
      load_block(next, stream + off, 0, take, l);
      run_f(lo, hi, l, kRate, pb);
      pos = 0;
    }
  }
  if (final_f && pos != 0) run_f(lo, hi, l, pos, (uint32_t)final_pb);
  if (l.lane < kLanes) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st_out[8 * l.lane + j] = (uint8_t)(lo >> (8 * j));
      st_out[8 * l.lane + 4 + j] = (uint8_t)(hi >> (8 * j));
    }
  }
}

// ---------------------------------------------------------------------------
// strobe_challenge32: the transcript's get_and_append_challenge. Squeezes
// 32-byte challenges under `label` until one is below r (every attempt
// after the first re-enters at pos 32, pos_begin 0), then absorbs the
// accepted challenge back as a message under the same label.
//
// No TPU kernel stands behind it: the JAX package writes the loop as
// jax.lax.while_loop (go_curdleproofs_tpu/ops/strobe_dev.py:361-379).
// Bound: one serial chain of permutations, 1-2 an attempt (2.48 us each on
// one warp, NVIDIA H100 80GB HBM3, 700 W), and the control between them.
// The byte-serial form before this one (lane 0 wrote the state byte by
// byte in shared memory, every permutation moved the state out to the
// warp's registers and back, the challenge was compared byte by byte on
// lane 0) took 14.2 us a launch on the card at 2 attempts, of which 5-7.5
// us were permutations. The kernel is a template on the label's length:
// strobe_challenge32_kernel<false> serves labels of at most 32 bytes (every
// label of the protocol), <true> labels of any length. What the short
// design does about the rest:
//   * the state stays in registers from load to store, lane i < 25 holding
//     state lane i as (lo, hi), as in strobe_absorb_stream;
//   * an attempt's header [pb_old, M|A, label, 32, 0, 0, 0, pb, I|A|C] is
//     a byte string of label_len + 8 bytes, spread over the warp as words
//     (lane w holds bytes 4w .. 4w + 3, header_word); every lane computes
//     the positions alike, and takes the header bytes that fall on its 8
//     state bytes by three shuffles and two funnel shifts (xor_segment).
//     The first attempt's header crosses the rate at most once (it is at
//     most 40 bytes): then it goes in as two segments with a permutation
//     between, at that crossing's pos_begin. A retry starts at pos 32 and
//     pos_begin 0 and cannot cross;
//   * lanes 0-3 squeeze the challenge's 32 bytes from their words and
//     compare them big-endian with r's, 8 bytes a lane; one ballot of
//     "less" and one of "greater", and the lowest lane that differs
//     decides, alike on every lane;
//   * the accepted challenge is absorbed back at positions 40 + label_len
//     .. 71 + label_len < 166, no permutation: lanes 0-7 hold its words
//     and xor_segment moves them to the state lanes by the same shuffles;
//   * the permutation has one call site, at the end of the attempt loop's
//     body (keccak_f1600_warp is unrolled and long).
// Read on the card (time_kernels.py, NVIDIA H100 80GB HBM3, 700.00 W, from
// position 41, us a launch, old -> new): 1 attempt 7.7 -> 4.4, 2 attempts
// 11.3 -> 6.9, 3 attempts 14.7-15.6 -> 9.1-9.5: a permutation a attempt
// (~2.5 us) and ~1.9 us of launch, loads and stores. 88 registers, no
// stack (ptxas); 1,232 SASS instructions against 2,744.
// A label over 32 bytes breaks each bound above: the header of L + 8
// bytes crosses the rate floor((p + L + 8) / 166) times from position p, a
// retry's header from 32 crosses once L >= 126, and the re-absorbed
// message crosses once L >= 94. The long instantiation (challenge_long)
// keeps the state in registers and the decision on the card, and walks
// every byte string segment by segment between crossings, its header in
// chunks of 128 bytes read from the label in device memory; it is off every
// protocol path.

struct Label {
  uint32_t w[8];     // little-endian, zero past the label's length
};

// r's 32 bytes, big-endian, as four big-endian 64-bit words: a challenge
// is accepted when it is below r
__constant__ uint64_t kRWordsBE[4] = {
    0x73eda753299d7d48ull, 0x3339d80809a1d805ull, 0x53bda402fffe5bfeull,
    0xffffffff00000001ull};

__device__ __forceinline__ uint32_t label_word(const Label& label, int w) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) v = w == j ? label.w[j] : v;
  return v;
}

// Word w (bytes 4w .. 4w + 3) of an attempt's header
// [pb_old, M|A, label (len bytes), 32, 0, 0, 0, pb, flag]. `lab` is the
// label's share of the word, (label word w << 16) | (label word w-1 >> 16).
__device__ __forceinline__ uint32_t header_word(uint32_t lab, int w, int len,
                                                int pb_old, int pb,
                                                int flag) {
  uint32_t v = lab;
  if (w == 0) v |= (uint32_t)pb_old | (uint32_t)(kFlagM | kFlagA) << 8;
  const uint64_t tail =
      32u | (uint64_t)pb << 32 | (uint64_t)flag << 40;   // at byte 2 + len
  const int d = 4 * w - (2 + len);                      // tail byte of word w
  if (d > -4 && d < 6)
    v |= d >= 0 ? (uint32_t)(tail >> (8 * d)) : (uint32_t)(tail << (-8 * d));
  return v;
}

// Bytes [o, o + 8) of a byte string spread over the warp as words (lane w
// holds word w), as (lo, hi); zero where the string's lanes run out.
__device__ __forceinline__ void gather8(uint32_t word, int o, uint32_t& lo,
                                       uint32_t& hi) {
  const int q = o >> 2;               // floor, o may be negative
  const int s = (o & 3) * 8;
  uint32_t v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int src = q + k;
    const uint32_t x = shfl(word, src & 31);
    v[k] = src >= 0 && src < 32 ? x : 0u;
  }
  lo = __funnelshift_r(v[0], v[1], s);
  hi = __funnelshift_r(v[1], v[2], s);
}

// state bytes [s0, s1) ^= string bytes [h0, h0 + s1 - s0), on the lanes
// that hold them. Every lane of the warp calls it.
__device__ __forceinline__ void xor_segment(uint32_t& lo, uint32_t& hi,
                                            const Lane& l, uint32_t word,
                                            int s0, int s1, int h0) {
  uint32_t vlo, vhi;
  gather8(word, 8 * l.lane - s0 + h0, vlo, vhi);
  const int from = max(s0 - 8 * l.lane, 0), to = min(s1 - 8 * l.lane, 8);
  const uint64_t m =
      from < to ? (~0ull >> (64 - 8 * (to - from))) << (8 * from) : 0ull;
  lo ^= vlo & (uint32_t)m;
  hi ^= vhi & (uint32_t)(m >> 32);
}

// The squeeze after an attempt's last permutation: lanes 0-3 take the
// challenge's 32 bytes from their words (zeroing them in the state) and
// compare them big-endian with r's, 8 bytes a lane; one ballot of "less"
// and one of "greater", and the lowest lane that differs decides, alike on
// every lane. True when the challenge is below r.
__device__ __forceinline__ bool squeeze_below_r(uint32_t& lo, uint32_t& hi,
                                                const Lane& l, uint32_t& clo,
                                                uint32_t& chi) {
  if (l.lane < 4) {
    clo = lo;
    chi = hi;
    lo = hi = 0;
  }
  const uint64_t v =
      (uint64_t)__byte_perm(clo, 0, 0x0123) << 32 | __byte_perm(chi, 0, 0x0123);
  const uint64_t r = kRWordsBE[l.lane & 3];
  const unsigned lt = __ballot_sync(kWarp, l.lane < 4 && v < r);
  const unsigned gt = __ballot_sync(kWarp, l.lane < 4 && v > r);
  const unsigned diff = lt | gt;
  return (lt & diff & (0u - diff)) != 0;
}

// The squeezed challenge as a string of lane words: lanes 0-7 hold its
// bytes 4w .. 4w + 3, the others 0.
__device__ __forceinline__ uint32_t challenge_word(uint32_t clo, uint32_t chi,
                                                  const Lane& l) {
  const uint32_t cx = shfl(clo, (l.lane >> 1) & 3);
  const uint32_t cy = shfl(chi, (l.lane >> 1) & 3);
  return l.lane < 8 ? (l.lane & 1 ? cy : cx) : 0u;
}

// The challenge for a label of at most 32 bytes (the protocol's labels):
// the header is at most 40 bytes, one string of lane words.
__device__ __forceinline__ void challenge_short(uint32_t& lo, uint32_t& hi,
                                                const Lane& l,
                                                const Label& label, int len,
                                                int pos, int pos_begin,
                                                uint32_t& clo,
                                                uint32_t& chi) {
  const int nh = len + 8;                    // header bytes
  const uint32_t lab = label_word(label, l.lane) << 16 |
                       (l.lane > 0 ? label_word(label, l.lane - 1) >> 16 : 0u);
  // the attempt's header starts at p0 after an operation begun at pb_old;
  // h: header bytes already absorbed (the first attempt's crossing)
  int p0 = pos, pb_old = pos_begin, h = 0;
#pragma unroll 1
  while (true) {
    const int hc = kRate - p0;              // header bytes before the rate end
    const bool cross = hc <= nh;
    const bool early = cross && hc <= 6 + len;   // crossed before I|A|C
    const uint32_t word = header_word(lab, l.lane, len, pb_old,
                                      early ? 0 : p0 + 1, kFlagI | kFlagA |
                                      kFlagC);
    int s0, s1, fpos, fpb;
    if (h == 0) {                            // the header from p0
      s0 = p0;
      s1 = cross ? kRate : p0 + nh;
      fpos = s1;
      fpb = early ? p0 + 1 : p0 + 7 + len;
    } else {                                 // the rest after the crossing
      s0 = 0;
      s1 = nh - h;
      fpos = s1;
      fpb = early ? 7 + len - h : 0;
    }
    xor_segment(lo, hi, l, word, s0, s1, h);
    xor_byte(lo, hi, l, fpos, (uint32_t)fpb);
    xor_byte(lo, hi, l, fpos + 1, 0x04);
    xor_byte(lo, hi, l, kRate + 1, 0x80);
    keccak_f1600_warp(lo, hi, l);            // the one permutation
    h += s1 - s0;
    if (h < nh) continue;                    // the crossing: the rest next
    if (squeeze_below_r(lo, hi, l, clo, chi)) break;
    p0 = 32;                                 // retry from pos 32, pb 0
    pb_old = 0;
    h = 0;
  }
  // the accepted challenge back, as a message under the label: its header
  // at 32 (pos_begin 0 before, 33 for the A operation) and the challenge
  // after it
  xor_segment(lo, hi, l, header_word(lab, l.lane, len, 0, 33, kFlagA), 32,
              32 + nh, 0);
  xor_segment(lo, hi, l, challenge_word(clo, chi, l), 32 + nh, 64 + nh, 0);
}

// Byte i of a header [pb0, M|A, label (len bytes), 32, 0, 0, 0, pbq, flag]
// whose label lies in device memory; 0 past its end.
__device__ __forceinline__ uint32_t long_header_byte(
    const uint8_t* __restrict__ label, int len, int i, int pb0, int pbq,
    int flag) {
  if (i == 0) return (uint32_t)pb0;
  if (i == 1) return kFlagM | kFlagA;
  if (i < 2 + len) return __ldg(label + i - 2);
  if (i == 2 + len) return 32u;
  if (i == 6 + len) return (uint32_t)pbq;
  if (i == 7 + len) return (uint32_t)flag;
  return 0u;
}

// The challenge for a label of any length. Each of its byte strings (an
// attempt's header, and at the end the header of the accepted challenge's
// message followed by the challenge) is absorbed segment by segment: the
// first from the string's start position p0 to the rate's end or the
// string's, every later one from 0. After every segment that reaches the
// rate's end the permutation runs at that crossing's pos_begin; after an
// attempt's last segment it runs in any case (the PRF's forced one, unless
// the segment reached the rate's end). A segment's header bytes come in
// chunks of 128 (lane w holds the chunk's bytes 4w .. 4w + 3, read from the
// label in device memory) through xor_segment, which takes from a chunk
// only the bytes that lie in it; the challenge is one more string of lane
// words (lanes 0-7), after the header. Positions and pos_begin values are
// computed alike on every lane, so every branch is uniform over the warp.
__device__ __forceinline__ void challenge_long(
    uint32_t& lo, uint32_t& hi, const Lane& l,
    const uint8_t* __restrict__ label, int len, int pos, int pos_begin,
    uint32_t& clo, uint32_t& chi) {
  const int nh = len + 8;        // header bytes
  const int q = 6 + len;         // the header's byte that begins the second
                                 // operation (I|A|C, or A at the end)
  // the string starts at p0 after an operation begun at pb0; h: its bytes
  // already absorbed; accepted: the string is the accepted challenge's
  // message
  int p0 = pos, pb0 = pos_begin, h = 0;
  bool accepted = false;
  uint32_t cw = 0;               // lanes 0-7: the accepted challenge's words
#pragma unroll 1
  while (true) {
    const int n = accepted ? nh + 32 : nh;
    const int first = kRate - p0;            // string bytes before a crossing
    const bool q_first = q < first;
    const int pbq = q_first ? p0 + 1 : 0;    // pos_begin when q is absorbed
    const int pb_op = (q_first ? p0 + q : (q - first) % kRate) + 1;
    const int flag = accepted ? kFlagA : kFlagI | kFlagA | kFlagC;
    const int s0 = h == 0 ? p0 : 0;
    const int take = min(kRate - s0, n - h);
    const int s1 = s0 + take;
    const int hend = min(h + take, nh);
#pragma unroll 1
    for (int c = h >> 7; 128 * c < hend; ++c) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= long_header_byte(label, len, 128 * c + 4 * l.lane + j, pb0,
                                 pbq, flag) << (8 * j);
      xor_segment(lo, hi, l, word, s0, s1, h - 128 * c);
    }
    if (h + take > nh) xor_segment(lo, hi, l, cw, s0, s1, h - nh);
    const int fpb = h + take - 1 < q ? (h == 0 ? p0 + 1 : 0)
                                     : (h <= q ? pb_op : 0);
    h += take;
    if (s1 == kRate || !accepted) {
      xor_byte(lo, hi, l, s1, (uint32_t)fpb);
      xor_byte(lo, hi, l, s1 + 1, 0x04);
      xor_byte(lo, hi, l, kRate + 1, 0x80);
      keccak_f1600_warp(lo, hi, l);          // the one permutation
    }
    if (h < n) continue;                     // a crossing: the rest next
    if (accepted) break;
    if (squeeze_below_r(lo, hi, l, clo, chi)) {
      accepted = true;
      cw = challenge_word(clo, chi, l);
    }
    p0 = 32;                                 // next string from pos 32, pb 0
    pb0 = 0;
    h = 0;
  }
}

// kLong: labels of any length, read from `label_dev`; otherwise at most 32
// bytes, passed by value in `label`.
template <bool kLong>
__global__ void __launch_bounds__(32)
strobe_challenge32_kernel(const uint8_t* __restrict__ st_in,
                          uint8_t* __restrict__ st_out,
                          uint8_t* __restrict__ chal_out, Label label,
                          const uint8_t* __restrict__ label_dev,
                          int label_len, int pos, int pos_begin) {
  const Lane l = lane_consts();
  uint32_t lo = 0, hi = 0;
  if (l.lane < kLanes) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= (uint32_t)st_in[8 * l.lane + j] << (8 * j);
      hi |= (uint32_t)st_in[8 * l.lane + 4 + j] << (8 * j);
    }
  }
  uint32_t clo = 0, chi = 0;       // lanes 0-3: the squeezed challenge
  if constexpr (kLong)
    challenge_long(lo, hi, l, label_dev, label_len, pos, pos_begin, clo, chi);
  else
    challenge_short(lo, hi, l, label, label_len, pos, pos_begin, clo, chi);
  if (l.lane < kLanes) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      st_out[8 * l.lane + j] = (uint8_t)(lo >> (8 * j));
      st_out[8 * l.lane + 4 + j] = (uint8_t)(hi >> (8 * j));
    }
  }
  if (l.lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      chal_out[8 * l.lane + j] = (uint8_t)(clo >> (8 * j));
      chal_out[8 * l.lane + 4 + j] = (uint8_t)(chi >> (8 * j));
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers (ctypes). Pointers are device pointers except `label`, which
// points to label_len host bytes; `stream` is a cudaStream_t. A label of at
// most 32 bytes goes to the kernel by value; a longer one is read from
// `label_dev`, its label_len bytes in device memory.

extern "C" {

int curdle_strobe_absorb_stream(const void* st_in, void* st_out,
                                const void* bytes, int n, int pos,
                                const void* pbs, int final_f, int final_pb,
                                void* stream) {
  strobe_absorb_stream_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)st_in, (uint8_t*)st_out, (const uint8_t*)bytes, n, pos,
      (const uint8_t*)pbs, final_f, final_pb);
  return (int)cudaGetLastError();
}

int curdle_strobe_challenge32(const void* st_in, void* st_out, void* chal_out,
                              const uint8_t* label, const void* label_dev,
                              int label_len, int pos, int pos_begin,
                              void* stream) {
  if (label_len < 0) return (int)cudaErrorInvalidValue;
  if (label_len > 32) {
    if (label_dev == nullptr) return (int)cudaErrorInvalidValue;
    strobe_challenge32_kernel<true><<<1, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)st_in, (uint8_t*)st_out, (uint8_t*)chal_out, Label{},
        (const uint8_t*)label_dev, label_len, pos, pos_begin);
    return (int)cudaGetLastError();
  }
  Label l;
  for (int j = 0; j < 8; ++j) {
    l.w[j] = 0;
    for (int k = 0; k < 4; ++k)
      if (4 * j + k < label_len)
        l.w[j] |= (uint32_t)label[4 * j + k] << (8 * k);
  }
  strobe_challenge32_kernel<false><<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)st_in, (uint8_t*)st_out, (uint8_t*)chal_out, l, nullptr,
      label_len, pos, pos_begin);
  return (int)cudaGetLastError();
}

}  // extern "C"
