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
// bytes nor the card's rate. The permutation runs on one warp, in
// registers: lane i < 25 holds state lane i (x + 5y) as two 32-bit halves,
// lanes 25-31 idle along. All 24 rounds are unrolled; a round is theta
// (column parity in three shuffles, D from two), rho (a rotation by the
// lane's own amount, funnel shifts on the halves), pi (one shuffle from the
// lane's source lane), chi (two shuffles within the row) and iota on lane
// 0: eight 64-bit shuffles. The one-thread form before it, out of shared
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
constexpr int kStateBytes = 200;
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

// r, big-endian: a challenge is accepted when it is below r
__constant__ uint8_t kRBytesBE[32] = {
    0x73, 0xed, 0xa7, 0x53, 0x29, 0x9d, 0x7d, 0x48, 0x33, 0x39, 0xd8,
    0x08, 0x09, 0xa1, 0xd8, 0x05, 0x53, 0xbd, 0xa4, 0x02, 0xff, 0xfe,
    0x5b, 0xfe, 0xff, 0xff, 0xff, 0xff, 0x00, 0x00, 0x00, 0x01};

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
// accepted challenge back as a message under the same label: ~100 bytes
// and one or two permutations an attempt. The byte-serial control runs on
// every lane alike (positions are the same on all), lane 0 alone writes
// the state's bytes in shared memory and decides, and each run_f hands the
// state to the warp's permutation and back.

struct Label {
  uint8_t b[32];
};

struct Strobe {
  uint8_t* st;    // the state, in shared memory
  int pos, pb;
  Lane l;
};

// Not inlined: the unrolled permutation is long, and absorb_byte, begin_op
// and the squeeze loop would each hold a copy of it.
__device__ __noinline__ void run_f_shared(Strobe& s, int pos, int pb) {
  if (s.l.lane == 0) {
    s.st[pos] ^= (uint8_t)pb;
    s.st[pos + 1] ^= 0x04;
    s.st[kRate + 1] ^= 0x80;
  }
  __syncwarp();
  uint32_t* w = reinterpret_cast<uint32_t*>(s.st);
  uint32_t lo = 0, hi = 0;
  if (s.l.lane < kLanes) {
    lo = w[2 * s.l.lane];
    hi = w[2 * s.l.lane + 1];
  }
  keccak_f1600_warp(lo, hi, s.l);
  if (s.l.lane < kLanes) {
    w[2 * s.l.lane] = lo;
    w[2 * s.l.lane + 1] = hi;
  }
  __syncwarp();
}

__device__ void absorb_byte(Strobe& s, uint8_t v) {
  if (s.l.lane == 0) s.st[s.pos] ^= v;
  if (++s.pos == kRate) {
    run_f_shared(s, s.pos, s.pb);
    s.pos = 0;
    s.pb = 0;
  }
}

__device__ void begin_op(Strobe& s, uint8_t flags, bool force_f) {
  const int old = s.pb;
  s.pb = s.pos + 1;
  absorb_byte(s, (uint8_t)old);
  absorb_byte(s, flags);
  if (force_f && s.pos != 0) {
    run_f_shared(s, s.pos, s.pb);
    s.pos = 0;
    s.pb = 0;
  }
}

// meta-AD(label), meta-AD(u32le(32), more): the header of a 32-byte message
// or of a 32-byte challenge.
__device__ void merlin_header32(Strobe& s, const Label& label, int label_len) {
  begin_op(s, kFlagM | kFlagA, false);
  for (int i = 0; i < label_len; ++i) absorb_byte(s, label.b[i]);
  absorb_byte(s, 32);
  absorb_byte(s, 0);
  absorb_byte(s, 0);
  absorb_byte(s, 0);
}

__global__ void __launch_bounds__(32)
strobe_challenge32_kernel(const uint8_t* __restrict__ st_in,
                          uint8_t* __restrict__ st_out,
                          uint8_t* __restrict__ chal_out, Label label,
                          int label_len, int pos, int pos_begin) {
  __shared__ uint64_t a[kLanes];
  uint8_t* st = reinterpret_cast<uint8_t*>(a);
  Strobe s{st, pos, pos_begin, lane_consts()};
  const bool lead = s.l.lane == 0;
  for (int i = s.l.lane; i < kStateBytes; i += 32) st[i] = st_in[i];
  __syncwarp();
  uint8_t chal[32] = {};      // lane 0's is the challenge
  bool below;
  do {
    merlin_header32(s, label, label_len);
    begin_op(s, kFlagI | kFlagA | kFlagC, true);
    for (int i = 0; i < 32; ++i) {
      if (lead) {
        chal[i] = st[s.pos];
        st[s.pos] = 0;
      }
      if (++s.pos == kRate) {
        run_f_shared(s, s.pos, s.pb);
        s.pos = 0;
        s.pb = 0;
      }
    }
    below = false;
    if (lead) {
      for (int i = 0; i < 32; ++i) {
        if (chal[i] != kRBytesBE[i]) {
          below = chal[i] < kRBytesBE[i];
          break;
        }
      }
    }
    below = __shfl_sync(kWarp, below, 0);
  } while (!below);
  merlin_header32(s, label, label_len);
  begin_op(s, kFlagA, false);
  for (int i = 0; i < 32; ++i) absorb_byte(s, chal[i]);
  __syncwarp();
  for (int i = s.l.lane; i < kStateBytes; i += 32) st_out[i] = st[i];
  if (lead)
    for (int i = 0; i < 32; ++i) chal_out[i] = chal[i];
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers (ctypes). Pointers are device pointers except `label`, which
// points to label_len (<= 32) host bytes; `stream` is a cudaStream_t.

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
                              const uint8_t* label, int label_len, int pos,
                              int pos_begin, void* stream) {
  if (label_len < 0 || label_len > 32) return (int)cudaErrorInvalidValue;
  Label l;
  for (int i = 0; i < 32; ++i) l.b[i] = i < label_len ? label[i] : 0;
  strobe_challenge32_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)st_in, (uint8_t*)st_out, (uint8_t*)chal_out, l,
      label_len, pos, pos_begin);
  return (int)cudaGetLastError();
}

}  // extern "C"
