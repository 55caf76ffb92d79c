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
// decision per squeeze attempt. Here the 200-byte state sits in shared
// memory for a whole launch and the accept/reject decision is taken on the
// card, so the prover never waits for the host mid-proof.
//
// There is one state and the permutation is a serial chain, so one thread
// runs it (64-bit lanes); the byte XORs of an absorb run on the whole block.
// The positions are the static-position engine's (strobe_dev.TState): the
// host knows pos / pos_begin at every point and passes them as integers.
// Every launcher enqueues on the stream it is given, allocates nothing, and
// returns cudaGetLastError(). Bound: neither bytes nor the card's rate: the
// latency of one thread's 24-round chain per rate block.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRate = 166;       // STROBE-128 rate in bytes
constexpr int kStateBytes = 200;
constexpr int kAbsorbThreads = 64;

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

// rho rotations and pi destinations along the lane cycle that starts at 1
__constant__ int kRotc[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                              27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
__constant__ int kPiln[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                              15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};

// r, big-endian: a challenge is accepted when it is below r
__constant__ uint8_t kRBytesBE[32] = {
    0x73, 0xed, 0xa7, 0x53, 0x29, 0x9d, 0x7d, 0x48, 0x33, 0x39, 0xd8,
    0x08, 0x09, 0xa1, 0xd8, 0x05, 0x53, 0xbd, 0xa4, 0x02, 0xff, 0xfe,
    0x5b, 0xfe, 0xff, 0xff, 0xff, 0xff, 0x00, 0x00, 0x00, 0x01};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));   // 1 <= n <= 63
}

// Keccak-f[1600] on 25 little-endian lanes (lane x + 5y), in place.
__device__ void keccak_f1600(uint64_t* a) {
  uint64_t bc[5];
  for (int round = 0; round < 24; ++round) {
    // theta
#pragma unroll
    for (int i = 0; i < 5; ++i)
      bc[i] = a[i] ^ a[i + 5] ^ a[i + 10] ^ a[i + 15] ^ a[i + 20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
#pragma unroll
      for (int j = 0; j < 25; j += 5) a[j + i] ^= t;
    }
    // rho and pi
    uint64_t t = a[1];
    for (int i = 0; i < 24; ++i) {
      const int j = kPiln[i];
      const uint64_t keep = a[j];
      a[j] = rotl64(t, kRotc[i]);
      t = keep;
    }
    // chi
#pragma unroll
    for (int j = 0; j < 25; j += 5) {
#pragma unroll
      for (int i = 0; i < 5; ++i) bc[i] = a[j + i];
#pragma unroll
      for (int i = 0; i < 5; ++i)
        a[j + i] ^= (~bc[(i + 1) % 5]) & bc[(i + 2) % 5];
    }
    // iota
    a[0] ^= kRC[round];
  }
}

// STROBE's run_f at position `pos` of an operation that began at `pb`.
__device__ void run_f(uint64_t* a, int pos, int pb) {
  uint8_t* st = reinterpret_cast<uint8_t*>(a);
  st[pos] ^= (uint8_t)pb;
  st[pos + 1] ^= 0x04;
  st[kRate + 1] ^= 0x80;
  keccak_f1600(a);
}

// ---------------------------------------------------------------------------
// strobe_absorb_stream: XOR an n-byte stream into the rate from `pos` on,
// running the permutation at every rate crossing with that crossing's
// pos_begin (pbs[c]); with final_f, one more permutation after the stream
// when the position is not 0 (the forced f of a PRF operation), begun at
// final_pb. The stream is the prepared byte sequence of whole Merlin
// messages (operation headers, labels, lengths, payload), so one launch
// absorbs any number of messages.

__global__ void __launch_bounds__(kAbsorbThreads)
strobe_absorb_stream_kernel(const uint8_t* __restrict__ st_in,
                            uint8_t* __restrict__ st_out,
                            const uint8_t* __restrict__ stream, int n, int pos,
                            const uint8_t* __restrict__ pbs, int final_f,
                            int final_pb) {
  __shared__ uint64_t a[25];
  uint8_t* st = reinterpret_cast<uint8_t*>(a);
  const int tid = threadIdx.x;
  for (int i = tid; i < kStateBytes; i += kAbsorbThreads) st[i] = st_in[i];
  __syncthreads();
  int off = 0, crossing = 0;
  while (off < n) {
    const int take = min(kRate - pos, n - off);
    for (int i = tid; i < take; i += kAbsorbThreads)
      st[pos + i] ^= stream[off + i];
    __syncthreads();
    pos += take;
    off += take;
    if (pos == kRate) {
      if (tid == 0) run_f(a, kRate, pbs[crossing]);
      ++crossing;
      pos = 0;
      __syncthreads();
    }
  }
  if (final_f && pos != 0) {
    if (tid == 0) run_f(a, pos, final_pb);
    __syncthreads();
  }
  for (int i = tid; i < kStateBytes; i += kAbsorbThreads) st_out[i] = st[i];
}

// ---------------------------------------------------------------------------
// strobe_challenge32: the transcript's get_and_append_challenge. Squeezes
// 32-byte challenges under `label` until one is below r (every attempt
// after the first re-enters at pos 32, pos_begin 0), then absorbs the
// accepted challenge back as a message under the same label. One thread:
// ~100 bytes and one or two permutations an attempt.

struct Label {
  uint8_t b[32];
};

struct Strobe {
  uint64_t* a;
  int pos, pb;
};

__device__ void absorb_byte(Strobe& s, uint8_t v) {
  reinterpret_cast<uint8_t*>(s.a)[s.pos++] ^= v;
  if (s.pos == kRate) {
    run_f(s.a, s.pos, s.pb);
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
    run_f(s.a, s.pos, s.pb);
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

__global__ void strobe_challenge32_kernel(const uint8_t* __restrict__ st_in,
                                          uint8_t* __restrict__ st_out,
                                          uint8_t* __restrict__ chal_out,
                                          Label label, int label_len, int pos,
                                          int pos_begin) {
  __shared__ uint64_t a[25];
  uint8_t* st = reinterpret_cast<uint8_t*>(a);
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  for (int i = 0; i < kStateBytes; ++i) st[i] = st_in[i];
  Strobe s{a, pos, pos_begin};
  uint8_t chal[32];
  bool below;
  do {
    merlin_header32(s, label, label_len);
    begin_op(s, kFlagI | kFlagA | kFlagC, true);
    for (int i = 0; i < 32; ++i) {
      chal[i] = st[s.pos];
      st[s.pos++] = 0;
      if (s.pos == kRate) {
        run_f(s.a, s.pos, s.pb);
        s.pos = 0;
        s.pb = 0;
      }
    }
    below = false;
    for (int i = 0; i < 32; ++i) {
      if (chal[i] != kRBytesBE[i]) {
        below = chal[i] < kRBytesBE[i];
        break;
      }
    }
  } while (!below);
  merlin_header32(s, label, label_len);
  begin_op(s, kFlagA, false);
  for (int i = 0; i < 32; ++i) absorb_byte(s, chal[i]);
  for (int i = 0; i < kStateBytes; ++i) st_out[i] = st[i];
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
  strobe_absorb_stream_kernel<<<1, kAbsorbThreads, 0, (cudaStream_t)stream>>>(
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
