// The pointwise kernels, written for Hopper (sm_90a): batched Fp multiply,
// complete point add, complete point double, and the scalar field's batched
// multiply and fixed-exponent ladder (fr.cuh on fr_asm.cuh), with a plain C
// launcher each for ctypes (go_curdleproofs_tpu_torch/ops/kernels.py). The
// Fp multiply runs on the team product of fp_team.cuh; the point add and
// double run on the cooperative point operations of point_coop.cuh, as the
// fused 16*acc + sel step in kernels.cu does.
//
// Every launcher enqueues on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so that a refused launch reaches the caller.
// Elements are the port's: 12 int32 words each (read here as uint32,
// fp.cuh), contiguous, any batch size, no padding to a block. A multiply
// takes one element a team of MUL_TEAM lanes (a thread above MUL_TEAM_MAX
// elements), an Fr multiply one element a thread, a point operation one
// point an 8-lane group; all stride over the batch by the grid. Outputs never
// alias inputs (the wrapper allocates them); the two inputs of a multiply
// or an add may be the same array (P + P, a * a).
//
// What bounds them on an H100: operations in name. One Montgomery product is
// 2*144 32x32->64 multiply-adds over 144 bytes moved (two elements in, one
// out), ~2 multiply-adds per byte against a card balance of ~5 per byte
// (16.7e12 multiply-adds/s, 3.35e12 bytes/s), so a lone multiply sits under
// the memory line and an add (12 products over 432 bytes) above it. At the
// verifier's and prover's batch sizes (1 to a few thousand elements) neither
// line is near: what a launch takes on the card is its longest chain of
// dependent products and the launch itself.

#include <cuda_runtime.h>

#include "fp.cuh"
#include "fp_team.cuh"
#include "fr.cuh"
#include "point_coop.cuh"

using curdle::Fp;
using curdle::Fr;
using curdle::GroupMem;
using curdle::kGroupLanes;

namespace {

constexpr int kMulThreads = 32;    // fr_mont_mul: one warp a block
constexpr int kMaxBlocks = 132 * 16;   // grid-stride beyond this many blocks

// ---------------------------------------------------------------------------
// mont_mul: out[i] = a[i * a_stride] * b[i * b_stride] / R mod p.
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:mont_mul (the batched
// Montgomery product over 74 RNS channels, rows padded to a block). A stride
// is 1 (one operand element per output) or 0 (one element broadcast over the
// batch: the GLV beta multiply of a whole x plane, the multiply by plain 1
// that leaves Montgomery form), so a broadcast is never materialised.
// Bound: bytes (2 * 144 multiply-adds over 144 bytes an element), but a
// launch on the paths holds 1 to 18,432 elements (a histogram on the
// card: a device prove's 145 launches are 1 to 18 elements but for
// 16 of 108 to 3,456; a verify's 1,024 and 9,216; a host prove's 256 to
// 3,456), a warp or a few warps: one element's chain of dependent
// instructions, its loads and the launch set the time. One thread an
// element in blocks of 128 (fp_mul_words, 464 SASS instructions in one
// chain, ~0.9 us for a lone warp; 12 loads at a 48-byte stride that touch
// 32 sectors each) took 2.2-3.3 us a launch on the card (NVIDIA H100 80GB
// HBM3, 700.00 W). What the design does about it:
//   * a team of MUL_TEAM neighbouring lanes an element on fp_team.cuh's
//     team_mul: 12 rows of 12 / MUL_TEAM multiply-adds and three shuffles
//     deep, and MUL_TEAM times the warps a launch;
//   * a team reads and writes its element's 48 bytes together, lane t words
//     t*K .. t*K + K - 1, so a warp touches 32 / MUL_TEAM neighbouring
//     elements; a broadcast operand is always b (the launcher swaps the
//     operands of a commutative product) and every lane holds all of it
//     from one read before the loop, so its words need no shuffle;
//   * a warp steps over 32 / MUL_TEAM elements at a time and strides on by
//     the grid as a whole (beyond kMaxBlocks blocks), so team_mul's
//     warp-wide shuffles and ballots always find every lane; a team past
//     the batch multiplies a copy of the last element and stores nothing.
//     Indices are 64-bit;
//   * blocks of one warp (MUL_THREADS): a block's warps share one SM, and
//     the loads of four warps on one SM cost one thread an element 0.7-1.1
//     us a launch at 108 elements and more;
//   * above MUL_TEAM_MAX elements one thread an element runs (T = 1, the
//     same loop as before), which issues a quarter of the team's
//     instructions (456 SASS instructions against 1,016-1,032 a lane).
// The readings behind these sizes (time_kernels.py --mul-team, every form
// built at every batch, lanes x threads a block, us a launch on the card,
// NVIDIA H100 80GB HBM3, 700.00 W, the second of two runs in one call):
// at 1 to 3,456 elements times one element 1 x 32: 2.1-2.2, 1 x 128:
// 2.2-3.3, 2 x 32: 2.3-2.4, 4 x 32: 1.9-2.2, 4 x 128: 2.1; at 9,216
// elements all 2.7-2.9 but 1 x 128 (3.5); at [9, 1, 2048] 1 x 32: 3.2,
// 4 x 32: 3.8, 4 x 128: 3.6; 65,536 pairs 1 x 32: 7.7, 4 x 32: 8.1. So 4
// lanes an element up to 4,096 elements, one thread above, blocks of 32.
// time_kernels.py --mul-team builds the other forms (-DMUL_TEAM=,
// -DMUL_THREADS=, -DMUL_TEAM_MAX=).

#ifndef MUL_TEAM
#define MUL_TEAM 4
#endif
#ifndef MUL_TEAM_MAX
#define MUL_TEAM_MAX 4096
#endif
#ifndef MUL_THREADS
#define MUL_THREADS 32
#endif
static_assert(MUL_TEAM == 1 || MUL_TEAM == 2 || MUL_TEAM == 4,
              "a team is 1, 2 or 4 lanes");
constexpr int kTeamThreads = MUL_THREADS;
static_assert(kTeamThreads % 32 == 0, "whole warps a block");

template <int T, bool kWhole>
__global__ void __launch_bounds__(kTeamThreads)
mont_mul_kernel(const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                long long n, int a_stride) {
  constexpr int NW = curdle::NW;
  if constexpr (T == 1) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
      const Fp x = reinterpret_cast<const Fp*>(a)[i * a_stride];
      const Fp y = reinterpret_cast<const Fp*>(b)[kWhole ? 0 : i];
      Fp r;
      curdle::fp_mul(r, x, y);
      reinterpret_cast<Fp*>(out)[i] = r;
    }
  } else {
    constexpr int K = NW / T;
    const curdle::TeamLane<T> tl = curdle::team_lane<T>();
    uint32_t p[K];
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = curdle::kP[tl.t * K + j];
    uint32_t y[kWhole ? NW : K];
    if constexpr (kWhole) {
#pragma unroll
      for (int j = 0; j < NW; ++j) y[j] = b[j];
    }
    // a warp takes 32 / T neighbouring elements a step and strides on by
    // the grid as a whole, so its lanes run every step together
    constexpr int kPerWarp = 32 / T;
    const long long warp =
        ((long long)blockIdx.x * kTeamThreads + threadIdx.x) / 32;
    const long long stride = (long long)gridDim.x * (kTeamThreads / 32);
    for (long long base = warp * kPerWarp; base < n;
         base += stride * kPerWarp) {
      const long long i = base + (threadIdx.x & 31) / T;
      const long long ic = i < n ? i : n - 1;   // a team past n: a copy
      const uint32_t* ai = a + ic * a_stride * NW + tl.t * K;
      uint32_t x[K];
#pragma unroll
      for (int j = 0; j < K; ++j) x[j] = ai[j];
      if constexpr (!kWhole) {
#pragma unroll
        for (int j = 0; j < K; ++j) y[j] = b[ic * NW + tl.t * K + j];
      }
      uint32_t r[K];
      curdle::team_mul<T, kWhole>(r, x, y, p, tl);
      if (i < n) {
        uint32_t* o = out + i * NW + tl.t * K;
#pragma unroll
        for (int j = 0; j < K; ++j) o[j] = r[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// point_add: (ox, oy, oz)[i] = P[i] + Q[i], complete (RCB16 algorithm 7);
// point_double: (ox, oy, oz)[i] = 2 * P[i], complete (RCB16 algorithm 9).
//
// Replace go_curdleproofs_tpu/ops/rns_kernels.py:point_add and point_double:
// the same 12 and 8 field products (b3 = 12 is additions), the same answer
// for infinity + P, P + P and P + (-P), no branch. Their callers are the
// table builds of every MSM ([4, 1, 1024] adds and [1024] doubles in the
// verifier and the host prover), the final MSM's window sums, and the
// device prover's single-point and few-point sums (1 to 24 points).
// Bound: operations in name (12 products over 432 bytes a point), but at 1
// to 4,096 points neither the card's multiply rate nor its memory is near:
// one operation's chain of dependent products is. A thread a point runs 12
// (8) products one after another at ~0.9 us each for a lone warp, with the
// whole formula in 188 (146) registers and a 432 (288) byte stack:
// 13.7-14.7 (9.5-9.9) us a launch on the card. What the design does about
// it:
//   * one 8-lane group a point on point_coop.cuh's coop_add / coop_double:
//     lanes 0..2 load P's coordinates (and Q's) into the group's GroupMem in
//     shared memory, the group runs one operation two products deep, lanes
//     0..2 store X3, Y3, Z3. A lane holds one product's registers; nothing
//     is compiled as a function with a stack frame;
//   * a block is POINT_THREADS threads (POINT_THREADS / 8 points); the
//     grid covers the batch up to kMaxBlocks blocks and a whole group
//     strides on by the grid beyond that, so every lane of a group is in
//     the loop or out of it together and each __syncwarp(mask) names live
//     lanes only. Indices are 64-bit.
// POINT_THREADS: one warp a block, as point_x16_add and pow_fixed have.
// time_kernels.py --point-threads built this file at 32, 64 and 128 and
// timed both kernels on the card at the paths' shapes, twice in one call
// (NVIDIA H100 80GB HBM3, 700 W): at 1 to 1,025 points the three were
// within 0.5 us of each other (an add 4.3-4.8 us a launch, a double
// 3.9-4.2 us); at [4, 1, 1024] 32 threads read 6.2 us both times, 64 and
// 128 6.1-6.8. The one-warp block stays: no size was faster by more than
// the noise. The add takes 68 registers, the double 60, no stack (ptxas):
// 4.3-6.2 and 3.9-4.2 us a launch on the card.

#ifndef POINT_THREADS
#define POINT_THREADS 32
#endif
constexpr int kPointThreads = POINT_THREADS;
constexpr int kPointGroups = kPointThreads / kGroupLanes;
static_assert(kPointThreads % 32 == 0, "whole warps a block");

__global__ void __launch_bounds__(kPointThreads)
point_add_kernel(const Fp* __restrict__ px, const Fp* __restrict__ py,
                 const Fp* __restrict__ pz, const Fp* __restrict__ qx,
                 const Fp* __restrict__ qy, const Fp* __restrict__ qz,
                 Fp* __restrict__ ox, Fp* __restrict__ oy, Fp* __restrict__ oz,
                 long long n) {
  __shared__ GroupMem mem[kPointGroups];
  const int lane = threadIdx.x % kGroupLanes;
  const int group = threadIdx.x / kGroupLanes;
  const unsigned mask = curdle::group_mask();
  GroupMem& m = mem[group];
  const Fp* p = lane == 0 ? px : lane == 1 ? py : pz;
  const Fp* q = lane == 0 ? qx : lane == 1 ? qy : qz;
  Fp* out = lane == 0 ? ox : lane == 1 ? oy : oz;
  const long long step = (long long)gridDim.x * kPointGroups;
  for (long long i = (long long)blockIdx.x * kPointGroups + group; i < n;
       i += step) {
    if (lane < 3) {
      m.acc[lane] = p[i];
      m.q[lane] = q[i];
    }
    __syncwarp(mask);
    curdle::coop_add(m, lane, mask);
    if (lane < 3) out[i] = m.acc[lane];
  }
}

__global__ void __launch_bounds__(kPointThreads)
point_double_kernel(const Fp* __restrict__ px, const Fp* __restrict__ py,
                    const Fp* __restrict__ pz, Fp* __restrict__ ox,
                    Fp* __restrict__ oy, Fp* __restrict__ oz, long long n) {
  __shared__ GroupMem mem[kPointGroups];
  const int lane = threadIdx.x % kGroupLanes;
  const int group = threadIdx.x / kGroupLanes;
  const unsigned mask = curdle::group_mask();
  GroupMem& m = mem[group];
  const Fp* p = lane == 0 ? px : lane == 1 ? py : pz;
  Fp* out = lane == 0 ? ox : lane == 1 ? oy : oz;
  const long long step = (long long)gridDim.x * kPointGroups;
  for (long long i = (long long)blockIdx.x * kPointGroups + group; i < n;
       i += step) {
    if (lane < 3) m.acc[lane] = p[i];
    __syncwarp(mask);
    curdle::coop_double(m, lane, mask);
    if (lane < 3) out[i] = m.acc[lane];
  }
}

// ---------------------------------------------------------------------------
// fr_mont_mul: out[i] = a[i * a_stride] * b[i * b_stride] / R mod r over the
// scalar field, strides as mont_mul's (0 broadcasts one element).
//
// No TPU kernel stands behind it: the JAX package leaves Fr products to XLA,
// which fuses them into each prover piece. Unfused torch integer ops cost
// ~60 launches a product, so the device prover's lane algebra ([128] lanes,
// several products a round) goes through this one. a may be raw words below
// 2^256, which is how values enter and leave Montgomery form: it is brought
// below r once here (fr_from_raw), so the product itself, fr_asm.cuh's
// carry-chained PTX (gen_fp_asm.py), takes canonical operands only.
// Bound: bytes (2 * 64 multiply-adds over 96 bytes), in practice the launch
// and one element's chain. Blocks of one warp, as B1's: a block's warps
// load on one SM, and at the device prove's batches (1-512 elements) blocks
// of 128 took up to 0.2 us a launch more. Teams of 2 or 4 lanes an element
// on fp_team.cuh were measured against this body and came within 0.07 us
// of it at those batches, and 1.75x slower at 65,536 (NVIDIA H100 80GB
// HBM3, 700.00 W), so the one-thread body stays.

__global__ void __launch_bounds__(kMulThreads)
fr_mont_mul_kernel(const Fr* __restrict__ a, const Fr* __restrict__ b,
                   Fr* __restrict__ out, long long n, int a_stride,
                   int b_stride) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Fr x;
    curdle::fr_from_raw(x, a[i * a_stride]);
    const Fr y = b[i * b_stride];
    Fr r;
    curdle::fr_mul(r, x, y);
    out[i] = r;
  }
}

// ---------------------------------------------------------------------------
// fr_pow_fixed: out[i] = x[i]^e over the scalar field, e fixed for the launch.
//
// Replaces go_curdleproofs_tpu/ops/limb_kernels.py:pow_fixed (the Fr ladder
// over 33 base-256 f32 limbs with its roll-and-dot multiply, rows padded to
// 8, at most 1024). Any batch size. 0 maps to 0.
// Bound: operations in name, but the prover inverts 1 to 8 elements at a
// time, so one thread's chain of dependent products sets the time. The
// design is pow_fixed_kernel's (kernels.cu) at 8 words:
//   * a fixed 4-bit window: x^1..x^15 first (7 squarings, 7 products), then
//     per nibble of the exponent from the top four squarings and, where the
//     nibble is not 0, one product with a table entry. The nibble is the
//     same for every thread (the exponent is a kernel argument), so no warp
//     diverges; the top nibble is looked up. For r - 2 that is 252
//     squarings and at most 63 + 7 products against 417 general products
//     one bit at a time;
//   * squarings through fr_sqr (36 + 64 wide multiply-adds against 128),
//     every product on fr_asm.cuh's carry chains;
//   * the 15 powers of a thread live in dynamic shared memory (480 bytes a
//     thread), word j of entry k of thread t at [(k * 8 + j) * 32 + t]: the
//     32 threads of a warp touch 32 neighbouring words, one a bank;
//   * a block is one warp.

struct FrExponent {
  uint32_t w[curdle::FRW];
};

constexpr int kFrPowThreads = 32;
constexpr int kFrPowEntries = 15;

extern __shared__ uint32_t fr_pow_table[];

// Entry k (x^k, k = 1..15) of the calling thread's column of the table.
__device__ __forceinline__ void fr_pow_store(uint32_t* col, int k,
                                             const Fr& v) {
#pragma unroll
  for (int j = 0; j < curdle::FRW; ++j)
    col[((k - 1) * curdle::FRW + j) * kFrPowThreads] = v.w[j];
}

__device__ __forceinline__ void fr_pow_load(Fr& v, const uint32_t* col,
                                            int k) {
#pragma unroll
  for (int j = 0; j < curdle::FRW; ++j)
    v.w[j] = col[((k - 1) * curdle::FRW + j) * kFrPowThreads];
}

// `top` is the index of the exponent's highest nibble that is not 0.
__global__ void __launch_bounds__(kFrPowThreads)
fr_pow_fixed_kernel(const Fr* __restrict__ x, Fr* __restrict__ out,
                    long long n, FrExponent e, int top) {
  const long long i = (long long)blockIdx.x * kFrPowThreads + threadIdx.x;
  if (i >= n) return;  // a thread touches only its own column: no barrier
  uint32_t* col = fr_pow_table + threadIdx.x;
  const Fr base = x[i];
  fr_pow_store(col, 1, base);
#pragma unroll 1
  for (int k = 1; k < 8; ++k) {
    Fr t;
    fr_pow_load(t, col, k);
    curdle::fr_sqr(t, t);
    fr_pow_store(col, 2 * k, t);
    curdle::fr_mul(t, t, base);
    fr_pow_store(col, 2 * k + 1, t);
  }
  Fr acc;
  fr_pow_load(acc, col, (e.w[top >> 3] >> ((top & 7) * 4)) & 15u);
#pragma unroll 1
  for (int idx = top - 1; idx >= 0; --idx) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) curdle::fr_sqr(acc, acc);
    const int d = (e.w[idx >> 3] >> ((idx & 7) * 4)) & 15u;
    if (d != 0) {
      Fr t;
      fr_pow_load(t, col, d);
      curdle::fr_mul(acc, acc, t);
    }
  }
  out[i] = acc;
}

// Blocks for n items at `per_block` items a block, at most kMaxBlocks.
int blocks_for(long long n, int per_block) {
  long long b = (n + per_block - 1) / per_block;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// mont_mul on T lanes an element; `whole`: b is one element for all.
template <int T>
int launch_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                    long long n, int a_stride, bool whole, cudaStream_t s) {
  const int blocks = blocks_for(n, kTeamThreads / T);
  if (whole)
    mont_mul_kernel<T, true><<<blocks, kTeamThreads, 0, s>>>(a, b, out, n,
                                                             a_stride);
  else
    mont_mul_kernel<T, false><<<blocks, kTeamThreads, 0, s>>>(a, b, out, n,
                                                              a_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t.

extern "C" {

int curdle_mont_mul(const void* a, const void* b, void* out, long long n,
                    int a_stride, int b_stride, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (a_stride == 0 && b_stride != 0) {   // the broadcast operand is b
    const void* t = a;
    a = b;
    b = t;
    a_stride = b_stride;
    b_stride = 0;
  }
  const uint32_t* x = (const uint32_t*)a;
  const uint32_t* y = (const uint32_t*)b;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= MUL_TEAM_MAX)
    return launch_mont_mul<MUL_TEAM>(x, y, (uint32_t*)out, n, a_stride,
                                     b_stride == 0, s);
  return launch_mont_mul<1>(x, y, (uint32_t*)out, n, a_stride, b_stride == 0,
                            s);
}

int curdle_point_add(const void* px, const void* py, const void* pz,
                     const void* qx, const void* qy, const void* qz, void* ox,
                     void* oy, void* oz, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  point_add_kernel<<<blocks_for(n, kPointGroups), kPointThreads, 0,
                     (cudaStream_t)stream>>>(
      (const Fp*)px, (const Fp*)py, (const Fp*)pz, (const Fp*)qx,
      (const Fp*)qy, (const Fp*)qz, (Fp*)ox, (Fp*)oy, (Fp*)oz, n);
  return (int)cudaGetLastError();
}

int curdle_point_double(const void* px, const void* py, const void* pz,
                        void* ox, void* oy, void* oz, long long n,
                        void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  point_double_kernel<<<blocks_for(n, kPointGroups), kPointThreads, 0,
                        (cudaStream_t)stream>>>(
      (const Fp*)px, (const Fp*)py, (const Fp*)pz, (Fp*)ox, (Fp*)oy, (Fp*)oz,
      n);
  return (int)cudaGetLastError();
}

int curdle_fr_mont_mul(const void* a, const void* b, void* out, long long n,
                       int a_stride, int b_stride, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  fr_mont_mul_kernel<<<blocks_for(n, kMulThreads), kMulThreads, 0,
                       (cudaStream_t)stream>>>((const Fr*)a, (const Fr*)b,
                                               (Fr*)out, n, a_stride,
                                               b_stride);
  return (int)cudaGetLastError();
}

// `exponent` points to 8 host words; nbits is its bit length (>= 1).
int curdle_fr_pow_fixed(const void* x, void* out, long long n,
                        const uint32_t* exponent, int nbits, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nbits < 1 || nbits > 32 * curdle::FRW)
    return (int)cudaErrorInvalidValue;
  FrExponent e;
  for (int j = 0; j < curdle::FRW; ++j) e.w[j] = exponent[j];
  const size_t table =
      (size_t)kFrPowEntries * sizeof(Fr) * kFrPowThreads;   // 15 KB
  const long long blocks = (n + kFrPowThreads - 1) / kFrPowThreads;
  fr_pow_fixed_kernel<<<(unsigned)blocks, kFrPowThreads, table,
                        (cudaStream_t)stream>>>(
      (const Fr*)x, (Fr*)out, n, e, (nbits - 1) >> 2);
  return (int)cudaGetLastError();
}

}  // extern "C"
