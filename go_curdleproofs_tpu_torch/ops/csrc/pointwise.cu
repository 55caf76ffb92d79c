// The pointwise kernels, written for Hopper (sm_90a): batched Fp multiply,
// complete point add, complete point double, and the scalar field's batched
// multiply and fixed-exponent ladder (fr.cuh on fr_asm.cuh), with a plain C
// launcher each for ctypes (go_curdleproofs_tpu_torch/ops/kernels.py). The
// fused 16*acc + sel step is in kernels.cu, on the cooperative point
// operations.
//
// Every launcher enqueues on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so that a refused launch reaches the caller.
// Elements are the port's: 12 int32 words each (read here as uint32,
// fp.cuh), contiguous, any batch size, no padding to a block. Each thread
// takes one element (one point) and strides over the batch by the grid.
// Outputs never alias inputs (the wrapper allocates them); the two inputs
// of a multiply or an add may be the same array (P + P, a * a).
//
// What bounds them on an H100: operations in name. One Montgomery product is
// 2*144 32x32->64 multiply-adds over 144 bytes moved (two elements in, one
// out), ~2 multiply-adds per byte against a card balance of ~5 per byte
// (16.7e12 multiply-adds/s, 3.35e12 bytes/s), so a lone multiply sits under
// the memory line and an add (12 products over 432 bytes) above it. At the
// verifier's and prover's batch sizes (tens to a few thousand elements)
// neither line is near: these kernels take 10-20 us on the card, less than
// the wrapper's call and its torch.empty, which is what CUDA events around
// them read (0.03-0.05 ms; NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>

#include "fp.cuh"
#include "fr.cuh"

using curdle::Fp;
using curdle::Fr;
using curdle::Point;

namespace {

constexpr int kMulThreads = 128;
constexpr int kPointThreads = 64;
constexpr int kMaxBlocks = 132 * 16;   // grid-stride beyond this many blocks

// ---------------------------------------------------------------------------
// mont_mul: out[i] = a[i * a_stride] * b[i * b_stride] / R mod p.
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:mont_mul (the batched
// Montgomery product over 74 RNS channels, rows padded to a block). A stride
// is 1 (one operand element per output) or 0 (one element broadcast over the
// batch: the GLV beta multiply of a whole x plane, the multiply by plain 1
// that leaves Montgomery form), so a broadcast is never materialised.

__global__ void __launch_bounds__(kMulThreads)
mont_mul_kernel(const Fp* __restrict__ a, const Fp* __restrict__ b,
                Fp* __restrict__ out, long long n, int a_stride, int b_stride) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const Fp x = a[i * a_stride];
    const Fp y = b[i * b_stride];
    Fp r;
    curdle::fp_mul(r, x, y);
    out[i] = r;
  }
}

// ---------------------------------------------------------------------------
// point_add: (ox, oy, oz)[i] = P[i] + Q[i], complete (RCB16 algorithm 7).
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:point_add: the same 12
// field products, the same answer for infinity + P, P + P and P + (-P), no
// branch. One thread per point; the formula keeps ~20 field elements live,
// so the register file, not shared memory, is the scarce resource.

__global__ void __launch_bounds__(kPointThreads)
point_add_kernel(const Fp* __restrict__ px, const Fp* __restrict__ py,
                 const Fp* __restrict__ pz, const Fp* __restrict__ qx,
                 const Fp* __restrict__ qy, const Fp* __restrict__ qz,
                 Fp* __restrict__ ox, Fp* __restrict__ oy, Fp* __restrict__ oz,
                 long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Point p, q, r;
    p.x = px[i];
    p.y = py[i];
    p.z = pz[i];
    q.x = qx[i];
    q.y = qy[i];
    q.z = qz[i];
    curdle::point_add(r, p, q);
    ox[i] = r.x;
    oy[i] = r.y;
    oz[i] = r.z;
  }
}

// ---------------------------------------------------------------------------
// point_double: (ox, oy, oz)[i] = 2 * P[i], complete (RCB16 algorithm 9).
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:point_double: 8 field
// products (the multiplication by b3 = 12 is additions), infinity doubles
// to infinity.

__global__ void __launch_bounds__(kPointThreads)
point_double_kernel(const Fp* __restrict__ px, const Fp* __restrict__ py,
                    const Fp* __restrict__ pz, Fp* __restrict__ ox,
                    Fp* __restrict__ oy, Fp* __restrict__ oz, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Point p, r;
    p.x = px[i];
    p.y = py[i];
    p.z = pz[i];
    curdle::point_double(r, p);
    ox[i] = r.x;
    oy[i] = r.y;
    oz[i] = r.z;
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
// Bound: bytes (2 * 64 multiply-adds over 96 bytes), in practice the launch.

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

int blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t.

extern "C" {

int curdle_mont_mul(const void* a, const void* b, void* out, long long n,
                    int a_stride, int b_stride, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  mont_mul_kernel<<<blocks_for(n, kMulThreads), kMulThreads, 0,
                    (cudaStream_t)stream>>>((const Fp*)a, (const Fp*)b,
                                            (Fp*)out, n, a_stride, b_stride);
  return (int)cudaGetLastError();
}

int curdle_point_add(const void* px, const void* py, const void* pz,
                     const void* qx, const void* qy, const void* qz, void* ox,
                     void* oy, void* oz, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  point_add_kernel<<<blocks_for(n, kPointThreads), kPointThreads, 0,
                     (cudaStream_t)stream>>>(
      (const Fp*)px, (const Fp*)py, (const Fp*)pz, (const Fp*)qx,
      (const Fp*)qy, (const Fp*)qz, (Fp*)ox, (Fp*)oy, (Fp*)oz, n);
  return (int)cudaGetLastError();
}

int curdle_point_double(const void* px, const void* py, const void* pz,
                        void* ox, void* oy, void* oz, long long n,
                        void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  point_double_kernel<<<blocks_for(n, kPointThreads), kPointThreads, 0,
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
