// The pointwise kernels, written for Hopper (sm_90a): batched Fp multiply,
// complete point add, complete point double, the fused 16*acc + sel step,
// and the scalar field's batched multiply and fixed-exponent ladder, with a
// plain C launcher each for ctypes
// (go_curdleproofs_tpu_torch/ops/kernels.py).
//
// Every launcher enqueues on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so that a refused launch reaches the caller.
// Elements are the port's: 12 int32 words each (read here as uint32,
// fp.cuh), contiguous, any batch size, no padding to a block. Each thread
// takes one element (one point) and strides over the batch by the grid.
// Outputs never alias inputs (the wrapper allocates them); the two inputs
// of a multiply or an add may be the same array (P + P, a * a).
//
// What bounds them on an H100: operations. One Montgomery product is 2*144
// 32x32->64 multiply-adds over 144 bytes moved (two elements in, one out),
// ~2 multiply-adds per byte against a card balance of ~5 per byte
// (16.7e12 multiply-adds/s, 3.35e12 bytes/s), so a lone multiply sits under
// the memory line and an add (12 products over 432 bytes) above it. At the
// verifier's and prover's batch sizes (tens to a few thousand elements)
// neither line is near: the launch and one thread's dependent chain set
// the time.

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
// point_x16_add: (ox, oy, oz)[i] = 16 * acc[i] + sel[i]: four complete
// doublings and one complete add in one launch.
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:point_x16_add, the step of
// the window-at-a-time Horner loop (acc' = 16*acc + selected table entry).
// Same contract: complete (infinity in either operand; acc = sel after the
// doublings is a doubling inside the add), outputs never alias inputs. One
// thread per point walks 4 * 8 + 12 = 44 dependent field products in
// registers; the four intermediate points of the unfused form never touch
// device memory. Bound: operations (44 products over 432 bytes), but at the
// prover's batches (2 to 24 points) one thread's chain sets the time.

__global__ void __launch_bounds__(kPointThreads)
point_x16_add_kernel(const Fp* __restrict__ ax, const Fp* __restrict__ ay,
                     const Fp* __restrict__ az, const Fp* __restrict__ sx,
                     const Fp* __restrict__ sy, const Fp* __restrict__ sz,
                     Fp* __restrict__ ox, Fp* __restrict__ oy,
                     Fp* __restrict__ oz, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    Point acc, s;
    acc.x = ax[i];
    acc.y = ay[i];
    acc.z = az[i];
    s.x = sx[i];
    s.y = sy[i];
    s.z = sz[i];
    for (int k = 0; k < 4; ++k) curdle::point_double(acc, acc);
    curdle::point_add(acc, acc, s);
    ox[i] = acc.x;
    oy[i] = acc.y;
    oz[i] = acc.z;
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
// 2^256 (fr.cuh), which is how values enter and leave Montgomery form.
// Bound: bytes (2 * 64 multiply-adds over 96 bytes), in practice the launch.

__global__ void __launch_bounds__(kMulThreads)
fr_mont_mul_kernel(const Fr* __restrict__ a, const Fr* __restrict__ b,
                   Fr* __restrict__ out, long long n, int a_stride,
                   int b_stride) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const Fr x = a[i * a_stride];
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
// 8, at most 1024). Here one thread walks one element's ladder MSB-first on
// 8-word CIOS products; the exponent words are a kernel argument, so every
// thread takes the same branch at every bit. Any batch size. 0 maps to 0.
// Bound: operations in name (~380 dependent products an element for r - 2),
// but the prover inverts 1 to 8 elements at a time, so one thread's chain of
// dependent multiply-adds sets the time.

struct FrExponent {
  uint32_t w[curdle::FRW];
};

__global__ void fr_pow_fixed_kernel(const Fr* __restrict__ x,
                                    Fr* __restrict__ out, long long n,
                                    FrExponent e, int nbits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fr base = x[i];
  Fr acc = base;  // the top bit is 1
  for (int b = nbits - 2; b >= 0; --b) {
    curdle::fr_mul(acc, acc, acc);
    if ((e.w[b >> 5] >> (b & 31)) & 1u) curdle::fr_mul(acc, acc, base);
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

int curdle_point_x16_add(const void* ax, const void* ay, const void* az,
                         const void* sx, const void* sy, const void* sz,
                         void* ox, void* oy, void* oz, long long n,
                         void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  point_x16_add_kernel<<<blocks_for(n, kPointThreads), kPointThreads, 0,
                         (cudaStream_t)stream>>>(
      (const Fp*)ax, (const Fp*)ay, (const Fp*)az, (const Fp*)sx,
      (const Fp*)sy, (const Fp*)sz, (Fp*)ox, (Fp*)oy, (Fp*)oz, n);
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

// `exponent` points to 8 host words.
int curdle_fr_pow_fixed(const void* x, void* out, long long n,
                        const uint32_t* exponent, int nbits, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  FrExponent e;
  for (int j = 0; j < curdle::FRW; ++j) e.w[j] = exponent[j];
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  fr_pow_fixed_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Fr*)x, (Fr*)out, n, e, nbits);
  return (int)cudaGetLastError();
}

}  // extern "C"
