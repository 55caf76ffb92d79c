// The three pointwise kernels, written for Hopper (sm_90a): batched Fp
// multiply, complete point add, complete point double, with a plain C
// launcher each for ctypes (go_curdleproofs_tpu_torch/ops/kernels.py).
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

using curdle::Fp;
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

}  // extern "C"
