// The ladder and the two MSM kernels, written for Hopper (sm_90a), with a
// plain C launcher each for ctypes (go_curdleproofs_tpu_torch/ops/kernels.py).
// The pointwise kernels (multiply, point add, point double) are in
// pointwise.cu.
//
// Every launcher enqueues on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so that a refused launch reaches the caller.
// Tensors are the port's field elements: 12 int32 words per element, read
// here as uint32 (fp.cuh). Point coordinates live in three separate arrays.
//
// What bounds them on an H100: chains of dependent Montgomery products (144
// 32x32->64 multiply-adds each for the product, as many for the reduction;
// a complete point add is 12 products) over a few hundred bytes per point.
// A point formula keeps ~20 field elements (~1 KB) live per thread, so the
// point kernels sit at 238-255 registers with part of it on the stack, and
// at the verifier's sizes few threads run: the latency of one thread's
// chain sets the time, not the card's multiply rate. This first version
// keeps one thread per independent chain and leaves tiling, warp-level
// carries and bucket accumulation to later work.

#include <cuda_runtime.h>

#include "fp.cuh"

using curdle::Fp;
using curdle::Point;

namespace {

// ---------------------------------------------------------------------------
// pow_fixed: out[i] = x[i]^e, e fixed for the launch.
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:pow_fixed (the square-and-
// multiply ladder over RNS channels with the exponent bits in SMEM). Here one
// thread walks one element's whole ladder MSB-first; the exponent words are
// a kernel argument, so every thread takes the same branch at every bit.
// The TPU version's size cap (<= 1024 elements) was a VMEM limit and does not
// apply. 0 maps to 0.
// Bound: ~570 dependent Montgomery products per element, all in registers
// (66 per thread); at the decoder's 1024 elements that is 8 blocks, far
// under one wave of 132 SMs, so latency, not throughput, sets its time.

struct Exponent {
  uint32_t w[curdle::NW];
};

__global__ void pow_fixed_kernel(const Fp* __restrict__ x, Fp* __restrict__ out,
                                 int n, Exponent e, int nbits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp base = x[i];
  Fp acc = base;  // the top bit is 1
  for (int b = nbits - 2; b >= 0; --b) {
    curdle::fp_mul(acc, acc, acc);
    if ((e.w[b >> 5] >> (b & 31)) & 1u) curdle::fp_mul(acc, acc, base);
  }
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// windowed_combine: out[r] = sum_w 16^(W-1-w) * sel[w][r]  (Horner, MSB first).
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:windowed_combine. The TPU
// version streamed the windows as sequential grid steps and carried the
// accumulator in VMEM scratch between them; CUDA blocks run in no order, so
// here the window loop lives inside the thread and the accumulator in its
// registers. One thread per row: rows are independent chains of 33 x
// (4 doublings + 1 add), ~2000 dependent products. Bound: latency of that
// chain; at the final MSM's single row one thread does all of it, at the
// decoder's 2048 rows 32 blocks of 64 leave most SMs idle.

__global__ void windowed_combine_kernel(const Fp* __restrict__ sx,
                                        const Fp* __restrict__ sy,
                                        const Fp* __restrict__ sz,
                                        Fp* __restrict__ ox, Fp* __restrict__ oy,
                                        Fp* __restrict__ oz, int n_windows,
                                        int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  Point acc;
  curdle::point_set_infinity(acc);
  for (int w = 0; w < n_windows; ++w) {
    for (int k = 0; k < 4; ++k) curdle::point_double(acc, acc);
    const size_t off = (size_t)w * rows + r;
    Point s;
    s.x = sx[off];
    s.y = sy[off];
    s.z = sz[off];
    curdle::point_add(acc, acc, s);
  }
  ox[r] = acc.x;
  oy[r] = acc.y;
  oz[r] = acc.z;
}

// ---------------------------------------------------------------------------
// msm_select_reduce: the MSM wide phase. For job j and window w,
//   S[j][w] = sum_l sign(d) * table[|d|][j][l],  d = digits[j][l][w] in [-8, 8].
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:msm_select_reduce. The TPU
// version walked the lanes in chunks as sequential grid steps, with the [W]
// window accumulators in VMEM scratch across chunks. Here one block owns one
// (window, job) pair: its threads stride over the lanes, each selecting
// table[|d|], negating y for d < 0 (p - 0 stays 0, so infinity stays
// infinity) and adding into its own partial sum; a shared-memory tree then
// sums the partials (one point is 144 bytes: 18 KB for 128 threads). Lanes
// with a zero digit select infinity and are skipped. All 33 windows are
// computed; the TPU's padding to 40 was sublane alignment.
// Bound: 33 blocks per job (one per window) and ~255 registers a thread, so
// one job uses a quarter of the SMs; the serial part is n2/128 adds per
// thread plus a 7-level tree.

constexpr int kReduceThreads = 128;

__global__ void __launch_bounds__(kReduceThreads)
msm_select_reduce_kernel(const Fp* __restrict__ tx, const Fp* __restrict__ ty,
                         const Fp* __restrict__ tz,
                         const int32_t* __restrict__ digits,
                         Fp* __restrict__ ox, Fp* __restrict__ oy,
                         Fp* __restrict__ oz, int m, int n2, int n_windows) {
  __shared__ Point part[kReduceThreads];
  const int w = blockIdx.x;
  const int job = blockIdx.y;
  const int tid = threadIdx.x;

  Point acc;
  curdle::point_set_infinity(acc);
  for (int l = tid; l < n2; l += kReduceThreads) {
    const int d = digits[((size_t)job * n2 + l) * n_windows + w];
    if (d == 0) continue;
    const int a = d < 0 ? -d : d;
    const size_t off = ((size_t)a * m + job) * n2 + l;
    Point s;
    s.x = tx[off];
    s.y = ty[off];
    s.z = tz[off];
    if (d < 0) curdle::fp_neg(s.y, s.y);
    curdle::point_add(acc, acc, s);
  }
  part[tid] = acc;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (tid < h) curdle::point_add(part[tid], part[tid], part[tid + h]);
    __syncthreads();
  }
  if (tid == 0) {
    const size_t o = (size_t)job * n_windows + w;
    ox[o] = part[0].x;
    oy[o] = part[0].y;
    oz[o] = part[0].z;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers (ctypes). Pointers are device pointers except `exponent`, which
// points to 12 host words; `stream` is a cudaStream_t.

extern "C" {

int curdle_pow_fixed(const void* x, void* out, int n, const uint32_t* exponent,
                     int nbits, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  Exponent e;
  for (int j = 0; j < curdle::NW; ++j) e.w[j] = exponent[j];
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  pow_fixed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Fp*)x, (Fp*)out, n, e, nbits);
  return (int)cudaGetLastError();
}

int curdle_windowed_combine(const void* sx, const void* sy, const void* sz,
                            void* ox, void* oy, void* oz, int n_windows,
                            int rows, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const int threads = 64;
  const int blocks = (rows + threads - 1) / threads;
  windowed_combine_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Fp*)sx, (const Fp*)sy, (const Fp*)sz, (Fp*)ox, (Fp*)oy, (Fp*)oz,
      n_windows, rows);
  return (int)cudaGetLastError();
}

int curdle_msm_select_reduce(const void* tx, const void* ty, const void* tz,
                             const int32_t* digits, void* ox, void* oy, void* oz,
                             int m, int n2, int n_windows, void* stream) {
  if (m <= 0 || n_windows <= 0) return (int)cudaSuccess;
  const dim3 grid(n_windows, m);
  msm_select_reduce_kernel<<<grid, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const Fp*)tx, (const Fp*)ty, (const Fp*)tz, digits, (Fp*)ox, (Fp*)oy,
      (Fp*)oz, m, n2, n_windows);
  return (int)cudaGetLastError();
}

}  // extern "C"
