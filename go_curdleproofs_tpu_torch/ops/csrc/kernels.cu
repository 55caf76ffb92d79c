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
// 32x32->64 multiply-adds each for the product, as many for the reduction)
// over a few hundred bytes per point, on few points. The compiler makes
// ~1,240 instructions of one product (fp.cuh: fp_mul), and a lone warp
// issues them in ~1.7 us (NVIDIA H100 80GB HBM3, 700 W), so the longest
// chain of products sets the time, not the card's multiply rate. pow_fixed
// keeps one thread per element (its ladder is one chain of products). The
// two MSM kernels are chains of complete point operations, each two rounds
// of independent products: there a group of 8 lanes shares one point
// operation (point_coop.cuh), which makes an operation 2 products deep and
// not 12 or 8, and msm_select_reduce splits one job's lanes over several
// blocks. A shorter product (carry-chained rows), a product split across
// lanes and bucket accumulation are left to later work.

#include <cuda_runtime.h>

#include "fp.cuh"
#include "point_coop.cuh"

using curdle::Fp;
using curdle::GroupMem;
using curdle::kGroupLanes;

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
// the window loop lives inside the kernel and the accumulator in the
// group's shared memory.
// Bound: a row is one chain of 33 x (4 doublings + 1 add) that cannot be cut
// (segments of windows would need the same doublings to be lined up), and
// the main paths give 1-6 rows (the provers' MSM tails) or 2048 (the
// decoder). One thread per row walked 33 x (4 x 8 + 12) = 1,452 dependent
// products. Here one 8-lane group owns a row and runs each operation's
// products side by side: 33 x (4 x 2 + 2) = 330 dependent products a row,
// whatever the rows; 16 rows a block, so 2048 rows are 128 blocks, one wave
// of the 132 SMs, and 1-6 rows one block. The next window's point is read
// into registers before the four doublings, which hide the read. Still far
// from the bound by operations: what is left is 330 times one lane's
// product; the next steps are a shorter product and, for few rows, a
// product split across lanes.

constexpr int kCombineThreads = 128;
constexpr int kCombineRows = kCombineThreads / kGroupLanes;

__global__ void __launch_bounds__(kCombineThreads)
windowed_combine_kernel(const Fp* __restrict__ sx, const Fp* __restrict__ sy,
                        const Fp* __restrict__ sz, Fp* __restrict__ ox,
                        Fp* __restrict__ oy, Fp* __restrict__ oz,
                        int n_windows, int rows) {
  __shared__ GroupMem mem[kCombineRows];
  const int lane = threadIdx.x % kGroupLanes;
  const int group = threadIdx.x / kGroupLanes;
  const int r = blockIdx.x * kCombineRows + group;
  if (r >= rows) return;  // a whole group leaves: its lanes are in no mask
  const unsigned mask = curdle::group_mask();
  GroupMem& m = mem[group];
  const Fp* coord = lane == 0 ? sx : lane == 1 ? sy : sz;

  curdle::coop_set_infinity(m, lane, mask);
#pragma unroll 1
  for (int w = 0; w < n_windows; ++w) {
    Fp next;
    if (lane < 3) next = coord[(size_t)w * rows + r];
#pragma unroll 1
    for (int k = 0; k < 4; ++k) curdle::coop_double(m, lane, mask);
    if (lane < 3) m.q[lane] = next;
    __syncwarp(mask);
    curdle::coop_add(m, lane, mask);
  }
  if (lane < 3) {
    Fp* out = lane == 0 ? ox : lane == 1 ? oy : oz;
    out[r] = m.acc[lane];
  }
}

// ---------------------------------------------------------------------------
// msm_select_reduce: the MSM wide phase. For job j and window w,
//   S[j][w] = sum_l sign(d) * table[|d|][j][l],  d = digits[j][l][w] in [-8, 8].
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:msm_select_reduce. The TPU
// version walked the lanes in chunks as sequential grid steps, with the [W]
// window accumulators in VMEM scratch across chunks. All 33 windows are
// computed; the TPU's padding to 40 was sublane alignment.
// Bound: the work (one add per non-zero digit) is already the least there
// is at 256-2048 lanes and 8 magnitudes; what costs is the depth of the
// chain of dependent adds and the number of blocks (33 a job). Here
//   * a block is 32 groups of 8 lanes; a group walks every 32nd lane of the
//     block's share, selects table[|d|], negates y for d < 0 (p - 0 stays 0,
//     so infinity stays infinity), skips d = 0, and adds cooperatively (2
//     products deep); the next lane's digit and point are read before the
//     add, which hides the read; the first point is taken as it is;
//   * the 32 partial sums are reduced by a 5-level tree of cooperative adds
//     in shared memory, so at its narrow levels an add still has 6 lanes;
//   * the lanes of one (window, job) are split over gridDim.z blocks, chosen
//     by the wrapper so that few jobs still put one block on every SM (a
//     second block on an SM would take turns with the first: one warp's
//     product already keeps its integer pipe more than half busy); each
//     block writes its partial sum, and with more than one a second small
//     launch (msm_finish_kernel) adds them up. With one block the first
//     launch writes the result itself.
// At 256 lanes a block a group adds 8 points and the tree 5: 13 dependent
// adds of two products each, against 9 + n2/128 of twelve products before.

constexpr int kReduceThreads = 256;
constexpr int kReduceGroups = kReduceThreads / kGroupLanes;
constexpr int kFinishThreads = 128;  // 16 groups: up to 16 partial sums

// Sums the accumulators of groups 0..n-1 of a block into group 0's, n <=
// the block's groups. Every thread of the block calls it.
__device__ __forceinline__ void block_tree_sum(GroupMem* mem, int n, int group,
                                               int lane, unsigned mask) {
  int h = 1;
  while (h < n) h <<= 1;
  __syncthreads();
#pragma unroll 1
  for (h >>= 1; h > 0; h >>= 1) {
    if (group < h && group + h < n) {
      GroupMem& m = mem[group];
      if (lane < 3) m.q[lane] = mem[group + h].acc[lane];
      __syncwarp(mask);
      curdle::coop_add(m, lane, mask);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kReduceThreads, 2)
msm_select_reduce_kernel(const Fp* __restrict__ tx, const Fp* __restrict__ ty,
                         const Fp* __restrict__ tz,
                         const int32_t* __restrict__ digits,
                         Fp* __restrict__ ox, Fp* __restrict__ oy,
                         Fp* __restrict__ oz, int m, int n2, int n_windows,
                         int share) {
  __shared__ GroupMem mem[kReduceGroups];
  const int w = blockIdx.x;
  const int job = blockIdx.y;
  const int lane = threadIdx.x % kGroupLanes;
  const int group = threadIdx.x / kGroupLanes;
  const unsigned mask = curdle::group_mask();
  GroupMem& g = mem[group];
  const Fp* coord = lane == 0 ? tx : lane == 1 ? ty : tz;
  const int begin = blockIdx.z * share;
  const int end = min(n2, begin + share);

  // (digit, coordinate `lane` of its table entry) of lane l of the job
  auto fetch = [&](int l, int& d, Fp& c) {
    d = l < end ? digits[((size_t)job * n2 + l) * n_windows + w] : 0;
    if (d != 0 && lane < 3) {
      const int a = d < 0 ? -d : d;
      c = coord[((size_t)a * m + job) * n2 + l];
      if (lane == 1 && d < 0) curdle::fp_neg(c, c);
    }
  };

  curdle::coop_set_infinity(g, lane, mask);
  bool empty = true;
  int d;
  Fp c;
  fetch(begin + group, d, c);
#pragma unroll 1
  for (int l = begin + group; l < end; l += kReduceGroups) {
    int d_next;
    Fp c_next;
    fetch(l + kReduceGroups, d_next, c_next);
    if (d != 0) {  // the same for the whole group
      if (lane < 3) {
        if (empty) g.acc[lane] = c; else g.q[lane] = c;
      }
      __syncwarp(mask);
      if (!empty) curdle::coop_add(g, lane, mask);
      empty = false;
    }
    d = d_next;
    c = c_next;
  }
  block_tree_sum(mem, min(kReduceGroups, max(end - begin, 1)), group, lane,
                 mask);
  if (group == 0 && lane < 3) {
    Fp* out = lane == 0 ? ox : lane == 1 ? oy : oz;
    out[((size_t)blockIdx.z * m + job) * n_windows + w] = mem[0].acc[lane];
  }
}

// out[j][w] = sum over k < n_parts of part[k][j][w].
__global__ void __launch_bounds__(kFinishThreads)
msm_finish_kernel(const Fp* __restrict__ px, const Fp* __restrict__ py,
                  const Fp* __restrict__ pz, Fp* __restrict__ ox,
                  Fp* __restrict__ oy, Fp* __restrict__ oz, int m,
                  int n_windows, int n_parts) {
  __shared__ GroupMem mem[kFinishThreads / kGroupLanes];
  const int lane = threadIdx.x % kGroupLanes;
  const int group = threadIdx.x / kGroupLanes;
  const size_t o = (size_t)blockIdx.y * n_windows + blockIdx.x;
  if (group < n_parts && lane < 3) {
    const Fp* part = lane == 0 ? px : lane == 1 ? py : pz;
    mem[group].acc[lane] = part[(size_t)group * m * n_windows + o];
  }
  block_tree_sum(mem, n_parts, group, lane, curdle::group_mask());
  if (group == 0 && lane < 3) {
    Fp* out = lane == 0 ? ox : lane == 1 ? oy : oz;
    out[o] = mem[0].acc[lane];
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
  const int blocks = (rows + kCombineRows - 1) / kCombineRows;
  windowed_combine_kernel<<<blocks, kCombineThreads, 0, (cudaStream_t)stream>>>(
      (const Fp*)sx, (const Fp*)sy, (const Fp*)sz, (Fp*)ox, (Fp*)oy, (Fp*)oz,
      n_windows, rows);
  return (int)cudaGetLastError();
}

// `split` blocks share the lanes of one (window, job). With split > 1,
// (px, py, pz) are scratch for [split, m, n_windows] partial sums, filled by
// the first launch and summed into (ox, oy, oz) by the second; with split
// == 1 they are not touched.
int curdle_msm_select_reduce(const void* tx, const void* ty, const void* tz,
                             const int32_t* digits, void* ox, void* oy, void* oz,
                             void* px, void* py, void* pz, int m, int n2,
                             int n_windows, int split, void* stream) {
  if (m <= 0 || n_windows <= 0) return (int)cudaSuccess;
  if (split < 1 || split > kFinishThreads / kGroupLanes)
    return (int)cudaErrorInvalidValue;
  const bool direct = split == 1;
  const int share = (n2 + split - 1) / split;
  msm_select_reduce_kernel<<<dim3(n_windows, m, split), kReduceThreads, 0,
                             (cudaStream_t)stream>>>(
      (const Fp*)tx, (const Fp*)ty, (const Fp*)tz, digits,
      (Fp*)(direct ? ox : px), (Fp*)(direct ? oy : py),
      (Fp*)(direct ? oz : pz), m, n2, n_windows, share);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || direct) return (int)rc;
  msm_finish_kernel<<<dim3(n_windows, m), kFinishThreads, 0,
                      (cudaStream_t)stream>>>(
      (const Fp*)px, (const Fp*)py, (const Fp*)pz, (Fp*)ox, (Fp*)oy, (Fp*)oz,
      m, n_windows, split);
  return (int)cudaGetLastError();
}

}  // extern "C"
