// The ladder, the two MSM kernels, the fused Horner step, the batched
// point decode and the GLV recode of host scalars, written for Hopper
// (sm_90a), with a plain C launcher each for ctypes
// (go_curdleproofs_tpu_torch/ops/kernels.py). The pointwise
// kernels (multiply, point add, point double) are in pointwise.cu.
//
// Every launcher enqueues on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so that a refused launch reaches the caller.
// Tensors are the port's field elements: 12 int32 words per element, read
// here as uint32 (fp.cuh). Point coordinates live in three separate arrays.
//
// What bounds them on an H100: chains of dependent Montgomery products (144
// 32x32->64 multiply-adds each for the product, as many for the reduction)
// over a few hundred bytes per point, on few points. The product is
// straight-line PTX on hardware carry chains (fp_asm.cuh). After ptxas
// mont_mul_kernel, one product with its loads and stores, is 464
// instructions, 283 of them wide multiply-adds with carry, and a lone warp
// takes 0.92 us a product and 0.71-0.77 us a square (NVIDIA H100 80GB HBM3,
// 700 W, time_kernels.py; the 64-bit C form before it: 1,244 instructions,
// 1.2-1.9 us). Two warps on a scheduler take 1.38x the time of one
// (time_kernels.py --threads), so one warp keeps its scheduler ~70% busy:
// the longest chain of products sets the time, not the card's multiply rate. pow_fixed keeps one thread
// per element (its ladder is one chain) and shortens the chain with a 4-bit
// window and a dedicated square. The other three are chains of complete
// point operations, each two rounds of independent products: there a group
// of 8 lanes shares one point operation (point_coop.cuh), which makes an
// operation 2 products deep and not 12 or 8, and msm_select_reduce splits
// one job's lanes over several blocks. decode_points runs both: the ladder
// on one lane of a point's group, then a chain of point operations on the
// group. A product split across lanes and bucket accumulation are left to
// later work.

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
// multiply ladder over RNS channels with the exponent bits in SMEM). The TPU
// version's size cap (<= 1024 elements) was a VMEM limit and does not apply.
// 0 maps to 0.
// Bound: operations in name, but one element's ladder is one chain of
// dependent products, and the batches are small (the decoder's 1024
// elements, the provers' 256 or a handful), so the chain's length times one
// lane's product sets the time. What the design does about it:
//   * a fixed 4-bit window: x^1..x^15 first (7 squarings, 7 products), then
//     per nibble of the exponent from the top four squarings and, where the
//     nibble is not 0, one product with a table entry. The nibble is the
//     same for every thread (the exponent is a kernel argument), so no warp
//     diverges. For (p+1)/4 and p-2 that is ~387 squarings and ~100
//     products against ~380 + ~190 one bit at a time;
//   * the squarings go through fp_sqr (78 + 144 wide multiply-adds against
//     288);
//   * the 15 powers of a thread live in dynamic shared memory (720 bytes a
//     thread), word j of entry k of thread t at [(k * 12 + j) * threads + t]:
//     the 32 threads of a warp touch 32 neighbouring words, one a bank;
//   * a block is one warp: one warp already keeps its scheduler's integer
//     pipe busy and two take turns, so 1024 elements are spread one warp a
//     scheduler over 32 SMs and not four to a scheduler over 8.
// Left for later: an element split across lanes (1024 elements use 6% of
// the card's schedulers), and addition chains for the two fixed exponents.

struct Exponent {
  uint32_t w[curdle::NW];
};

constexpr int kPowEntries = 15;

extern __shared__ uint32_t pow_table[];

// Entry k (x^k, k = 1..15) of a column of the table whose neighbouring
// columns lie `stride` words apart.
__device__ __forceinline__ void pow_store(uint32_t* col, int stride, int k,
                                          const Fp& v) {
#pragma unroll
  for (int j = 0; j < curdle::NW; ++j)
    col[((k - 1) * curdle::NW + j) * stride] = v.w[j];
}

__device__ __forceinline__ void pow_load(Fp& v, const uint32_t* col,
                                         int stride, int k) {
#pragma unroll
  for (int j = 0; j < curdle::NW; ++j)
    v.w[j] = col[((k - 1) * curdle::NW + j) * stride];
}

// acc = base^e by the 4-bit window, the powers in the column `col`; `top`
// is the index of the exponent's highest nibble that is not 0. One thread's
// chain: it touches only its own column, so it needs no barrier.
__device__ __forceinline__ void pow_ladder(Fp& acc, const Fp& base,
                                           uint32_t* col, int stride,
                                           const Exponent& e, int top) {
  pow_store(col, stride, 1, base);
#pragma unroll 1
  for (int k = 1; k < 8; ++k) {
    Fp t;
    pow_load(t, col, stride, k);
    curdle::fp_sqr(t, t);
    pow_store(col, stride, 2 * k, t);
    curdle::fp_mul(t, t, base);
    pow_store(col, stride, 2 * k + 1, t);
  }
  pow_load(acc, col, stride, (e.w[top >> 3] >> ((top & 7) * 4)) & 15u);
#pragma unroll 1
  for (int idx = top - 1; idx >= 0; --idx) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) curdle::fp_sqr(acc, acc);
    const int d = (e.w[idx >> 3] >> ((idx & 7) * 4)) & 15u;
    if (d != 0) {
      Fp t;
      pow_load(t, col, stride, d);
      curdle::fp_mul(acc, acc, t);
    }
  }
}

__global__ void pow_fixed_kernel(const Fp* __restrict__ x, Fp* __restrict__ out,
                                 int n, Exponent e, int top) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp base = x[i];
  Fp acc;
  pow_ladder(acc, base, pow_table + threadIdx.x, blockDim.x, e, top);
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
// product and the additions between them; the next step, for few rows, is
// a product split across lanes.

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

// ---------------------------------------------------------------------------
// point_x16_add: (ox, oy, oz)[i] = 16 * acc[i] + sel[i]: four complete
// doublings and one complete add in one launch, the step of the window-at-a-
// time Horner loop (curve.scalar_mul_steps).
//
// Replaces go_curdleproofs_tpu/ops/rns_kernels.py:point_x16_add. Same
// contract: complete (infinity in either operand; acc = sel after the
// doublings is a doubling inside the add).
// Bound: operations in name (44 products over 432 bytes a point), but the
// device prover's batches are 2 to 24 points and a step waits for the step
// before it, so what costs is the depth of one step and everything the host
// has to enqueue around it. What the design does about it:
//   * one 8-lane group a point on the cooperative operations of
//     point_coop.cuh, the accumulator in the group's shared memory for all
//     five: 10 dependent products deep, not 44, no 240-register formula and
//     no stack; a block is one warp (four points), so 24 points are 6 blocks
//     on 6 SMs and their groups run side by side;
//   * the operand has two load stages. Either it is given (sx, sy, sz), or
//     the kernel selects it itself as msm_select_reduce does: lane `lane` of
//     the group reads coordinate `lane` of entry |d| of point i's column of
//     the extended table [9, n] for d = digits[i][w], and lane 1 negates it
//     where d < 0 (d = 0 reads entry 0, infinity; -0 stays 0). With that the
//     loop needs no gather, no select and no index tensor: one launch a
//     window;
//   * the point is read into shared memory whole before anything is written,
//     so the outputs may be the accumulator's own arrays and the loop
//     allocates nothing.

constexpr int kStepThreads = 32;
constexpr int kStepPoints = kStepThreads / kGroupLanes;

__global__ void __launch_bounds__(kStepThreads)
point_x16_add_kernel(const Fp* ax, const Fp* ay, const Fp* az,
                     const Fp* __restrict__ sx, const Fp* __restrict__ sy,
                     const Fp* __restrict__ sz,
                     const int32_t* __restrict__ digits, int n_windows, int w,
                     Fp* ox, Fp* oy, Fp* oz, int n) {
  __shared__ GroupMem mem[kStepPoints];
  const int lane = threadIdx.x % kGroupLanes;
  const int group = threadIdx.x / kGroupLanes;
  const int i = blockIdx.x * kStepPoints + group;
  if (i >= n) return;  // a whole group leaves: its lanes are in no mask
  const unsigned mask = curdle::group_mask();
  GroupMem& m = mem[group];

  Fp sel;
  if (lane < 3) {
    const Fp* acc = lane == 0 ? ax : lane == 1 ? ay : az;
    const Fp* src = lane == 0 ? sx : lane == 1 ? sy : sz;
    m.acc[lane] = acc[i];
    if (digits != nullptr) {
      const int d = digits[(size_t)i * n_windows + w];
      sel = src[(size_t)(d < 0 ? -d : d) * n + i];
      if (lane == 1 && d < 0) curdle::fp_neg(sel, sel);
    } else {
      sel = src[i];
    }
  }
  __syncwarp(mask);
#pragma unroll 1
  for (int k = 0; k < 4; ++k) curdle::coop_double(m, lane, mask);
  if (lane < 3) m.q[lane] = sel;
  __syncwarp(mask);
  curdle::coop_add(m, lane, mask);
  if (lane < 3) {
    Fp* out = lane == 0 ? ox : lane == 1 ? oy : oz;
    out[i] = m.acc[lane];
  }
}


// ---------------------------------------------------------------------------
// decode_points: the whole batched point decompression of the verifier and
// the prover. For point i with the big-endian x bytes xb[i] (the three flag
// bits cleared, x < p, both checked on the host) and the sign wl[i] (1: the
// lexicographically largest y), out[i] is 13 words: the canonical y,
// little-endian, then the flags, bit 0 on the curve (x^3 + 4 is a square)
// and bit 1 in the prime-order subgroup ([lambda]P == phi(P)). pts holds
// the point itself for the verifier's final MSM, in the layout of three
// [n] planes of Fp: pts[0][i] = x R, pts[1][i] = y R, pts[2][i] = R (the
// projective (x : y : 1) in Montgomery form), each written by one lane of
// the point's group as the subgroup test loads it, so the MSM reads the
// decoded points where they are and the host converts none of them.
//
// Replaces the chain of ~420 launches of plain torch ops and four kernels
// that did the same (the sqrt ladder, y's sign, a 33-window scalar
// multiplication by lambda over a padded table): what held that path was
// the host's enqueue of its launches, not the card. Here a point is
//   * x into Montgomery form (one product with R^2), rhs = x^3 + 4, the
//     candidate root rhs^((p+1)/4) by pow_fixed's 4-bit ladder, on_curve =
//     (cand^2 == rhs), the canonical root (one product with the integer 1)
//     against (p-1)/2, y = +-cand by the sign; one lane of the point's
//     group runs this chain, the table of powers in shared memory;
//   * the subgroup test with lambda = z^2 - 1, z = -kZ: [lambda]P =
//     [kZ]([kZ]P) - P (the two signs of z cancel), MSB first, 126
//     doublings and 11 additions, each a complete cooperative operation of
//     the point's 8-lane group (point_coop.cuh): 2 products deep. Exact for
//     every input, on the curve or not, so the verdict is the plain
//     version's, word for word.
// Bound: operations (~1,800 products a point) on 248-18,720 points, so the
// depth of one point's chain sets the time: ~480 dependent ladder steps on
// one lane and 137 operations of 2 products on the group. A block is one
// warp, four points, so 585 points are 147 warps, about one a scheduler.
// The ladder lanes of a warp are a quarter of it: the ladder was never
// issue-bound at these sizes (pow_fixed's note), and a product split across
// a group's lanes is left to later work.

constexpr int kDecodeThreads = 32;
constexpr int kDecodePoints = kDecodeThreads / kGroupLanes;
constexpr int kXBytes = 48;
constexpr int kDecodeWords = curdle::NW + 1;  // y, then the flags
constexpr uint64_t kZ = 0xd201000000010000ull;  // z = -kZ, the BLS parameter

// R^2 mod p (x -> x R by one product), 4 and beta in Montgomery form,
// (p - 1) / 2, and the square-root exponent (p + 1) / 4 with the index of
// its top nibble (tests/test_torch_kernels.py reads them back).
__constant__ uint32_t kR2[curdle::NW] = {
    0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u, 0x8de5476cu,
    0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};
__constant__ uint32_t kFour[curdle::NW] = {
    0x000cfff3u, 0xaa270000u, 0xfc34000au, 0x53cc0032u, 0x6b0a807fu, 0x478fe97au,
    0xe6ba24d7u, 0xb1d37ebeu, 0xbf78ab2fu, 0x8ec9733bu, 0x3d83de7eu, 0x09d64551u};
__constant__ uint32_t kBeta[curdle::NW] = {
    0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu,
    0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u};
__constant__ uint32_t kHalfP[curdle::NW] = {
    0xffffd555u, 0xdcff7fffu, 0x58a9ffffu, 0x0f55ffffu, 0x7b587b12u, 0xb3986950u,
    0x79c2895fu, 0xb23ba5c2u, 0x21a5d66bu, 0x258dd3dbu, 0x1cbff34du, 0x0d0088f5u};
__constant__ Exponent kSqrtExponent = {{
    0xffffeaabu, 0xee7fbfffu, 0xac54ffffu, 0x07aaffffu, 0x3dac3d89u, 0xd9cc34a8u,
    0x3ce144afu, 0xd91dd2e1u, 0x90d2eb35u, 0x92c6e9edu, 0x8e5ff9a6u, 0x0680447au}};
constexpr int kSqrtTop = 94;

__device__ __forceinline__ void fp_load(Fp& r, const uint32_t* c) {
#pragma unroll
  for (int j = 0; j < curdle::NW; ++j) r.w[j] = c[j];
}

__device__ __forceinline__ bool fp_equal(const Fp& a, const Fp& b) {
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < curdle::NW; ++j) d |= a.w[j] ^ b.w[j];
  return d == 0;
}

// a > c as integers, from the top word down.
__device__ __forceinline__ bool words_greater(const Fp& a, const uint32_t* c) {
  bool gt = false, decided = false;
#pragma unroll
  for (int j = curdle::NW - 1; j >= 0; --j) {
    gt = decided ? gt : a.w[j] > c[j];
    decided = decided || a.w[j] != c[j];
  }
  return gt;
}

// m.acc = [kZ] m.acc where m.acc and m.q both hold the point: double and
// add, MSB first. Called as coop_add.
__device__ __forceinline__ void coop_mul_z(GroupMem& m, int lane,
                                           unsigned mask) {
#pragma unroll 1
  for (int b = 62; b >= 0; --b) {
    curdle::coop_double(m, lane, mask);
    if ((kZ >> b) & 1) curdle::coop_add(m, lane, mask);
  }
}

__global__ void __launch_bounds__(kDecodeThreads)
decode_points_kernel(const uint8_t* __restrict__ xb,
                     const uint8_t* __restrict__ wl,
                     int32_t* __restrict__ out, Fp* __restrict__ pts, int n) {
  __shared__ GroupMem mem[kDecodePoints];
  __shared__ Fp base[kDecodePoints][2];  // x and y of P, Montgomery form
  __shared__ uint32_t table[kPowEntries * curdle::NW * kDecodePoints];
  const int lane = threadIdx.x % kGroupLanes;
  const int group = threadIdx.x / kGroupLanes;
  const int i = blockIdx.x * kDecodePoints + group;
  if (i >= n) return;  // a whole group leaves: its lanes are in no mask
  const unsigned mask = curdle::group_mask();
  GroupMem& m = mem[group];
  Fp* pt = base[group];
  int32_t* o = out + (size_t)i * kDecodeWords;

  bool on_curve = false;
  if (lane == 0) {
    Fp x, c;
    const uint8_t* b = xb + (size_t)i * kXBytes;
#pragma unroll
    for (int j = 0; j < curdle::NW; ++j) {
      const uint8_t* w = b + kXBytes - 4 * (j + 1);
      x.w[j] = (uint32_t)w[0] << 24 | (uint32_t)w[1] << 16 |
               (uint32_t)w[2] << 8 | w[3];
    }
    fp_load(c, kR2);
    curdle::fp_mul(x, x, c);
    Fp rhs, cand;
    curdle::fp_sqr(rhs, x);
    curdle::fp_mul(rhs, rhs, x);
    fp_load(c, kFour);
    curdle::fp_add(rhs, rhs, c);
    pow_ladder(cand, rhs, table + group, kDecodePoints, kSqrtExponent,
               kSqrtTop);
    curdle::fp_sqr(c, cand);
    on_curve = fp_equal(c, rhs);
    curdle::fp_set_zero(c);
    c.w[0] = 1;
    curdle::fp_mul(c, cand, c);  // the root's canonical value
    if (words_greater(c, kHalfP) != (wl[i] != 0)) {
      curdle::fp_neg(c, c);
      curdle::fp_neg(cand, cand);
    }
#pragma unroll
    for (int j = 0; j < curdle::NW; ++j) o[j] = (int32_t)c.w[j];
    pt[0] = x;
    pt[1] = cand;
  }
  __syncwarp(mask);

  // T = [kZ]P, then [kZ]T = [z^2]P, then + (-P): S = [lambda]P; lane c
  // also stores coordinate c of P
  if (lane < 3) {
    Fp v;
    if (lane == 2) curdle::fp_set_one(v); else v = pt[lane];
    m.acc[lane] = v;
    m.q[lane] = v;
    pts[(size_t)lane * n + i] = v;
  }
  __syncwarp(mask);
  coop_mul_z(m, lane, mask);
  if (lane < 3) m.q[lane] = m.acc[lane];
  __syncwarp(mask);
  coop_mul_z(m, lane, mask);
  if (lane < 3) {
    Fp v;
    if (lane == 2) curdle::fp_set_one(v); else v = pt[lane];
    if (lane == 1) curdle::fp_neg(v, v);
    m.q[lane] = v;
  }
  __syncwarp(mask);
  curdle::coop_add(m, lane, mask);

  // S == phi(P) = (beta x, y): X_S == beta x Z_S (lane 0), Y_S == y Z_S
  // (lane 1)
  bool equal = true;
  if (lane < 2) {
    Fp v = pt[lane];
    if (lane == 0) {
      Fp c;
      fp_load(c, kBeta);
      curdle::fp_mul(v, v, c);
    }
    curdle::fp_mul(v, v, m.acc[2]);
    equal = fp_equal(v, m.acc[lane]);
  }
  const unsigned votes = __ballot_sync(mask, equal) >> (threadIdx.x & 24);
  if (lane == 0)
    o[curdle::NW] = (int32_t)(on_curve | ((votes & 3u) == 3u ? 2u : 0u));
}

// ---------------------------------------------------------------------------
// glv_recode: the GLV split and signed-digit recode of the host MSMs'
// scalars. For scalar i, 8 little-endian words below r, out rows 2i and
// 2i + 1 are the 33 signed digits of s1 = s mod lambda and s2 = s div lambda
// (s = s1 + lambda s2, both below 2^128), MSB window first: nibble k of
// half + BIAS (BIAS = 0x88...88, 128 bits) less 8 for k < 32, and the
// carry out of that sum, unbiased, as window 32. A zero scalar gives zero
// digits.
//
// Replaces the host's glv.scalars_to_digits_glv on every host MSM (Python
// divmod, to_bytes and numpy nibble work a scalar, then 264 bytes of
// digits uploaded where 32 bytes of scalar now are). The division is
// Barrett's by the fixed 128-bit lambda: q = (s * MU) >> 256 with
// MU = 2^256 div lambda is at most 2 under the quotient, so s - q lambda,
// below 3 lambda < 2^130, is exact in 5 words, and two corrections finish
// it (ops/glv_dev.py, the plain version, does the same on half-limbs).
// Bound: bytes, 32 in and 264 out a scalar (~50 products of 32 bits and a
// few dozen additions a scalar are nothing at these sizes); 1,152-4,608
// scalars move 0.3-1.4 MB, under a microsecond of HBM, so a launch sits at
// the launch floor. One thread a scalar; a block stages its digit rows in
// shared memory and writes them as one contiguous run, so the warps' stores
// are whole lines.

constexpr int kRecodeThreads = 128;
constexpr int kRecodeWindows = 33;
constexpr int kRecodeDigits = 2 * kRecodeWindows;  // s1's row, then s2's

__constant__ uint32_t kLambda[4] = {0xffffffffu, 0x00000000u, 0x0001a402u,
                                    0xac45a401u};
__constant__ uint32_t kMu[5] = {0xf6cfee30u, 0x63f6e522u, 0xe01faaddu,
                                0x7c6becf1u, 0x00000001u};

// r >= lambda for r of 5 words.
__device__ __forceinline__ bool at_least_lambda(const uint32_t r[5]) {
  bool gt = false, decided = false;
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    gt = decided ? gt : r[j] > kLambda[j];
    decided = decided || r[j] != kLambda[j];
  }
  return r[4] != 0 || gt || !decided;
}

// One Barrett correction where it applies: r -= lambda, q += 1.
__device__ __forceinline__ void correct(uint32_t r[5], uint32_t q[4]) {
  if (!at_least_lambda(r)) return;
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const uint64_t t = (uint64_t)r[j] - (j < 4 ? kLambda[j] : 0u) - borrow;
    r[j] = (uint32_t)t;
    borrow = t >> 63;
  }
  uint64_t carry = 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t t = (uint64_t)q[j] + carry;
    q[j] = (uint32_t)t;
    carry = t >> 32;
  }
}

// The 33 digits of a half below 2^128 into row[0..32], MSB window first.
__device__ __forceinline__ void recode_half(const uint32_t h[4],
                                            int32_t* row) {
  uint32_t v[4];
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t t = (uint64_t)h[j] + 0x88888888u + carry;
    v[j] = (uint32_t)t;
    carry = t >> 32;
  }
  row[0] = (int32_t)carry;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    row[32 - k] = (int32_t)((v[k >> 3] >> (4 * (k & 7))) & 15u) - 8;
}

__global__ void __launch_bounds__(kRecodeThreads)
glv_recode_kernel(const uint32_t* __restrict__ words,
                  int32_t* __restrict__ out, int m) {
  __shared__ int32_t stage[kRecodeThreads * kRecodeDigits];
  const int first = blockIdx.x * kRecodeThreads;
  const int count = min(kRecodeThreads, m - first);
  const int t = threadIdx.x;
  if (t < count) {
    uint32_t s[8];
    const uint32_t* in = words + (size_t)(first + t) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = __ldg(in + j);

    // q = (s * MU) >> 256: words 8-11 of the 13-word product (word 12 is
    // 0, the quotient being below 2^128)
    uint32_t p[13];
#pragma unroll
    for (int j = 0; j < 13; ++j) p[j] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint64_t carry = 0;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const uint64_t t2 = (uint64_t)s[i] * kMu[j] + p[i + j] + carry;
        p[i + j] = (uint32_t)t2;
        carry = t2 >> 32;
      }
      p[i + 5] = (uint32_t)carry;
    }
    uint32_t q[4] = {p[8], p[9], p[10], p[11]};

    // r = s - q lambda modulo 2^160
    uint32_t ql[5] = {0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint64_t carry = 0;
#pragma unroll
      for (int j = 0; i + j < 5 && j < 4; ++j) {
        const uint64_t t2 = (uint64_t)q[i] * kLambda[j] + ql[i + j] + carry;
        ql[i + j] = (uint32_t)t2;
        carry = t2 >> 32;
      }
      if (i == 0) ql[4] = (uint32_t)carry;
    }
    uint32_t r[5];
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const uint64_t t2 = (uint64_t)s[j] - ql[j] - borrow;
      r[j] = (uint32_t)t2;
      borrow = t2 >> 63;
    }
    correct(r, q);
    correct(r, q);

    int32_t* row = stage + t * kRecodeDigits;
    recode_half(r, row);
    recode_half(q, row + kRecodeWindows);
  }
  __syncthreads();
  int32_t* dst = out + (size_t)first * kRecodeDigits;
  for (int k = t; k < count * kRecodeDigits; k += kRecodeThreads)
    dst[k] = stage[k];
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers (ctypes). Pointers are device pointers except `exponent`, which
// points to 12 host words; `stream` is a cudaStream_t.

extern "C" {

// `threads` a block: 32 (what the wrapper takes), 64 or 128.
int curdle_pow_fixed(const void* x, void* out, int n, const uint32_t* exponent,
                     int nbits, int threads, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nbits < 1 || (threads != 32 && threads != 64 && threads != 128))
    return (int)cudaErrorInvalidValue;
  Exponent e;
  for (int j = 0; j < curdle::NW; ++j) e.w[j] = exponent[j];
  const size_t table = (size_t)kPowEntries * sizeof(Fp) * threads;
  if (table > 48 * 1024) {  // 128 threads: 90 KB, above the default limit
    cudaError_t rc = cudaFuncSetAttribute(
        pow_fixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)table);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int blocks = (n + threads - 1) / threads;
  pow_fixed_kernel<<<blocks, threads, table, (cudaStream_t)stream>>>(
      (const Fp*)x, (Fp*)out, n, e, (nbits - 1) >> 2);
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

// The operand given: (sx, sy, sz)[n]. The outputs may be the accumulator's
// arrays.
int curdle_point_x16_add(const void* ax, const void* ay, const void* az,
                         const void* sx, const void* sy, const void* sz,
                         void* ox, void* oy, void* oz, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kStepPoints - 1) / kStepPoints;
  point_x16_add_kernel<<<blocks, kStepThreads, 0, (cudaStream_t)stream>>>(
      (const Fp*)ax, (const Fp*)ay, (const Fp*)az, (const Fp*)sx,
      (const Fp*)sy, (const Fp*)sz, nullptr, 0, 0, (Fp*)ox, (Fp*)oy, (Fp*)oz,
      n);
  return (int)cudaGetLastError();
}

// The operand selected from the table (tx, ty, tz)[9][n] by window w of
// digits[n][n_windows].
int curdle_point_x16_add_select(const void* ax, const void* ay, const void* az,
                                const void* tx, const void* ty, const void* tz,
                                const int32_t* digits, void* ox, void* oy,
                                void* oz, int n, int n_windows, int w,
                                void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (digits == nullptr || w < 0 || w >= n_windows)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kStepPoints - 1) / kStepPoints;
  point_x16_add_kernel<<<blocks, kStepThreads, 0, (cudaStream_t)stream>>>(
      (const Fp*)ax, (const Fp*)ay, (const Fp*)az, (const Fp*)tx,
      (const Fp*)ty, (const Fp*)tz, digits, n_windows, w, (Fp*)ox, (Fp*)oy,
      (Fp*)oz, n);
  return (int)cudaGetLastError();
}

// xb: [n, 48] bytes, wl: [n] bytes, out: [n, 13] words, pts: [3, n, 12]
// words.
int curdle_decode_points(const void* xb, const void* wl, void* out,
                         void* pts, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kDecodePoints - 1) / kDecodePoints;
  decode_points_kernel<<<blocks, kDecodeThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)xb, (const uint8_t*)wl, (int32_t*)out, (Fp*)pts, n);
  return (int)cudaGetLastError();
}

// words: [m, 8] canonical scalars, out: [2m, 33] digits.
int curdle_glv_recode(const void* words, void* out, int m, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const int blocks = (m + kRecodeThreads - 1) / kRecodeThreads;
  glv_recode_kernel<<<blocks, kRecodeThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int32_t*)out, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
