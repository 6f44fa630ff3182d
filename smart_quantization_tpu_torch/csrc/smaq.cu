// Fused SmaQ quantize->dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernel smart_quantization_tpu/ops/pallas/smaq_kernel.py::
// smaq_fused (body _kernel, lines 62-190) together with the one-pass
// statistics reduction its wrapper runs first (lines 245-278).  It computes
// what that kernel computes, not how: the TPU's 1024-lane rows, power-of-two
// row bucketing, zero padding with its pad correction, and the SMEM scratch
// carried across a sequential grid do not carry over.  Blocks on Hopper run
// in parallel and in no order, so a float32 tensor of more than a few
// thousand elements takes two launches, a small one takes one, and a
// bfloat16 one up to what shared memory holds takes one with a grid
// barrier:
//
//   smaq_stats     one pass over x.  Each warp computes the pivot (mean of
//                  the first min(n, 256) elements, which stay in L2) after
//                  its first loads are in flight; every thread accumulates
//                  sum(d) and sum(d*d) of d = x - pivot in double, plus min
//                  and max, and each block writes one partial.  The last
//                  block to finish (a fence and a ticket) folds the partials
//                  in a fixed order, in double, into mean and std (ddof=1,
//                  or the range estimator), applies the zero-std guard and
//                  the clamp and writes the per-tensor constants of
//                  smaq_kernel.py:119-130 (mean, std, a, std/range for
//                  each bucket, t*std; the TPU kernel's b = -mean/std is
//                  not kept) to a 32-byte buffer.  So the stats
//                  are folded once per call, as the TPU kernel derives its
//                  scalars once; no float atomics: the result does not
//                  depend on block order.
//   smaq_quantize  reads those constants (or derives them from a given
//                  (mean, std) pair), then one read and one write per
//                  element.  Rounding is trunc or floor(q + u), u the top 24
//                  bits of a counter-based Philox4x32-10 (philox.cuh) keyed
//                  by the step key in device memory and the call's index,
//                  and counted by element index from the call's element
//                  offset in a larger tensor (philox.cuh: Draws; 0 for a
//                  tensor of its own), so the output does not depend on
//                  the launch shape or walk order, nor on how a tensor is
//                  cut into parts.  The outlier count goes through a block reduction
//                  and one 64-bit integer atomicAdd per block that also
//                  draws the block's ticket; the block with the last ticket
//                  turns the count into the size in bits, on the device.
//                  The small form (stats mode kSmall) is one block of 1024
//                  threads that computes the stats itself, over the same
//                  code, reads x again from L1/L2 and quantizes: one launch,
//                  no atomics, where a tensor is a few thousand elements.
//   smaq_quantize_bn  the same pass with BatchNorm's per-channel (gamma,
//                  beta) folded in: the port of smaq_kernel.py::smaq_fused_bn
//                  (_kernel_bn 398-482).  Stats come from smaq_stats on the
//                  raw tensor, before the unfold (the reference quirk); gamma
//                  = 0 is taken as 1.  The tensor is NCHW, so the channel of
//                  element e is (e / (H*W)) % C; each block stages the
//                  folded constants of every channel in shared memory.
//
//                  Its bfloat16 form is a loop of its own (16-byte loads,
//                  a running channel, compile-time modes; see its note).
//
//   smaq_onepass   a bfloat16 full-stats call in one launch, with x kept in
//                  shared memory between the stats and the quantize pass
//                  (see its note below): 2 + 2 bytes an element from device
//                  memory, one cooperative launch on smaq_stats' grid, a
//                  grid barrier in place of the second launch.  It takes
//                  calls up to what the card's shared memory holds at 4
//                  resident blocks a SM (smaq_plan: about 14.6 M elements
//                  on 132 SMs); larger bfloat16 calls take the two launches.
//
// Element types: each kernel reads and writes float32 or bfloat16 (elem.cuh,
// the C interface's dtype argument).  The arithmetic is float32/float64 on
// the widened elements either way and every thread adds the same groups of
// four in the same order, so a bfloat16 call gives bit for bit the float32
// kernel's result on x.float(), rounded to nearest-even, with the same
// constants and size.  The two-launch bfloat16 path keeps the float32
// loops, launch shapes and small-form threshold (8 groups in flight, for
// as many bytes as float32's 4, ran no faster: PERF.md, PR 9).
//
// The counters (the stats ticket; the quantize tickets and outlier count) and the
// stats partials live in a workspace the wrapper zeroes once per (device,
// stream); the block that reads a counter last puts it back to 0, so no call
// needs a memset.  Launches on one stream run in order, so one workspace per
// stream is never used by two kernels at once.
//
// What bounds them: memory, and for small tensors the fixed cost of a
// launch.  The call moves 8 bytes per element at the least (one read, one
// write); the stats pass reads x a second time, from L2 as far as x still
// fits there.  In float32 the operations per element (about 20 float32
// operations, two float64 ones and a conversion in the stats pass, a
// quarter of a Philox call) are below the card's rates; at bfloat16's half
// the bytes they set the pace of the quantize pass (instruction issue:
// PERF.md, PR 9).  Both streaming loops keep kUnroll independent group
// loads in flight per thread, spaced a grid
// apart so every block has work even where x is one grid's worth, with
// enough blocks resident to fill every SM; and the quantize pass walks x
// from its end, the reverse of the stats pass, whose last loads are the
// likeliest still in L2.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "block_reduce.cuh"
#include "elem.cuh"
#include "philox.cuh"

namespace {

using smaq::bf16;
using smaq::block_sum;
using smaq::Group;
using smaq::group_aligned;
using smaq::load_group;
using smaq::load_raw;
using smaq::store_group;
using smaq::to_float;
using smaq::widen;

constexpr int kPivotElems = 256;
// group loads in flight per thread in the streaming loops
constexpr int kUnroll = 4;
// SMAQ_PHASES (a profiling build only): smaq_onepass records the global
// timer at each of its phases, per block (smaq_phase_times reads them).
#ifdef SMAQ_PHASES
__device__ unsigned long long g_phases[6][4096];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
#define PHASE(i) \
  if (threadIdx.x == 0) g_phases[i][blockIdx.x] = gtime();
#else
#define PHASE(i)
#endif
// the split form's blocks: 256 threads, at least 4 resident per SM (64
// registers a thread at most)
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;
// the small form's one block
constexpr int kSmallThreads = 1024;
// partials each thread of the last stats block loads at once
constexpr int kFoldLoads = 4;

// Workspace words (64-bit): the counters, then 4 doubles per stats block.
// The quantize word counts finished blocks in its top 24 bits and outliers
// in the low 40, so one atomicAdd a block does both, with no fence.  The
// one-launch form's grid barrier counts arrivals, and the last block adds
// one more once the constants are out.
constexpr int kStatsTicket = 0, kQuantCount = 1, kArrive = 2, kCounterWords = 4;
constexpr int kTicketShift = 40;

// Stats modes of the quantize kernels: a given (mean, std) pair; the
// constants smaq_stats wrote; the small form's own stats (one block).
constexpr int kGiven = 0, kConsts = 1, kSmall = 2;

struct QParams {
  float t, range_main, range_outlier, inv_range_main, inv_range_outlier, std_lo, std_hi;
  int bits_main, bits_outlier;
};

// The per-tensor constants, as smaq_kernel.py:121-130 derives them.
// No b = -mean * a: z is (x - mean) * a (see Quant).  Padded to 32 bytes,
// read as two float4.
struct __align__(16) Consts {
  float mean, std, a, inv_main_std, inv_out_std, t_std, unused0, unused1;
};

// The zero-std guard, the clamp, then the folded reciprocals.
__device__ Consts make_consts(float mean, float std, const QParams& p) {
  if (std == 0.f) std = 1.f;
  std = fminf(fmaxf(std, p.std_lo), p.std_hi);
  Consts c;
  c.mean = mean;
  c.std = std;
  c.a = 1.f / std;
  c.inv_main_std = std * p.inv_range_main;
  c.inv_out_std = std * p.inv_range_outlier;
  c.t_std = p.t * std;
  c.unused0 = c.unused1 = 0.f;
  return c;
}

struct Sums {
  double s1, s2;
  float mn, mx;
};

__device__ __forceinline__ Sums no_sums() { return Sums{0.0, 0.0, CUDART_INF_F, -CUDART_INF_F}; }

// One element into a thread's sums, shifted by the pivot.
__device__ __forceinline__ void acc(Sums& s, float e, float pivot) {
  const float d = e - pivot;
  s.s1 += d;
  s.s2 += static_cast<double>(d) * d;
  s.mn = fminf(s.mn, e);
  s.mx = fmaxf(s.mx, e);
}

__device__ __forceinline__ void acc4(Sums& s, float4 v, float pivot) {
  acc(s, v.x, pivot);
  acc(s, v.y, pivot);
  acc(s, v.z, pivot);
  acc(s, v.w, pivot);
}

__device__ __forceinline__ Sums warp_sums(Sums s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.s1 += __shfl_xor_sync(0xffffffffu, s.s1, off);
    s.s2 += __shfl_xor_sync(0xffffffffu, s.s2, off);
    s.mn = fminf(s.mn, __shfl_xor_sync(0xffffffffu, s.mn, off));
    s.mx = fmaxf(s.mx, __shfl_xor_sync(0xffffffffu, s.mx, off));
  }
  return s;
}

// The four reductions over the block in block_reduce.cuh's fixed order, in
// one round through shared memory; every thread gets the result.
__device__ Sums block_sums(Sums s, Sums* sm) {
  s = warp_sums(s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sm[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_sums(lane < static_cast<int>(blockDim.x >> 5) ? sm[lane] : no_sums());
    if (lane == 0) sm[0] = s;
  }
  __syncthreads();
  s = sm[0];
  __syncthreads();
  return s;
}

// The pivot, summed by each warp on its own: the xor butterfly leaves the
// same bits in every lane, and every warp of every block adds in the same
// order, so no block-wide barrier stands before the stream.
template <typename T>
__device__ float warp_pivot(const T* __restrict__ x, int64_t n) {
  const int n_pivot = n < kPivotElems ? static_cast<int>(n) : kPivotElems;
  float v[kPivotElems / 32];
#pragma unroll
  for (int k = 0; k < kPivotElems / 32; ++k) {  // all loads issued before the first add
    const int i = (threadIdx.x & 31) + 32 * k;
    v[k] = i < n_pivot ? to_float(x[i]) : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPivotElems / 32; ++k) s += v[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s / static_cast<float>(n_pivot);
}

// This thread's share of the one-pass sums.  The grid's threads cover one
// slice of x, a group of four elements each (elem.cuh); a thread takes the
// groups g0 + u * span (u < kUnroll, span = the grid's thread count) for g0
// = its index, then steps by kUnroll slices: kUnroll loads in flight, every
// block busy even where x is one slice, and the first loads issued before
// the pivot.  A thread adds its groups g0 + k * span in ascending k (the
// order smaq_onepass keeps).  The elements past the last whole group (all
// of them when x is not aligned to a group) go one per thread.  (Eight
// groups in flight for bf16, the next slice's loads issued before this one
// is added, ran no faster: PERF.md, PR 9.)
template <typename T>
__device__ Sums thread_sums(const T* __restrict__ x, int64_t n, float& pivot) {
  const int64_t n4 = group_aligned<T>(x) ? n >> 2 : 0;
  const int64_t span = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t g0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  typename Group<T>::Raw v[kUnroll];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g0 + u * span < n4) v[u] = load_raw(x, g0 + u * span);
  };
  load();
  pivot = warp_pivot(x, n);
  Sums s = no_sums();
  while (g0 < n4) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g0 + u * span < n4) acc4(s, widen(v[u]), pivot);
    g0 += span * kUnroll;
    load();
  }
  for (int64_t e = (n4 << 2) + blockIdx.x * blockDim.x + threadIdx.x; e < n; e += span)
    acc(s, to_float(x[e]), pivot);
  return s;
}

// Mean and std from the folded sums (ddof=1, or the range estimator), then
// the constants.
__device__ Consts finish_stats(const Sums& s, float pivot, int64_t n, int range_std,
                               const QParams& p) {
  const double nn = static_cast<double>(n);
  const float mean = static_cast<float>(static_cast<double>(pivot) + s.s1 / nn);
  float std;
  if (!range_std) {
    const double var = fmax((s.s2 - s.s1 * (s.s1 / nn)) / fmax(nn - 1.0, 1.0), 0.0);
    std = static_cast<float>(sqrt(var));
  } else {
    std = (s.mx - s.mn) / sqrtf(2.f * logf(static_cast<float>(n)));
  }
  return make_consts(mean, std, p);
}

// A block's sums as one partial: 4 doubles at partials[4 * blockIdx.x].
__device__ __forceinline__ void write_partial(double* partials, const Sums& s) {
  double* q = partials + 4 * static_cast<int64_t>(blockIdx.x);
  q[0] = s.s1;
  q[1] = s.s2;
  q[2] = s.mn;
  q[3] = s.mx;
}

// The partials of `blocks` blocks folded in a fixed order, in double:
// thread i takes partials i, i + kFoldLoads * blockDim.x, ..., then the
// block's tree; every thread gets the result.  The caller has seen every
// partial written (a fence after a ticket or a barrier); they are read
// from L2.
__device__ Sums fold_partials(const double* partials, int blocks, Sums* sm) {
  Sums f = no_sums();
  for (int i0 = threadIdx.x; i0 < blocks; i0 += kFoldLoads * blockDim.x) {
    double q[kFoldLoads][4];  // all loads issued before the first add
#pragma unroll
    for (int k = 0; k < kFoldLoads; ++k) {
      const int i = i0 + k * blockDim.x;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[k][j] = i < blocks ? __ldcg(partials + 4 * static_cast<int64_t>(i) + j) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < kFoldLoads; ++k) {
      if (i0 + k * static_cast<int>(blockDim.x) < blocks) {
        f.s1 += q[k][0];
        f.s2 += q[k][1];
        f.mn = fminf(f.mn, static_cast<float>(q[k][2]));
        f.mx = fmaxf(f.mx, static_cast<float>(q[k][3]));
      }
    }
  }
  return block_sums(f, sm);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
smaq_stats_kernel(const T* __restrict__ x, int64_t n, int range_std, QParams p,
                  unsigned long long* __restrict__ ws, Consts* __restrict__ out,
                  double* __restrict__ sums) {
  __shared__ Sums sm[32];
  __shared__ bool last;
  double* partials = reinterpret_cast<double*>(ws + kCounterWords);

  float pivot;
  const Sums s = block_sums(thread_sums(x, n, pivot), sm);
  if (threadIdx.x == 0) {
    write_partial(partials, s);
    __threadfence();
    last = atomicAdd(&ws[kStatsTicket], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written; fold them in a fixed order
  __threadfence();
  const Sums f = fold_partials(partials, gridDim.x, sm);
  if (threadIdx.x == 0) {
    *out = finish_stats(f, pivot, n, range_std, p);
    if (sums != nullptr) {  // the folded sums, for a reduction over ranks
      sums[0] = f.s1;
      sums[1] = f.s2;
      sums[2] = f.mn;
      sums[3] = f.mx;
      sums[4] = pivot;
    }
    ws[kStatsTicket] = 0;
  }
}

// kRound: kRuntime takes the rounding mode and the clamp from `stochastic`
// and `all_positive`; otherwise they are fixed at compile time (the
// one-launch form's instances, so that the issue-bound loop evaluates one
// rounding, not both and a select): kTrunc or kStochastic, plus kPositive
// for all_positive.
constexpr int kRuntime = 0, kTrunc = 1, kStochastic = 2, kPositive = 4;

template <int kRound = kRuntime>
struct Quant {
  Consts c;
  float t, range_main, range_outlier;
  bool stochastic, all_positive;

  // z = (x - mean) / std; q = round((z + shift) * scale);
  // y = q * std / scale + shift * std + mean.
  // z is (x - mean) * a, the subtraction first: the TPU kernel's folded
  // x * a + b (a = 1/std, b = -mean/std) cancels where |mean| >> std and put about 2 %
  // of such a tensor's elements a grid step from the plain version's.
  // Each rounding step is written out (intrinsics are never contracted), so
  // every walk of every kernel gives the same bits.  Left to the compiler,
  // the stochastic add fused with the product before it in some inlined
  // copies (the element-by-element walks) and not in others (the group
  // walks): a misaligned tensor then rounded differently.  y by FMA, the
  // stochastic add after the rounded product.
  __device__ __forceinline__ float operator()(float x, uint32_t bits, int& cnt) const {
    const float z = __fmul_rn(__fsub_rn(x, c.mean), c.a);
    const bool hi = z > t, lo = z < -t, out = hi || lo;
    const float shift = hi ? -t : (lo ? t : 0.f);
    const float scale = out ? range_outlier : range_main;
    const float q0 = __fmul_rn(__fadd_rn(z, shift), scale);
    const float u = static_cast<float>(bits >> 8) * 0x1p-24f;  // exact
    const bool sto = kRound == kRuntime ? stochastic : (kRound & kStochastic) != 0;
    const float q = sto ? floorf(__fadd_rn(q0, u)) : truncf(q0);
    const float inv = out ? c.inv_out_std : c.inv_main_std;
    const float st = hi ? c.t_std : (lo ? -c.t_std : 0.f);
    float y = __fadd_rn(__fmaf_rn(q, inv, st), c.mean);
    const bool pos = kRound == kRuntime ? all_positive : (kRound & kPositive) != 0;
    if (pos && y < 0.f) y = 0.f;
    cnt += out;
    return y;
  }
};

// Four elements of a group with their four Philox words.
template <int kRound>
__device__ __forceinline__ float4 quantize4(const Quant<kRound>& qz, float4 v, uint4 r, int& cnt) {
  float4 o;
  o.x = qz(v.x, r.x, cnt);
  o.y = qz(v.y, r.y, cnt);
  o.z = qz(v.z, r.z, cnt);
  o.w = qz(v.w, r.w, cnt);
  return o;
}

template <int kRound = kRuntime>
__device__ __forceinline__ Quant<kRound> make_quant(const Consts& c, const QParams& p,
                                                    int stochastic, int all_positive) {
  Quant<kRound> qz;
  qz.c = c;
  qz.t = p.t;
  qz.range_main = p.range_main;
  qz.range_outlier = p.range_outlier;
  qz.stochastic = stochastic != 0;
  qz.all_positive = all_positive != 0;
  return qz;
}

// The size in bits from the block's outlier count.  One block writes it
// directly; otherwise each block adds (1 ticket, its count) to the quantize
// word in one 64-bit atomicAdd, and the block that draws the last ticket
// finds every count in the sum, writes the size and puts the word back to 0.
// With `barrier` (the one-launch form) every block draws a ticket even
// without the count, and the last one also puts the grid barrier's word
// back to 0: every block has passed the barrier by then.
__device__ void write_size(int cnt, int64_t n, int compute_size, const QParams& p,
                           unsigned long long* __restrict__ ws, float* __restrict__ size_out,
                           unsigned long long* su, bool barrier = false) {
  const float floor_size = static_cast<float>(static_cast<double>(n) * p.bits_main);
  if (!compute_size && !barrier) {
    if (blockIdx.x == 0 && threadIdx.x == 0) size_out[0] = floor_size;
    return;
  }
  const unsigned long long block_cnt =
      compute_size ? block_sum(static_cast<unsigned long long>(cnt), su) : 0ull;
  if (threadIdx.x != 0) return;
  unsigned long long total = block_cnt;
  if (gridDim.x > 1) {
    const unsigned long long mine = (1ull << kTicketShift) + block_cnt;
    const unsigned long long before = atomicAdd(&ws[kQuantCount], mine);
    if ((before >> kTicketShift) != gridDim.x - 1) return;
    total = (before + mine) & ((1ull << kTicketShift) - 1);
    ws[kQuantCount] = 0;
  }
  if (barrier) ws[kArrive] = 0;
  size_out[0] = compute_size
                    ? static_cast<float>(static_cast<double>(n) * p.bits_main +
                                         static_cast<double>(total) * (p.bits_outlier - p.bits_main))
                    : floor_size;
}

// Launched with kThreads-thread blocks, or as one block of kSmallThreads in
// the small form.  kOffset: an element offset other than 0 (philox.cuh:
// Draws).
template <typename T, bool kOffset = false>
__global__ void __launch_bounds__(kSmallThreads)
smaq_quantize_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                     const float* __restrict__ stats, const Consts* __restrict__ consts,
                     int stats_mode, int range_std, const unsigned long long* __restrict__ key,
                     unsigned int call, long long offset, int stochastic,
                     int all_positive, int compute_size, QParams p,
                     unsigned long long* __restrict__ ws, float* __restrict__ size_out) {
  __shared__ Sums sm[32];
  __shared__ unsigned long long su[32];

  Consts c;
  if (stats_mode == kConsts) {
    c = *consts;
  } else if (stats_mode == kGiven) {
    c = make_consts(stats[0], stats[1], p);
  } else {
    float pivot;
    const Sums s = block_sums(thread_sums(x, n, pivot), sm);
    c = finish_stats(s, pivot, n, range_std, p);
  }
  const auto qz = make_quant(c, p, stochastic, all_positive);

  const smaq::Draws d = qz.stochastic ? smaq::draws(key, call, offset) : smaq::Draws{};
  const int64_t n4 = group_aligned<T>(x) && group_aligned<T>(y) ? n >> 2 : 0;
  const int64_t span = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int cnt = 0;
  // as thread_sums walks x, but from its end: group i of the walk is group
  // n4 - 1 - i of x
  // (eight groups in flight for bf16 spilled under the small form's 64
  // registers and ran slower: PERF.md, PR 9)
  for (int64_t g0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g0 < n4;
       g0 += span * kUnroll) {
    typename Group<T>::Raw v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = g0 + u * span;
      if (i < n4) v[u] = load_raw(x, n4 - 1 - i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = g0 + u * span;
      if (i < n4) {
        const int64_t g = n4 - 1 - i;
        const uint4 r =
            qz.stochastic ? smaq::group_words<kOffset>(d, g) : make_uint4(0u, 0u, 0u, 0u);
        store_group(y, g, quantize4(qz, widen(v[u]), r, cnt));
      }
    }
  }
  // the elements past the last whole group (all of them when unaligned)
  for (int64_t e = (n4 << 2) + blockIdx.x * blockDim.x + threadIdx.x; e < n; e += span) {
    y[e] = smaq::from_float<T>(
        qz(to_float(x[e]), qz.stochastic ? smaq::element_word(d, e) : 0u, cnt));
  }
  write_size(cnt, n, compute_size, p, ws, size_out, su);
}

// ---------------------------------------------------------------------------
// The one-launch form of a bfloat16 full-stats call (smaq_onepass).  It
// launches cooperatively on smaq_stats' grid (so every block is resident,
// BLOCKS_PER_SM on each SM), each block with as much dynamic shared memory
// as BLOCKS_PER_SM a SM leave it: `slots` 8-byte slots a thread.
//
// 1. Each thread copies its groups g0 + k * span (thread_sums' walk) into
//    its first slots with cp.async, all in flight at once, and takes the
//    pivot while they fly; x is read from device memory once.
// 2. It adds its groups from shared memory in ascending k, as thread_sums
//    does, and the block writes its partial as smaq_stats does.
// 3. A grid barrier: the last block to arrive folds the partials in
//    smaq_stats' order into the same Consts, writes them out and adds one
//    more to the arrival word.  The others, while they wait, compute
//    (rounding stochastically) the Philox words of as many of their groups
//    as the slots left over hold, 16 bytes a group: the quantize pass is
//    bound by instruction issue, and the wait is idle; then they read the
//    constants.  So the constants, the output and the size are bit for
//    bit the two-launch form's.  (Every block folding for itself was
//    slower: 528 blocks read the same partials from L2.)
// 4. Each block quantizes its own groups from shared memory (Philox by
//    group index, from shared memory where step 3 computed it) and writes
//    y; the outlier count and the last ticket go through write_size, whose
//    last block puts the arrival word back to 0.
//
// A misaligned x is held element by element (thread_sums' walk for it).

constexpr int kSlotBytes = 8;  // one group of four bf16

__device__ __forceinline__ float widen_bf16(unsigned short bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long add_acq_rel(unsigned long long* p,
                                                          unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;\n"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void add_release(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned v;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(v));
  return v;
}

__device__ __forceinline__ Consts load_consts_l2(const Consts* c) {
  const float4* q = reinterpret_cast<const float4*>(c);
  const float4 a = __ldcg(q), b = __ldcg(q + 1);
  return Consts{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

template <bool kSto, bool kPos, bool kOffset = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
smaq_onepass_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int64_t n, int range_std,
                    const unsigned long long* __restrict__ key, unsigned int call,
                    long long offset, int compute_size, QParams p,
                    unsigned long long* __restrict__ ws, Consts* __restrict__ consts,
                    float* __restrict__ size_out) {
  __shared__ Sums sm[32];
  __shared__ unsigned long long su[32];
  __shared__ Consts cs;
  __shared__ bool last;
  extern __shared__ uint2 held[];  // [slot][thread]
  unsigned short* held1 = reinterpret_cast<unsigned short*>(held);  // misaligned x
  double* partials = reinterpret_cast<double*>(ws + kCounterWords);

  PHASE(0)
  const int t = threadIdx.x, nt = blockDim.x;
  const unsigned blocks = gridDim.x;
  const bool vec = group_aligned<bf16>(x);
  const int64_t n4 = vec ? n >> 2 : 0;
  const int64_t span = static_cast<int64_t>(blocks) * nt;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * nt + t;
  // 1. the loads: groups (or, misaligned, elements) g0 + k * span, and an
  // aligned x's element of the ragged tail (at most one a thread)
  int m = 0;
  if (vec) {
    const uint2* xg = reinterpret_cast<const uint2*>(x);
    for (int64_t g = g0; g < n4; g += span, ++m) cp_async8(held + m * nt + t, xg + g);
  } else {
    for (int64_t e = g0; e < n; e += span, ++m) held1[m * nt + t] = __bfloat16_as_ushort(x[e]);
  }
  const int64_t e_tail = (n4 << 2) + g0;
  const bool has_tail = vec && e_tail < n;
  const float tail = has_tail ? to_float(x[e_tail]) : 0.f;
  const float pivot = warp_pivot(x, n);
  constexpr bool st = kSto;
  const smaq::Draws d = st ? smaq::draws(key, call, offset) : smaq::Draws{};
  cp_async_wait_all();
  PHASE(1)

  // 2. this thread's sums in thread_sums' order, the block's partial
  Sums s = no_sums();
  if (vec) {
    for (int k = 0; k < m; ++k) acc4(s, widen(held[k * nt + t]), pivot);
    if (has_tail) acc(s, tail, pivot);
  } else {
    for (int k = 0; k < m; ++k) acc(s, widen_bf16(held1[k * nt + t]), pivot);
  }
  s = block_sums(s, sm);
  if (t == 0) {
    write_partial(partials, s);
    // release: the partial before the count; acquire: the last block sees them all
    last = add_acq_rel(&ws[kArrive], 1ull) == blocks - 1;
  }
  PHASE(2)

  // 3. the barrier: the last block folds and publishes; the others, until
  // it has, compute the Philox words of this thread's first `pre` groups
  // into the slots past every thread's groups ([group][thread], 16 bytes)
  const int x_slots = static_cast<int>((n4 + span - 1) / span);
  uint4* words = reinterpret_cast<uint4*>(held + x_slots * nt);
  const int spare = static_cast<int>(dynamic_smem_bytes() / (nt * kSlotBytes)) - x_slots;
  int pre = 0;
  __syncthreads();
  if (last) {
    const Sums f = fold_partials(partials, blocks, sm);
    if (t == 0) {
      cs = finish_stats(f, pivot, n, range_std, p);
      *consts = cs;
      add_release(&ws[kArrive], 1ull);  // blocks + 1, with release: the constants are out
    }
    PHASE(3)
  } else {
    pre = vec && st ? min(m, spare / 2) : 0;
    for (int k = 0; k < pre; ++k)
      words[k * nt + t] = smaq::group_words<kOffset>(d, g0 + k * span);
    if (t == 0) {
      while (load_acquire(&ws[kArrive]) <= blocks) {
      }
      PHASE(3)
      cs = load_consts_l2(consts);
    }
  }
  __syncthreads();
  PHASE(4)

  // 4. quantize the held groups
  const auto qz =
      make_quant<(kSto ? kStochastic : kTrunc) | (kPos ? kPositive : 0)>(cs, p, kSto, kPos);
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  int cnt = 0;
  if (vec) {
    const bool yvec = group_aligned<bf16>(y);
    auto quantize_group = [&](int k, uint4 r) {
      const int64_t g = g0 + k * span;
      const float4 o = quantize4(qz, widen(held[k * nt + t]), r, cnt);
      if (yvec) {
        store_group(y, g, o);
      } else {
        y[4 * g] = smaq::from_float<bf16>(o.x);
        y[4 * g + 1] = smaq::from_float<bf16>(o.y);
        y[4 * g + 2] = smaq::from_float<bf16>(o.z);
        y[4 * g + 3] = smaq::from_float<bf16>(o.w);
      }
    };
#pragma unroll 4
    for (int k = 0; k < pre; ++k) quantize_group(k, words[k * nt + t]);
#pragma unroll 4
    for (int k = pre; k < m; ++k)
      quantize_group(k, st ? smaq::group_words<kOffset>(d, g0 + k * span) : none);
    if (has_tail)
      y[e_tail] = smaq::from_float<bf16>(qz(tail, st ? smaq::element_word(d, e_tail) : 0u, cnt));
  } else {
    for (int k = 0; k < m; ++k) {
      const int64_t e = g0 + k * span;
      y[e] = smaq::from_float<bf16>(
          qz(widen_bf16(held1[k * nt + t]), st ? smaq::element_word(d, e) : 0u, cnt));
    }
  }
  write_size(cnt, n, compute_size, p, ws, size_out, su, true);
  PHASE(5)
}

// BatchNorm-folded SmaQ, the port of smaq_kernel.py::_kernel_bn (398-482):
// per channel c, k = (A, G, H, 0) with A = 1 / (g_c * std), G = std * g_c,
// H = mean * g_c + beta_c and g_c = gamma_c, or 1 where gamma_c == 0.
// z = (x - H) * A (the subtraction first, as the plain quantizer's
// (x - mean) / std: the TPU kernel's x * A + B cancels where |H| >> g * std),
// then the SmaQ buckets and rounding, zhat = q / scale - shift,
// y = zhat * G + H.
//
// Both are written with intrinsics (H, zhat and y by FMA; the product
// (z + shift) * scale rounded, then the stochastic add), so that every walk
// of both element types gives the same bits.  Left
// to the compiler, one copy of the element-by-element walk in its SASS
// fused the stochastic add with that product (one FMA), which can round an
// element to the other grid point.
// (A, G, H) of a channel; the fourth lane is padding, so that a channel's
// constants are one 16-byte shared-memory load.
__device__ __forceinline__ float4 bn_channel(float gamma, float beta, float mean, float std) {
  const float g = gamma == 0.f ? 1.f : gamma;
  return make_float4(__frcp_rn(__fmul_rn(g, std)), __fmul_rn(std, g), __fmaf_rn(mean, g, beta),
                     0.f);
}

// kRound as Quant's: runtime flags, or the mode and the clamp fixed at
// compile time (the bfloat16 loop's instances).
template <int kRound = kRuntime>
struct QuantBN {
  float t, range_main, range_outlier, inv_range_main, inv_range_outlier;
  bool stochastic, all_positive;

  __device__ __forceinline__ float operator()(float x, float4 k, uint32_t bits, int& cnt) const {
    const float z = __fmul_rn(__fsub_rn(x, k.z), k.x);
    const bool hi = z > t, lo = z < -t, out = hi || lo;
    const float shift = hi ? -t : (lo ? t : 0.f);
    const float q0 = __fmul_rn(__fadd_rn(z, shift), out ? range_outlier : range_main);
    const float u = static_cast<float>(bits >> 8) * 0x1p-24f;  // exact
    const bool sto = kRound == kRuntime ? stochastic : (kRound & kStochastic) != 0;
    const float q = sto ? floorf(__fadd_rn(q0, u)) : truncf(q0);
    const float zhat = __fmaf_rn(q, out ? inv_range_outlier : inv_range_main, -shift);
    float y = __fmaf_rn(zhat, k.y, k.z);
    const bool pos = kRound == kRuntime ? all_positive : (kRound & kPositive) != 0;
    if (pos && y < 0.f) y = 0.f;
    cnt += out;
    return y;
  }
};

// The channel of element e of an (outer, channels, inner) tensor, (e /
// inner) % channels, in 32-bit index arithmetic where it fits (64-bit
// division is a long software routine).
struct ChannelOf {
  int64_t inner;
  int channels;
  bool small;

  __device__ __forceinline__ int operator()(int64_t e) const {
    return small ? static_cast<int>((static_cast<uint32_t>(e) / static_cast<uint32_t>(inner)) %
                                    static_cast<uint32_t>(channels))
                 : static_cast<int>((e / inner) % channels);
  }
};

// x is (outer, channels, inner) in memory (NCHW: inner = H * W); element e
// is in channel (e / inner) % channels.  The per-channel constants live in
// dynamic shared memory, one float4 per channel.
template <typename T, bool kOffset = false>
__global__ void smaq_quantize_bn_kernel(
    const T* __restrict__ x, T* __restrict__ y, int64_t n,
    const float* __restrict__ stats, const Consts* __restrict__ consts, int stats_mode,
    const float* __restrict__ gamma, const float* __restrict__ beta, int channels,
    int64_t inner, const unsigned long long* __restrict__ key, unsigned int call,
    long long offset, int stochastic, int all_positive, int compute_size,
    QParams p, unsigned long long* __restrict__ ws, float* __restrict__ size_out) {
  __shared__ unsigned long long su[32];
  extern __shared__ float4 chan[];

  const Consts cs = stats_mode == kConsts ? *consts : make_consts(stats[0], stats[1], p);
  for (int c = threadIdx.x; c < channels; c += blockDim.x)
    chan[c] = bn_channel(gamma[c], beta[c], cs.mean, cs.std);
  __syncthreads();

  QuantBN<> qz{p.t, p.range_main, p.range_outlier, p.inv_range_main, p.inv_range_outlier,
               stochastic != 0, all_positive != 0};
  // a float4 group lies in one channel when inner % 4 == 0
  const ChannelOf chan_of{inner, channels, n <= 0xFFFFFFFFll};
  const bool group_in_one = (inner & 3) == 0;
  const smaq::Draws d = qz.stochastic ? smaq::draws(key, call, offset) : smaq::Draws{};
  const bool aligned = group_aligned<T>(x) && group_aligned<T>(y);
  const int64_t groups = (n + 3) >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int cnt = 0;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const uint4 r =
        qz.stochastic ? smaq::group_words<kOffset>(d, g) : make_uint4(0u, 0u, 0u, 0u);
    const int64_t e = g << 2;
    if (aligned && group_in_one && e + 3 < n) {
      const float4 k = chan[chan_of(e)];
      const float4 v = load_group(x, g);
      float4 o;
      o.x = qz(v.x, k, r.x, cnt);
      o.y = qz(v.y, k, r.y, cnt);
      o.z = qz(v.z, k, r.z, cnt);
      o.w = qz(v.w, k, r.w, cnt);
      store_group(y, g, o);
    } else {
      const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && e + j < n; ++j)
        y[e + j] = smaq::from_float<T>(qz(to_float(x[e + j]), chan[chan_of(e + j)], rw[j], cnt));
    }
  }
  write_size(cnt, n, compute_size, p, ws, size_out, su);
}

// ---------------------------------------------------------------------------
// The bfloat16 form of smaq_quantize_bn.  The float32 loop above takes one
// group of four a thread a step with no load in flight, two 32-bit divisions
// for its channel and runtime rounding flags: at half the bytes those, not
// memory, set its pace (31.7 us at 8 M elements against a 10 us bound,
// PERF.md).  This one reads 16 bytes (8 bf16, two groups) a thread a step
// with the next load in flight, on kMinBlocks blocks a SM (bn_blocks);
// each thread keeps a running (plane, offset, channel) of its chunk and
// steps it by the grid's stride, so a chunk's channel costs a few integer
// adds; and the rounding mode and all_positive are compile-time.  It needs
// inner % 4 == 0 (a group lies in one channel) or one channel; otherwise,
// and where x or y is not 16-byte aligned, groups go element by element
// with the float32 loop's division.  The element op is QuantBN's, so the
// bits are the float32 kernel's on x.float().

// Two elements of a word of two bf16 with their words of Philox.
template <int kRound>
__device__ __forceinline__ uint32_t bn_word(const QuantBN<kRound>& qz, uint32_t w,
                                            float4 k, uint32_t r0, uint32_t r1, int& cnt) {
  return smaq::pack_bf16x2(qz(smaq::widen_lo(w), k, r0, cnt), qz(smaq::widen_hi(w), k, r1, cnt));
}

template <bool kSto, bool kPos, bool kOffset = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
smaq_quantize_bn_bf16_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ y, int64_t n,
    const float* __restrict__ stats, const Consts* __restrict__ consts, int stats_mode,
    const float* __restrict__ gamma, const float* __restrict__ beta, int channels,
    int64_t inner, const unsigned long long* __restrict__ key, unsigned int call,
    long long offset, int compute_size, QParams p, unsigned long long* __restrict__ ws,
    float* __restrict__ size_out) {
  __shared__ unsigned long long su[32];
  extern __shared__ float4 chan[];

  const bool chunked = channels == 1 || (inner & 3) == 0;
  const bool wide =
      chunked && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t chunks = wide ? n >> 3 : 0;  // 16-byte chunks: groups 2c and 2c + 1
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  uint4 v = make_uint4(0u, 0u, 0u, 0u), next = v;
  if (first < chunks) v = xv[first];  // in flight while the block stages the channels

  const Consts cs = stats_mode == kConsts ? *consts : make_consts(stats[0], stats[1], p);
  for (int c = threadIdx.x; c < channels; c += blockDim.x)
    chan[c] = bn_channel(gamma[c], beta[c], cs.mean, cs.std);
  __syncthreads();

  const QuantBN<(kSto ? kStochastic : kTrunc) | (kPos ? kPositive : 0)> qz{
      p.t, p.range_main, p.range_outlier, p.inv_range_main, p.inv_range_outlier, kSto, kPos};
  const smaq::Draws d = kSto ? smaq::draws(key, call, offset) : smaq::Draws{};
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  int cnt = 0;
  // chunk c starts at element 8c, offset r in its plane, plane q of channel
  // ch; a step of `stride` chunks moves 8 * stride elements: dq planes and
  // dr more, dch channels
  int64_t r = (8 * first) % inner;
  int ch = static_cast<int>((8 * first) / inner % channels);
  const int64_t dq = 8 * stride / inner, dr = 8 * stride % inner;
  const int dch = static_cast<int>(dq % channels);
  for (int64_t c = first; c < chunks; c += stride) {
    if (c + stride < chunks) next = xv[c + stride];
    // the chunk's second group starts 4 elements on: in the next plane where
    // the first ends one
    const int ch2 = r + 4 < inner ? ch : (ch + 1 == channels ? 0 : ch + 1);
    const float4 ka = chan[ch], kb = chan[ch2];
    const uint4 r0 = kSto ? smaq::group_words<kOffset>(d, 2 * c) : none;
    const uint4 r1 = kSto ? smaq::group_words<kOffset>(d, 2 * c + 1) : none;
    yv[c] = make_uint4(bn_word(qz, v.x, ka, r0.x, r0.y, cnt), bn_word(qz, v.y, ka, r0.z, r0.w, cnt),
                       bn_word(qz, v.z, kb, r1.x, r1.y, cnt), bn_word(qz, v.w, kb, r1.z, r1.w, cnt));
    v = next;
    r += dr;
    const bool carry = r >= inner;
    r -= carry ? inner : 0;
    ch += dch + carry;
    ch -= ch >= channels ? channels : 0;
  }
  // the groups past the last whole chunk (all of them where the chunks do
  // not apply), element by element with the float32 loop's channel
  const ChannelOf chan_of{inner, channels, n <= 0xFFFFFFFFll};
  const int64_t groups = (n + 3) >> 2;
  for (int64_t g = 2 * chunks + first; g < groups; g += stride) {
    const uint4 rg = kSto ? smaq::group_words<kOffset>(d, g) : none;
    const uint32_t rw[4] = {rg.x, rg.y, rg.z, rg.w};
    for (int j = 0; j < 4 && 4 * g + j < n; ++j) {
      const int64_t e = 4 * g + j;
      y[e] = smaq::from_float<bf16>(qz(to_float(x[e]), chan[chan_of(e)], rw[j], cnt));
    }
  }
  write_size(cnt, n, compute_size, p, ws, size_out, su);
}

// The instances: [4 * has_offset + 2 * stochastic + all_positive].
using BnBf16Kernel = decltype(&smaq_quantize_bn_bf16_kernel<false, false>);
const BnBf16Kernel kBnBf16Kernels[] = {
    smaq_quantize_bn_bf16_kernel<false, false>, smaq_quantize_bn_bf16_kernel<false, true>,
    smaq_quantize_bn_bf16_kernel<true, false>, smaq_quantize_bn_bf16_kernel<true, true>,
    smaq_quantize_bn_bf16_kernel<false, false, true>,
    smaq_quantize_bn_bf16_kernel<false, true, true>,
    smaq_quantize_bn_bf16_kernel<true, false, true>,
    smaq_quantize_bn_bf16_kernel<true, true, true>};

QParams qparams(float t, float range_main, float range_outlier, float inv_range_main,
                float inv_range_outlier, float std_lo, float std_hi, int bits_main,
                int bits_outlier) {
  return QParams{t, range_main, range_outlier, inv_range_main, inv_range_outlier,
                 std_lo, std_hi, bits_main, bits_outlier};
}

// The element types of the C interface's `dtype` argument.
constexpr int kFloat32 = 0, kBFloat16 = 1;

template <typename T>
void launch_stats(const void* x, long long n, int range_std, const QParams& p,
                  unsigned long long* ws, float* consts, double* sums, int num_blocks,
                  int threads, cudaStream_t stream) {
  smaq_stats_kernel<T><<<num_blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int64_t>(n), range_std, p, ws,
      reinterpret_cast<Consts*>(consts), sums);
}

template <typename T>
void launch_quantize(const void* x, void* y, long long n, const float* stats,
                     const float* consts, int stats_mode, int range_std,
                     const unsigned long long* key, unsigned int call, long long offset,
                     int stochastic, int all_positive, int compute_size, const QParams& p,
                     unsigned long long* ws, float* size_out, int num_blocks, int threads,
                     cudaStream_t stream) {
  const auto kernel = smaq::has_offset(offset) ? smaq_quantize_kernel<T, true>
                                               : smaq_quantize_kernel<T, false>;
  kernel<<<num_blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n), stats,
      reinterpret_cast<const Consts*>(consts), stats_mode, range_std, key, call, offset,
      stochastic, all_positive, compute_size, p, ws, size_out);
}

// The kernel's instances: [4 * has_offset + 2 * stochastic + all_positive].
using OnepassKernel = decltype(&smaq_onepass_kernel<false, false>);
const OnepassKernel kOnepassKernels[] = {
    smaq_onepass_kernel<false, false>,       smaq_onepass_kernel<false, true>,
    smaq_onepass_kernel<true, false>,        smaq_onepass_kernel<true, true>,
    smaq_onepass_kernel<false, false, true>, smaq_onepass_kernel<false, true, true>,
    smaq_onepass_kernel<true, false, true>,  smaq_onepass_kernel<true, true, true>};

// The dynamic shared memory a block of smaq_onepass may take with `blocks`
// blocks of `threads` resident on each SM of the current card: the SM's
// shared memory split `blocks` ways, less the reserve of each block and
// the kernel's static shared memory, within the opt-in limit of a block;
// 0 where registers or threads do not let `blocks` blocks be resident.
// (cudaOccupancyAvailableDynamicSMemPerBlock answers 48 KB less the static
// part whatever the opt-in, and the occupancy query 0 blocks above it,
// though cooperative launches up to this size run: measured, PERF.md.)
cudaError_t onepass_smem(int blocks, int threads, long long* bytes) {
  int dev = 0, per_sm = 0, reserved = 0, optin = 0, resident = 1 << 30;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) ||
      (e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) ||
      (e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) ||
      (e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  long long stat = 0;
  for (const OnepassKernel kernel : kOnepassKernels) {
    cudaFuncAttributes a;
    int r = 0;
    if ((e = cudaFuncGetAttributes(&a, kernel)) ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, kernel, threads, 0)))
      return e;
    if (static_cast<long long>(a.sharedSizeBytes) > stat) stat = a.sharedSizeBytes;
    if (r < resident) resident = r;
  }
  long long avail = per_sm / blocks - reserved - stat;
  if (avail > optin - stat) avail = optin - stat;
  *bytes = resident >= blocks && avail > 0 ? avail : 0;
  return cudaSuccess;
}

// Once per card: the kernel's opt-in to that much dynamic shared memory
// (above 48 KB a kernel must ask) and to the largest shared-memory carveout
// of the SM's 256 KB (the default caps 4 blocks at 196 KB); returns the
// bytes a block of kThreads gets, kMinBlocks a SM.
cudaError_t onepass_setup(long long* bytes) {
  static long long got[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && got[dev] > 0) {
    *bytes = got[dev];
    return cudaSuccess;
  }
  if ((e = onepass_smem(kMinBlocks, kThreads, bytes))) return e;
  for (const OnepassKernel kernel : kOnepassKernels)
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(*bytes))) ||
        (e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared)))
      return e;
  if (dev < 64) got[dev] = *bytes;
  return cudaSuccess;
}

cudaError_t launch_onepass(const void* x, void* y, long long n, int range_std,
                           const unsigned long long* key, unsigned int call, long long offset,
                           int stochastic, int all_positive, int compute_size, const QParams& p,
                           unsigned long long* ws, float* consts, float* size_out,
                           int num_blocks, int threads, cudaStream_t stream) {
  long long bytes = 0;
  cudaError_t e = onepass_setup(&bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_blocks);
  cfg.blockDim = dim3(threads);
  // every block takes all the shared memory it can have: x's slots, then
  // the Philox words of the slots to spare
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg,
                            kOnepassKernels[4 * smaq::has_offset(offset) +
                                            2 * (stochastic != 0) + (all_positive != 0)],
                            static_cast<const bf16*>(x), static_cast<bf16*>(y),
                            static_cast<int64_t>(n), range_std, key, call, offset, compute_size,
                            p, ws, reinterpret_cast<Consts*>(consts), size_out);
}

template <typename T>
void launch_quantize_bn(const void* x, void* y, long long n, const float* stats,
                        const float* consts, int stats_mode, const float* gamma,
                        const float* beta, int channels, long long inner,
                        const unsigned long long* key, unsigned int call, long long offset,
                        int stochastic, int all_positive, int compute_size, const QParams& p,
                        unsigned long long* ws, float* size_out, int num_blocks, int threads,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(channels) * sizeof(float4);
  if constexpr (std::is_same<T, bf16>::value) {
    kBnBf16Kernels[4 * smaq::has_offset(offset) + 2 * (stochastic != 0) + (all_positive != 0)]
        <<<num_blocks, threads, smem, stream>>>(
            static_cast<const bf16*>(x), static_cast<bf16*>(y), static_cast<int64_t>(n), stats,
            reinterpret_cast<const Consts*>(consts), stats_mode, gamma, beta, channels,
            static_cast<int64_t>(inner), key, call, offset, compute_size, p, ws, size_out);
    return;
  }
  const auto kernel = smaq::has_offset(offset) ? smaq_quantize_bn_kernel<T, true>
                                               : smaq_quantize_bn_kernel<T, false>;
  kernel<<<num_blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n), stats,
      reinterpret_cast<const Consts*>(consts), stats_mode, gamma, beta, channels,
      static_cast<int64_t>(inner), key, call, offset, stochastic, all_positive, compute_size, p,
      ws, size_out);
}

}  // namespace

extern "C" {

// The entry points launch on `stream` and return cudaGetLastError()
// (cudaErrorInvalidValue for a `dtype` they do not take).  `x` and `y` hold
// float32 (dtype 0) or bfloat16 (dtype 1) elements; everything else is
// float32.  `ws` is the stream's workspace: kCounterWords 64-bit words, zero
// between calls, then 4 doubles per stats block.  `consts` holds 8 floats,
// 16-byte aligned.  smaq_stats' `sums`, unless NULL, gets the folded sums
// the constants come from, 5 doubles: sum(d), sum(d * d), min, max (of x)
// and the pivot (d = x - pivot), for a reduction over ranks.  The quantize
// entry points give element e the random word of element offset + e
// (philox.cuh: Draws).

int smaq_stats(const void* x, long long n, int dtype, int range_std, float t,
               float range_main, float range_outlier, float inv_range_main,
               float inv_range_outlier, float std_lo, float std_hi, int bits_main,
               int bits_outlier, unsigned long long* ws, float* consts, double* sums,
               int num_blocks, int threads, void* stream) {
  const QParams p = qparams(t, range_main, range_outlier, inv_range_main, inv_range_outlier,
                            std_lo, std_hi, bits_main, bits_outlier);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_stats<float>(x, n, range_std, p, ws, consts, sums, num_blocks, threads, s);
  else if (dtype == kBFloat16)
    launch_stats<bf16>(x, n, range_std, p, ws, consts, sums, num_blocks, threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int smaq_quantize(const void* x, void* y, long long n, int dtype, const float* stats,
                  const float* consts, int stats_mode, int range_std,
                  const unsigned long long* key, unsigned int call, long long offset,
                  int stochastic, int all_positive,
                  int compute_size, float t, float range_main, float range_outlier,
                  float inv_range_main, float inv_range_outlier, float std_lo,
                  float std_hi, int bits_main, int bits_outlier, unsigned long long* ws,
                  float* size_out, int num_blocks, int threads, void* stream) {
  const QParams p = qparams(t, range_main, range_outlier, inv_range_main, inv_range_outlier,
                            std_lo, std_hi, bits_main, bits_outlier);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_quantize<float>(x, y, n, stats, consts, stats_mode, range_std, key, call, offset,
                           stochastic, all_positive, compute_size, p, ws, size_out, num_blocks,
                           threads, s);
  else if (dtype == kBFloat16)
    launch_quantize<bf16>(x, y, n, stats, consts, stats_mode, range_std, key, call, offset,
                          stochastic, all_positive, compute_size, p, ws, size_out, num_blocks,
                          threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int smaq_quantize_bn(const void* x, void* y, long long n, int dtype, const float* stats,
                     const float* consts, int stats_mode, const float* gamma,
                     const float* beta, int channels, long long inner,
                     const unsigned long long* key, unsigned int call, long long offset,
                     int stochastic, int all_positive,
                     int compute_size, float t, float range_main, float range_outlier,
                     float inv_range_main, float inv_range_outlier, float std_lo,
                     float std_hi, int bits_main, int bits_outlier,
                     unsigned long long* ws, float* size_out, int num_blocks, int threads,
                     void* stream) {
  const QParams p = qparams(t, range_main, range_outlier, inv_range_main, inv_range_outlier,
                            std_lo, std_hi, bits_main, bits_outlier);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_quantize_bn<float>(x, y, n, stats, consts, stats_mode, gamma, beta, channels, inner,
                              key, call, offset, stochastic, all_positive, compute_size, p, ws,
                              size_out, num_blocks, threads, s);
  else if (dtype == kBFloat16)
    launch_quantize_bn<bf16>(x, y, n, stats, consts, stats_mode, gamma, beta, channels, inner,
                             key, call, offset, stochastic, all_positive, compute_size, p, ws,
                             size_out, num_blocks, threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The one-launch form of a full-stats bfloat16 call (dtype 1 only): x
// quantized into y, the 8 constants into `consts`, the size into
// `size_out`, one cooperative launch of `num_blocks` (smaq_stats' grid for
// n) blocks of `threads` with smaq_onepass_smem's shared memory each.
// Every block must be resident at once and hold its groups: the launch
// fails (cudaErrorCooperativeLaunchTooLarge) where they do not fit.
int smaq_onepass(const void* x, void* y, long long n, int dtype, int range_std,
                 const unsigned long long* key, unsigned int call, long long offset,
                 int stochastic, int all_positive, int compute_size, float t, float range_main,
                 float range_outlier, float inv_range_main, float inv_range_outlier,
                 float std_lo, float std_hi, int bits_main, int bits_outlier,
                 unsigned long long* ws, float* consts, float* size_out, int num_blocks,
                 int threads, void* stream) {
  if (dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const QParams p = qparams(t, range_main, range_outlier, inv_range_main, inv_range_outlier,
                            std_lo, std_hi, bits_main, bits_outlier);
  const long long span = static_cast<long long>(num_blocks) * threads;
  long long bytes = 0;
  cudaError_t e = onepass_setup(&bytes);
  if (e == cudaSuccess && (n + 4 * span - 1) / (4 * span) * threads * kSlotBytes > bytes)
    e = cudaErrorCooperativeLaunchTooLarge;  // x's groups would not fit
  if (e == cudaSuccess)
    e = launch_onepass(x, y, n, range_std, key, call, offset, stochastic, all_positive,
                       compute_size, p, ws, consts, size_out, num_blocks, threads,
                       static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The dynamic shared memory a block of smaq_onepass gets with `blocks`
// blocks of `threads` resident on each SM (onepass_smem).
int smaq_onepass_smem(int blocks, int threads, long long* bytes) {
  return static_cast<int>(onepass_smem(blocks, threads, bytes));
}

// Blocks of `threads` threads (and `smem` bytes of dynamic shared memory)
// resident on one SM: kernel 0 smaq_stats, 1 smaq_quantize, 2
// smaq_quantize_bn (their float32 forms), 3 smaq_onepass (the occupancy
// query: right only up to 48 KB of shared memory, smaq_onepass_smem), 4
// smaq_quantize_bn's bfloat16 form (stochastic).
int smaq_occupancy(int kernel, int threads, long long smem, int* blocks_per_sm) {
  const void* f = kernel == 0   ? reinterpret_cast<const void*>(smaq_stats_kernel<float>)
                  : kernel == 1 ? reinterpret_cast<const void*>(smaq_quantize_kernel<float>)
                  : kernel == 2 ? reinterpret_cast<const void*>(smaq_quantize_bn_kernel<float>)
                  : kernel == 3 ? reinterpret_cast<const void*>(kOnepassKernels[2])
                                : reinterpret_cast<const void*>(kBnBf16Kernels[2]);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, f, threads, static_cast<size_t>(smem)));
}

}  // extern "C"

#ifdef SMAQ_PHASES
// The profiling build's phase times of the last smaq_onepass launch: 6 x
// 4096 global-timer readings (ns), [phase][block].
extern "C" int smaq_phase_times(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases)));
}
#endif
