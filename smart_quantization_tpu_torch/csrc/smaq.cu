// Fused SmaQ quantize->dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernel smart_quantization_tpu/ops/pallas/smaq_kernel.py::
// smaq_fused (body _kernel, lines 62-190) together with the one-pass
// statistics reduction its wrapper runs first (lines 245-278).  It computes
// what that kernel computes, not how: the TPU's 1024-lane rows, power-of-two
// row bucketing, zero padding with its pad correction, and the SMEM scratch
// carried across a sequential grid do not carry over.  Blocks on Hopper run
// in parallel and in no order, so a tensor of more than a few thousand
// elements takes two launches, and a small one takes one:
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
//                  smaq_kernel.py:119-130 (mean, std, a, b, std/range for
//                  each bucket, t*std) to a 32-byte buffer.  So the stats
//                  are folded once per call, as the TPU kernel derives its
//                  scalars once; no float atomics: the result does not
//                  depend on block order.
//   smaq_quantize  reads those constants (or derives them from a given
//                  (mean, std) pair), then one read and one write per
//                  element.  Rounding is trunc or floor(q + u), u the top 24
//                  bits of a counter-based Philox4x32-10 (philox.cuh) keyed
//                  by the step key in device memory and the call's index,
//                  and counted by element index
//                  (the output does not depend on the launch shape or walk
//                  order).  The outlier count goes through a block reduction
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
//                  element e is (e / (H*W)) % C; each block stages the four
//                  folded constants of every channel in shared memory.
//
// Element types: each kernel reads and writes float32 or bfloat16 (elem.cuh,
// the C interface's dtype argument).  The arithmetic is float32/float64 on
// the widened elements either way and the threads visit the same groups of
// four in the same order, so a bfloat16 call gives bit for bit the float32
// kernel's result on x.float(), rounded to nearest-even, with the same
// constants and size; a bfloat16 call moves 2 + 2 (+ 2 for the stats pass)
// bytes an element.  The launch shapes and smaq_plan's small-form threshold
// are the float32 ones (the small form's block reads half the bytes, so its
// threshold could move up: a later, measured decision).
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
// fits there.  The operations per element (about 20 float32 operations, two
// float64 ones and a conversion in the stats pass, a quarter of a Philox
// call) are far below the card's rates.  So both streaming loops keep
// kUnroll independent 16-byte loads in flight per thread, spaced a grid
// apart so every block has work even where x is one grid's worth, with
// enough blocks resident to fill every SM; and the quantize pass walks x
// from its end, the reverse of the stats pass, whose last loads are the
// likeliest still in L2.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "elem.cuh"
#include "philox.cuh"

namespace {

using smaq::bf16;
using smaq::block_sum;
using smaq::group_aligned;
using smaq::load_group;
using smaq::store_group;
using smaq::to_float;

constexpr int kPivotElems = 256;
// float4 loads in flight per thread in the streaming loops
constexpr int kUnroll = 4;
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
// in the low 40, so one atomicAdd a block does both, with no fence.
constexpr int kStatsTicket = 0, kQuantCount = 1, kCounterWords = 4;
constexpr int kTicketShift = 40;

// Stats modes of the quantize kernels: a given (mean, std) pair; the
// constants smaq_stats wrote; the small form's own stats (one block).
constexpr int kGiven = 0, kConsts = 1, kSmall = 2;

struct QParams {
  float t, range_main, range_outlier, inv_range_main, inv_range_outlier, std_lo, std_hi;
  int bits_main, bits_outlier;
};

// The per-tensor constants, as smaq_kernel.py:121-130 derives them.
struct __align__(16) Consts {
  float mean, std, a, b, inv_main_std, inv_out_std, t_std, unused;
};

// The zero-std guard, the clamp, then the folded reciprocals.
__device__ Consts make_consts(float mean, float std, const QParams& p) {
  if (std == 0.f) std = 1.f;
  std = fminf(fmaxf(std, p.std_lo), p.std_hi);
  Consts c;
  c.mean = mean;
  c.std = std;
  c.a = 1.f / std;
  c.b = -mean * c.a;
  c.inv_main_std = std * p.inv_range_main;
  c.inv_out_std = std * p.inv_range_outlier;
  c.t_std = p.t * std;
  c.unused = 0.f;
  return c;
}

struct Sums {
  double s1, s2;
  float mn, mx;
};

__device__ __forceinline__ Sums no_sums() { return Sums{0.0, 0.0, CUDART_INF_F, -CUDART_INF_F}; }

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
// slice of x, a group of four elements each (elem.cuh); a thread takes the groups g0 + u * span
// (u < kUnroll, span = the grid's thread count) for g0 = its index, then
// steps by kUnroll slices: kUnroll loads in flight, every block busy even
// where x is one slice, and the first loads issued before the pivot.  The
// elements past the last whole group (all of them when x is not aligned to
// a group) go one per thread.
template <typename T>
__device__ Sums thread_sums(const T* __restrict__ x, int64_t n, float& pivot) {
  const int64_t n4 = group_aligned<T>(x) ? n >> 2 : 0;
  const int64_t span = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t g0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4 v[kUnroll];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g0 + u * span < n4) v[u] = load_group(x, g0 + u * span);
  };
  load();
  pivot = warp_pivot(x, n);
  Sums s = no_sums();
  auto acc = [&](float e) {
    const float d = e - pivot;
    s.s1 += d;
    s.s2 += static_cast<double>(d) * d;
    s.mn = fminf(s.mn, e);
    s.mx = fmaxf(s.mx, e);
  };
  while (g0 < n4) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (g0 + u * span < n4) {
        acc(v[u].x);
        acc(v[u].y);
        acc(v[u].z);
        acc(v[u].w);
      }
    }
    g0 += span * kUnroll;
    load();
  }
  for (int64_t e = (n4 << 2) + blockIdx.x * blockDim.x + threadIdx.x; e < n; e += span)
    acc(to_float(x[e]));
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

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
smaq_stats_kernel(const T* __restrict__ x, int64_t n, int range_std, QParams p,
                  unsigned long long* __restrict__ ws, Consts* __restrict__ out) {
  __shared__ Sums sm[32];
  __shared__ bool last;
  double* partials = reinterpret_cast<double*>(ws + kCounterWords);

  float pivot;
  const Sums s = block_sums(thread_sums(x, n, pivot), sm);
  if (threadIdx.x == 0) {
    double* q = partials + 4 * static_cast<int64_t>(blockIdx.x);
    q[0] = s.s1;
    q[1] = s.s2;
    q[2] = s.mn;
    q[3] = s.mx;
    __threadfence();
    last = atomicAdd(&ws[kStatsTicket], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written; fold them in a fixed order
  __threadfence();
  Sums f = no_sums();
  for (int i0 = threadIdx.x; i0 < static_cast<int>(gridDim.x); i0 += kFoldLoads * blockDim.x) {
    double q[kFoldLoads][4];  // all loads issued before the first add
#pragma unroll
    for (int k = 0; k < kFoldLoads; ++k) {
      const int i = i0 + k * blockDim.x;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[k][j] = i < static_cast<int>(gridDim.x) ? __ldcg(partials + 4 * static_cast<int64_t>(i) + j) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < kFoldLoads; ++k) {
      if (i0 + k * static_cast<int>(blockDim.x) < static_cast<int>(gridDim.x)) {
        f.s1 += q[k][0];
        f.s2 += q[k][1];
        f.mn = fminf(f.mn, static_cast<float>(q[k][2]));
        f.mx = fmaxf(f.mx, static_cast<float>(q[k][3]));
      }
    }
  }
  f = block_sums(f, sm);
  if (threadIdx.x == 0) {
    *out = finish_stats(f, pivot, n, range_std, p);
    ws[kStatsTicket] = 0;
  }
}

struct Quant {
  Consts c;
  float t, range_main, range_outlier;
  bool stochastic, all_positive;

  // q = round((z + shift) * scale); y = q * std / scale + shift * std + mean
  __device__ __forceinline__ float operator()(float x, uint32_t bits, int& cnt) const {
    const float z = x * c.a + c.b;
    const bool hi = z > t, lo = z < -t, out = hi || lo;
    const float shift = hi ? -t : (lo ? t : 0.f);
    const float scale = out ? range_outlier : range_main;
    float q = (z + shift) * scale;
    q = stochastic ? floorf(q + static_cast<float>(bits >> 8) * 0x1p-24f) : truncf(q);
    const float inv = out ? c.inv_out_std : c.inv_main_std;
    const float st = hi ? c.t_std : (lo ? -c.t_std : 0.f);
    float y = q * inv + st + c.mean;
    if (all_positive && y < 0.f) y = 0.f;
    cnt += out;
    return y;
  }
};

// The size in bits from the block's outlier count.  One block writes it
// directly; otherwise each block adds (1 ticket, its count) to the quantize
// word in one 64-bit atomicAdd, and the block that draws the last ticket
// finds every count in the sum, writes the size and puts the word back to 0.
__device__ void write_size(int cnt, int64_t n, int compute_size, const QParams& p,
                           unsigned long long* __restrict__ ws, float* __restrict__ size_out,
                           unsigned long long* su) {
  if (!compute_size) {
    if (blockIdx.x == 0 && threadIdx.x == 0)
      size_out[0] = static_cast<float>(static_cast<double>(n) * p.bits_main);
    return;
  }
  const unsigned long long block_cnt = block_sum(static_cast<unsigned long long>(cnt), su);
  if (threadIdx.x != 0) return;
  unsigned long long total = block_cnt;
  if (gridDim.x > 1) {
    const unsigned long long mine = (1ull << kTicketShift) + block_cnt;
    const unsigned long long before = atomicAdd(&ws[kQuantCount], mine);
    if ((before >> kTicketShift) != gridDim.x - 1) return;
    total = (before + mine) & ((1ull << kTicketShift) - 1);
    ws[kQuantCount] = 0;
  }
  size_out[0] = static_cast<float>(static_cast<double>(n) * p.bits_main +
                                   static_cast<double>(total) * (p.bits_outlier - p.bits_main));
}

// Launched with kThreads-thread blocks, or as one block of kSmallThreads in
// the small form.
template <typename T>
__global__ void __launch_bounds__(kSmallThreads)
smaq_quantize_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                     const float* __restrict__ stats, const Consts* __restrict__ consts,
                     int stats_mode, int range_std, const unsigned long long* __restrict__ key,
                     unsigned int call, int stochastic,
                     int all_positive, int compute_size, QParams p,
                     unsigned long long* __restrict__ ws, float* __restrict__ size_out) {
  __shared__ Sums sm[32];
  __shared__ unsigned long long su[32];

  Quant qz;
  if (stats_mode == kConsts) {
    qz.c = *consts;
  } else if (stats_mode == kGiven) {
    qz.c = make_consts(stats[0], stats[1], p);
  } else {
    float pivot;
    const Sums s = block_sums(thread_sums(x, n, pivot), sm);
    qz.c = finish_stats(s, pivot, n, range_std, p);
  }
  qz.t = p.t;
  qz.range_main = p.range_main;
  qz.range_outlier = p.range_outlier;
  qz.stochastic = stochastic != 0;
  qz.all_positive = all_positive != 0;

  const uint2 pkey = qz.stochastic ? smaq::philox_key(key, call) : make_uint2(0u, 0u);
  const int64_t n4 = group_aligned<T>(x) && group_aligned<T>(y) ? n >> 2 : 0;
  const int64_t span = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int cnt = 0;
  // as thread_sums walks x, but from its end: group i of the walk is group
  // n4 - 1 - i of x
  for (int64_t g0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g0 < n4;
       g0 += span * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = g0 + u * span;
      if (i < n4) v[u] = load_group(x, n4 - 1 - i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = g0 + u * span;
      if (i < n4) {
        const int64_t g = n4 - 1 - i;
        const uint4 r = qz.stochastic ? smaq::philox_group(g, pkey) : make_uint4(0u, 0u, 0u, 0u);
        float4 o;
        o.x = qz(v[u].x, r.x, cnt);
        o.y = qz(v[u].y, r.y, cnt);
        o.z = qz(v[u].z, r.z, cnt);
        o.w = qz(v[u].w, r.w, cnt);
        store_group(y, g, o);
      }
    }
  }
  // the elements past the last whole group (all of them when unaligned)
  for (int64_t e = (n4 << 2) + blockIdx.x * blockDim.x + threadIdx.x; e < n; e += span) {
    const uint4 r = qz.stochastic ? smaq::philox_group(e >> 2, pkey) : make_uint4(0u, 0u, 0u, 0u);
    y[e] = smaq::from_float<T>(qz(to_float(x[e]), smaq::philox_word(r, e), cnt));
  }
  write_size(cnt, n, compute_size, p, ws, size_out, su);
}

// BatchNorm-folded SmaQ, the port of smaq_kernel.py::_kernel_bn (398-482):
// per channel c, k = (A, B, G, H) with A = 1 / (g_c * std),
// B = -(beta_c * A) - mean / std, G = std * g_c, H = mean * g_c + beta_c and
// g_c = gamma_c, or 1 where gamma_c == 0.  z = x * A + B, then the SmaQ
// buckets and rounding, zhat = q / scale - shift, y = zhat * G + H.
struct QuantBN {
  float t, range_main, range_outlier, inv_range_main, inv_range_outlier;
  bool stochastic, all_positive;

  __device__ __forceinline__ float operator()(float x, float4 k, uint32_t bits, int& cnt) const {
    const float z = x * k.x + k.y;
    const bool hi = z > t, lo = z < -t, out = hi || lo;
    const float shift = hi ? -t : (lo ? t : 0.f);
    float q = (z + shift) * (out ? range_outlier : range_main);
    q = stochastic ? floorf(q + static_cast<float>(bits >> 8) * 0x1p-24f) : truncf(q);
    const float zhat = q * (out ? inv_range_outlier : inv_range_main) - shift;
    float y = zhat * k.z + k.w;
    if (all_positive && y < 0.f) y = 0.f;
    cnt += out;
    return y;
  }
};

// x is (outer, channels, inner) in memory (NCHW: inner = H * W); element e
// is in channel (e / inner) % channels.  The per-channel constants live in
// dynamic shared memory, one float4 per channel.
template <typename T>
__global__ void smaq_quantize_bn_kernel(
    const T* __restrict__ x, T* __restrict__ y, int64_t n,
    const float* __restrict__ stats, const Consts* __restrict__ consts, int stats_mode,
    const float* __restrict__ gamma, const float* __restrict__ beta, int channels,
    int64_t inner, const unsigned long long* __restrict__ key, unsigned int call,
    int stochastic, int all_positive, int compute_size,
    QParams p, unsigned long long* __restrict__ ws, float* __restrict__ size_out) {
  __shared__ unsigned long long su[32];
  extern __shared__ float4 chan[];

  const Consts cs = stats_mode == kConsts ? *consts : make_consts(stats[0], stats[1], p);
  const float mean = cs.mean, std = cs.std;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    const float g = gamma[c] == 0.f ? 1.f : gamma[c];
    const float b = beta[c];
    const float a = 1.f / (g * std);
    chan[c] = make_float4(a, -(b * a) - mean / std, std * g, mean * g + b);
  }
  __syncthreads();

  QuantBN qz{p.t, p.range_main, p.range_outlier, p.inv_range_main, p.inv_range_outlier,
             stochastic != 0, all_positive != 0};
  // 32-bit index arithmetic where it fits (64-bit division is a long
  // software routine); a float4 group lies in one channel when inner % 4 == 0
  const bool small = n <= 0xFFFFFFFFll;
  const uint32_t inner32 = static_cast<uint32_t>(inner), ch32 = static_cast<uint32_t>(channels);
  auto chan_of = [&](int64_t e) -> int {
    return small ? static_cast<int>((static_cast<uint32_t>(e) / inner32) % ch32)
                 : static_cast<int>((e / inner) % channels);
  };
  const bool group_in_one = (inner & 3) == 0;
  const uint2 pkey = qz.stochastic ? smaq::philox_key(key, call) : make_uint2(0u, 0u);
  const bool aligned = group_aligned<T>(x) && group_aligned<T>(y);
  const int64_t groups = (n + 3) >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int cnt = 0;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const uint4 r = qz.stochastic ? smaq::philox_group(g, pkey) : make_uint4(0u, 0u, 0u, 0u);
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
                  unsigned long long* ws, float* consts, int num_blocks, int threads,
                  cudaStream_t stream) {
  smaq_stats_kernel<T><<<num_blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int64_t>(n), range_std, p, ws,
      reinterpret_cast<Consts*>(consts));
}

template <typename T>
void launch_quantize(const void* x, void* y, long long n, const float* stats,
                     const float* consts, int stats_mode, int range_std,
                     const unsigned long long* key, unsigned int call, int stochastic,
                     int all_positive, int compute_size, const QParams& p,
                     unsigned long long* ws, float* size_out, int num_blocks, int threads,
                     cudaStream_t stream) {
  smaq_quantize_kernel<T><<<num_blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n), stats,
      reinterpret_cast<const Consts*>(consts), stats_mode, range_std, key, call, stochastic,
      all_positive, compute_size, p, ws, size_out);
}

template <typename T>
void launch_quantize_bn(const void* x, void* y, long long n, const float* stats,
                        const float* consts, int stats_mode, const float* gamma,
                        const float* beta, int channels, long long inner,
                        const unsigned long long* key, unsigned int call, int stochastic,
                        int all_positive, int compute_size, const QParams& p,
                        unsigned long long* ws, float* size_out, int num_blocks, int threads,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(channels) * sizeof(float4);
  smaq_quantize_bn_kernel<T><<<num_blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n), stats,
      reinterpret_cast<const Consts*>(consts), stats_mode, gamma, beta, channels,
      static_cast<int64_t>(inner), key, call, stochastic, all_positive, compute_size, p, ws,
      size_out);
}

}  // namespace

extern "C" {

// The entry points launch on `stream` and return cudaGetLastError()
// (cudaErrorInvalidValue for a `dtype` they do not take).  `x` and `y` hold
// float32 (dtype 0) or bfloat16 (dtype 1) elements; everything else is
// float32.  `ws` is the stream's workspace: kCounterWords 64-bit words, zero
// between calls, then 4 doubles per stats block.  `consts` holds 8 floats,
// 16-byte aligned.

int smaq_stats(const void* x, long long n, int dtype, int range_std, float t,
               float range_main, float range_outlier, float inv_range_main,
               float inv_range_outlier, float std_lo, float std_hi, int bits_main,
               int bits_outlier, unsigned long long* ws, float* consts, int num_blocks,
               int threads, void* stream) {
  const QParams p = qparams(t, range_main, range_outlier, inv_range_main, inv_range_outlier,
                            std_lo, std_hi, bits_main, bits_outlier);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_stats<float>(x, n, range_std, p, ws, consts, num_blocks, threads, s);
  else if (dtype == kBFloat16)
    launch_stats<bf16>(x, n, range_std, p, ws, consts, num_blocks, threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int smaq_quantize(const void* x, void* y, long long n, int dtype, const float* stats,
                  const float* consts, int stats_mode, int range_std,
                  const unsigned long long* key, unsigned int call, int stochastic,
                  int all_positive,
                  int compute_size, float t, float range_main, float range_outlier,
                  float inv_range_main, float inv_range_outlier, float std_lo,
                  float std_hi, int bits_main, int bits_outlier, unsigned long long* ws,
                  float* size_out, int num_blocks, int threads, void* stream) {
  const QParams p = qparams(t, range_main, range_outlier, inv_range_main, inv_range_outlier,
                            std_lo, std_hi, bits_main, bits_outlier);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    launch_quantize<float>(x, y, n, stats, consts, stats_mode, range_std, key, call, stochastic,
                           all_positive, compute_size, p, ws, size_out, num_blocks, threads, s);
  else if (dtype == kBFloat16)
    launch_quantize<bf16>(x, y, n, stats, consts, stats_mode, range_std, key, call, stochastic,
                          all_positive, compute_size, p, ws, size_out, num_blocks, threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int smaq_quantize_bn(const void* x, void* y, long long n, int dtype, const float* stats,
                     const float* consts, int stats_mode, const float* gamma,
                     const float* beta, int channels, long long inner,
                     const unsigned long long* key, unsigned int call, int stochastic,
                     int all_positive,
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
                              key, call, stochastic, all_positive, compute_size, p, ws,
                              size_out, num_blocks, threads, s);
  else if (dtype == kBFloat16)
    launch_quantize_bn<bf16>(x, y, n, stats, consts, stats_mode, gamma, beta, channels, inner,
                             key, call, stochastic, all_positive, compute_size, p, ws,
                             size_out, num_blocks, threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `threads` threads (and `smem` bytes of dynamic shared memory)
// resident on one SM, for the float32 kernels: kernel 0 smaq_stats, 1
// smaq_quantize, 2 smaq_quantize_bn.
int smaq_occupancy(int kernel, int threads, long long smem, int* blocks_per_sm) {
  const void* f = kernel == 0   ? reinterpret_cast<const void*>(smaq_stats_kernel<float>)
                  : kernel == 1 ? reinterpret_cast<const void*>(smaq_quantize_kernel<float>)
                                : reinterpret_cast<const void*>(smaq_quantize_bn_kernel<float>);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, f, threads, static_cast<size_t>(smem)));
}

}  // extern "C"
