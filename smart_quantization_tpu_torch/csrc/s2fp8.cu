// S2FP8 (shifted-squeezed FP8) fake-quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel smart_quantization_tpu/ops/pallas/s2fp8_kernel.py::
// s2fp8_fused (_kernel 135-184) together with the statistics its wrapper
// computes first (223-237).  The squeeze is the kernel's "intrinsic" form
// (exp2f/log2f on every element); the unsqueeze is read from a per-tensor
// table, which is the idea of its "hybrid" form (118-132, 172-179): the
// value it inverts lies on the e5m2 grid.  The TPU's mode string is not
// ported.  Blocks on Hopper run in parallel and in no order, so a tensor
// of more than a few thousand elements takes two launches, and a small one
// takes one:
//
//   s2fp8_stats     one pass over x: every thread sums log2|x| in double
//                   and takes the max of log2|x| (zeros count as 0 in both,
//                   the reference quirk), and each block writes one partial.
//                   The last block to finish (a fence and a ticket) folds
//                   the partials in a fixed order into mu and max, then
//                   alpha = 15 / (max - mu) (15 where max == mu), beta =
//                   -alpha * mu and 1 / alpha, and the unsqueeze table, and
//                   writes them to the constants buffer (Consts).  No float
//                   atomics: the result does not depend on block order.
//   s2fp8_quantize  stages the table in shared memory, then per element:
//                   squeeze exp2(alpha * log2|x| + beta), round onto e5m2
//                   (float_round.cuh; random bits from philox.cuh, keyed by
//                   the step key in device memory and the call's index and
//                   counted by element group, when stochastic), unsqueeze by one
//                   table read, and put the sign back.  Zeros stay zeros;
//                   inf and NaN go through the selects of the TPU kernel.
//                   The small form (consts == NULL) is one block of
//                   kSmallThreads that computes the stats, the constants and
//                   the table itself, then quantizes: one launch.
//
// The unsqueeze table.  fp_round returns t on the e5m2 grid: 0, +inf, NaN,
// or one of 123 finite positive values from 2^-16 (float32 exponent 111) to
// 57344 (exponent 142, mantissa 1.75).  Their float32 bits differ in the
// exponent and the top two mantissa bits only, so (bits >> 21) - kTableBase
// lies in 0..127 and tells them apart.  table[k] = exp2f((log2f(t_k) - beta)
// * inv_alpha) for t_k with bits (k + kTableBase) << 21 is the expression
// the element would compute, so the output is bitwise what computing it per
// element gives.  Five indices (the unused mantissas of the two subnormal
// binades) are no grid value; their entries are computed all the same and
// never read.
//
// Element types: float32 or bfloat16 in and out (elem.cuh), the arithmetic
// float32/float64 on the widened elements in the same order, so a bfloat16
// call is bit for bit the float32 kernels on x.float() with the output
// rounded to nearest-even.
//
// The stats ticket and partials live in a workspace the wrapper zeroes once
// per (device, stream); the last stats block puts the ticket back to 0, so
// no call needs a memset.  Launches on one stream run in order, so a call's
// quantize reads the constants its own stats wrote.
//
// What bounds them.  The stats pass: memory (4 bytes an element read; per
// element a log2f, a conversion and a double add), and for small tensors
// the fixed cost of a launch.  The quantize moves 8 bytes an element; at
// the card's peak rates its SMs issue some 70 thread instructions in the
// time its memory moves those 8 bytes, and the element op is about that
// long (the precise log2f is a polynomial with no special-function op,
// exp2f a few instructions around one, then the integer round and a
// quarter of a Philox call).  Removing any part of the op shortens the
// kernel (PERF.md): it is bound by instruction issue as much as by memory.
// So the quantize saves instructions: the unsqueeze is one table read
// instead of a log2f and an exp2f, the round's mode and format are
// compile-time constants, and the table sits in shared memory rotated so
// that its index is one bit-field extract.  Both streaming loops keep
// kUnroll independent 16-byte loads in flight per thread, spaced a grid
// apart, with enough blocks resident to fill every SM; the quantize walks
// x from its end, the reverse of the stats pass, whose last loads are the
// likeliest still in L2.  The small form is one SM's work, so it pays
// only up to a few thousand elements.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "elem.cuh"
#include "float_round.cuh"
#include "philox.cuh"

namespace {

using smaq::bf16;
using smaq::FloatFmt;
using smaq::group_aligned;
using smaq::load_group;
using smaq::store_group;
using smaq::to_float;

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
// the unsqueeze table: (bits >> 21) of 2^-16, the least e5m2 value
constexpr int kTableSize = 128;
constexpr uint32_t kTableBase = 444;
// FP8 e5m2 as float_round.cuh takes it (ops/float_format.py::FP8_FORMAT),
// known at compile time so that the round folds it
constexpr int kMan = 2;
constexpr int kEmin = -14;
constexpr uint32_t kMaxBits = 0x47600000u;      // 57344
constexpr uint32_t kQuantumBits = 0x37800000u;  // 2^-16
constexpr float kQuantumScale = 65536.f;        // 1 / quantum

// Workspace words (64-bit): the ticket, the constants (Consts), then 2
// doubles per stats block (the sum and the max of log2|x|).
constexpr int kStatsTicket = 0, kCounterWords = 2, kConstWords = 68;

// The per-tensor constants the last stats block writes (544 bytes).
struct __align__(16) Consts {
  float mu, m, alpha, beta, inv_alpha, unused[3];
  float table[kTableSize];
};
static_assert(sizeof(Consts) == 8 * kConstWords, "kConstWords");

struct Coefs {
  float mu, m, alpha, beta, inv_alpha;
};

struct LogStats {
  double s;
  float mx;
};

__device__ __forceinline__ float abs_log2(float v) {
  const float a = fabsf(v);
  return a == 0.f ? 0.f : log2f(a);
}

__device__ __forceinline__ LogStats warp_stats(LogStats v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.s += __shfl_xor_sync(0xffffffffu, v.s, off);
    v.mx = fmaxf(v.mx, __shfl_xor_sync(0xffffffffu, v.mx, off));
  }
  return v;
}

// Both reductions over the block in a fixed order, in one round through
// shared memory; every thread gets the result.
__device__ LogStats block_stats(LogStats v, LogStats* sm) {
  v = warp_stats(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_stats(lane < static_cast<int>(blockDim.x >> 5) ? sm[lane]
                                                           : LogStats{0.0, -CUDART_INF_F});
    if (lane == 0) sm[0] = v;
  }
  __syncthreads();
  v = sm[0];
  __syncthreads();
  return v;
}

// This thread's share of the stats.  The grid's threads cover one slice of
// x, a group of four elements each (elem.cuh); a thread takes the groups g0 + u * span (u <
// kUnroll, span = the grid's thread count), then steps by kUnroll slices:
// kUnroll loads in flight, and every block busy even where x is one slice.
// Every element goes into the double sum on its own.  The elements past
// the last whole group (all of them when x is not aligned to a group) go
// one per thread.
template <typename T>
__device__ LogStats thread_stats(const T* __restrict__ x, int64_t n) {
  const int64_t n4 = group_aligned<T>(x) ? n >> 2 : 0;
  const int64_t span = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  LogStats st{0.0, -CUDART_INF_F};
  auto acc = [&](float v) {
    const float lg = abs_log2(v);
    st.s += lg;
    st.mx = fmaxf(st.mx, lg);
  };
  for (int64_t g0 = tid; g0 < n4; g0 += span * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g0 + u * span < n4) v[u] = load_group(x, g0 + u * span);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (g0 + u * span < n4) {
        acc(v[u].x);
        acc(v[u].y);
        acc(v[u].z);
        acc(v[u].w);
      }
    }
  }
  for (int64_t e = (n4 << 2) + tid; e < n; e += span) acc(to_float(x[e]));
  return st;
}

// mu, max, alpha, beta and 1/alpha from the folded stats, as the plain
// version has them (ops/s2fp8.py::squeeze_coefs).
__device__ Coefs make_coefs(const LogStats& s, int64_t n) {
  Coefs c;
  c.mu = static_cast<float>(s.s / static_cast<double>(n));
  c.m = s.mx;
  const float denom = c.m - c.mu;
  c.alpha = 15.f / (denom == 0.f ? 15.f : denom);
  c.beta = -c.alpha * c.mu;
  c.inv_alpha = 1.f / c.alpha;
  return c;
}

// Entry k of the unsqueeze table: the element's expression at t_k.
__device__ __forceinline__ float table_entry(int k, float beta, float inv_alpha) {
  const float t = __uint_as_float((static_cast<uint32_t>(k) + kTableBase) << 21);
  return exp2f((log2f(t) - beta) * inv_alpha);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
s2fp8_stats_kernel(const T* __restrict__ x, int64_t n, unsigned long long* __restrict__ ws) {
  __shared__ LogStats sm[32];
  __shared__ bool last;
  Consts* out = reinterpret_cast<Consts*>(ws + kCounterWords);
  double* partials = reinterpret_cast<double*>(ws + kCounterWords + kConstWords);

  const LogStats s = block_stats(thread_stats(x, n), sm);
  if (threadIdx.x == 0) {
    double* q = partials + 2 * static_cast<int64_t>(blockIdx.x);
    q[0] = s.s;
    q[1] = s.mx;
    __threadfence();
    last = atomicAdd(&ws[kStatsTicket], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written; fold them in a fixed order
  __threadfence();
  LogStats f{0.0, -CUDART_INF_F};
  const int blocks = static_cast<int>(gridDim.x);
  for (int i0 = threadIdx.x; i0 < blocks; i0 += kFoldLoads * blockDim.x) {
    double q[kFoldLoads][2];  // all loads issued before the first add
#pragma unroll
    for (int k = 0; k < kFoldLoads; ++k) {
      const int i = i0 + k * blockDim.x;
      q[k][0] = i < blocks ? __ldcg(partials + 2 * static_cast<int64_t>(i)) : 0.0;
      q[k][1] = i < blocks ? __ldcg(partials + 2 * static_cast<int64_t>(i) + 1) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < kFoldLoads; ++k) {
      if (i0 + k * static_cast<int>(blockDim.x) < blocks) {
        f.s += q[k][0];
        f.mx = fmaxf(f.mx, static_cast<float>(q[k][1]));
      }
    }
  }
  const Coefs c = make_coefs(block_stats(f, sm), n);
  for (int k = threadIdx.x; k < kTableSize; k += blockDim.x)
    out->table[k] = table_entry(k, c.beta, c.inv_alpha);
  if (threadIdx.x == 0) {
    out->mu = c.mu;
    out->m = c.m;
    out->alpha = c.alpha;
    out->beta = c.beta;
    out->inv_alpha = c.inv_alpha;
    out->unused[0] = out->unused[1] = out->unused[2] = 0.f;
    ws[kStatsTicket] = 0;
  }
}

// The per-element op.  `stochastic` and `check_inf` are template
// parameters and the format is e5m2's constants, so fp_round's selects
// and format arithmetic fold away at compile time (the same code, the
// same bits).
template <bool kStochastic, bool kCheckInf>
struct Squeeze {
  float alpha, beta;

  __device__ __forceinline__ float operator()(float v, uint32_t rand,
                                              const float* __restrict__ table) const {
    const FloatFmt e5m2{kMan, kEmin, kMaxBits, kQuantumBits, kQuantumScale, 1.f};
    const uint32_t bits = __float_as_uint(v);
    const uint32_t sign = bits & 0x80000000u;
    const float a = __uint_as_float(bits & 0x7FFFFFFFu);
    const bool zero = a == 0.f, nonfinite = a >= CUDART_INF_F;
    // the product and the sum rounded apart, as the plain version has them
    float sq = exp2f(__fadd_rn(__fmul_rn(alpha, log2f(zero || nonfinite ? 1.f : a)), beta));
    sq = zero ? 0.f : sq;
    sq = nonfinite ? a : sq;
    const float t = __uint_as_float(
        smaq::fp_round(__float_as_uint(sq), rand, e5m2, kStochastic, kCheckInf));
    // t is 0, +inf, NaN or an e5m2 value; the mask keeps the read in the
    // table for the first three, whose entry the selects then drop
    float out = table[(__float_as_uint(t) >> 21) & (kTableSize - 1)];
    out = t == 0.f ? 0.f : out;
    out = t < CUDART_INF_F ? out : t;  // +inf and NaN pass through
    return __uint_as_float(__float_as_uint(out) | sign);
  }
};

// Launched with kThreads-thread blocks against the constants s2fp8_stats
// wrote, or as one block of kSmallThreads with consts == NULL (the small
// form).  The table goes into shared memory rotated: entry k at (k +
// kTableBase) mod kTableSize, so that the e5m2 value with bits b reads
// (b >> 21) mod kTableSize (kTableBase .. kTableBase + 127 are 128
// consecutive integers, so their low 7 bits tell them apart).
template <typename T, bool kStochastic, bool kCheckInf>
__global__ void __launch_bounds__(kSmallThreads)
s2fp8_quantize_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                      const Consts* __restrict__ consts,
                      const unsigned long long* __restrict__ key, uint32_t call) {
  __shared__ float table[kTableSize];
  __shared__ LogStats sm[32];

  Squeeze<kStochastic, kCheckInf> sq;
  if (consts != nullptr) {
    for (int k = threadIdx.x; k < kTableSize; k += blockDim.x)
      table[(k + kTableBase) & (kTableSize - 1)] = consts->table[k];
    sq.alpha = consts->alpha;
    sq.beta = consts->beta;
  } else {
    const Coefs c = make_coefs(block_stats(thread_stats(x, n), sm), n);
    for (int k = threadIdx.x; k < kTableSize; k += blockDim.x)
      table[(k + kTableBase) & (kTableSize - 1)] = table_entry(k, c.beta, c.inv_alpha);
    sq.alpha = c.alpha;
    sq.beta = c.beta;
  }
  __syncthreads();

  const uint2 pkey = kStochastic ? smaq::philox_key(key, call) : make_uint2(0u, 0u);
  const int64_t n4 = group_aligned<T>(x) && group_aligned<T>(y) ? n >> 2 : 0;
  const int64_t span = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // as thread_stats walks x, but from its end: group i of the walk is group
  // n4 - 1 - i of x
  for (int64_t g0 = tid; g0 < n4; g0 += span * kUnroll) {
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
        const uint4 r = kStochastic ? smaq::philox_group(g, pkey) : make_uint4(0u, 0u, 0u, 0u);
        float4 o;
        o.x = sq(v[u].x, r.x, table);
        o.y = sq(v[u].y, r.y, table);
        o.z = sq(v[u].z, r.z, table);
        o.w = sq(v[u].w, r.w, table);
        store_group(y, g, o);
      }
    }
  }
  // the elements past the last whole group (all of them when unaligned)
  for (int64_t e = (n4 << 2) + tid; e < n; e += span) {
    const uint4 r = kStochastic ? smaq::philox_group(e >> 2, pkey) : make_uint4(0u, 0u, 0u, 0u);
    y[e] = smaq::from_float<T>(sq(to_float(x[e]), smaq::philox_word(r, e), table));
  }
}

template <typename T>
using QuantizeKernel = void (*)(const T*, T*, int64_t, const Consts*,
                                const unsigned long long*, uint32_t);

template <typename T>
QuantizeKernel<T> quantize_kernel(int stochastic, int check_inf) {
  if (stochastic)
    return check_inf ? s2fp8_quantize_kernel<T, true, true>
                     : s2fp8_quantize_kernel<T, true, false>;
  return check_inf ? s2fp8_quantize_kernel<T, false, true>
                   : s2fp8_quantize_kernel<T, false, false>;
}

template <typename T>
void launch_quantize(const void* x, void* y, long long n, const float* consts,
                     const unsigned long long* key, unsigned int call, int stochastic,
                     int check_inf, int num_blocks, int threads, cudaStream_t stream) {
  quantize_kernel<T>(stochastic, check_inf)<<<num_blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n),
      reinterpret_cast<const Consts*>(consts), key, call);
}

}  // namespace

extern "C" {

// The entry points launch on `stream` and return cudaGetLastError()
// (cudaErrorInvalidValue for a `dtype` they do not take).  `x` and `y` hold
// float32 (dtype 0) or bfloat16 (dtype 1) elements.  `ws` is the stream's
// workspace: kCounterWords 64-bit words, zero between calls, then the
// constants (kConstWords words), then 2 doubles per stats block.  `consts`
// points at the constants in the workspace, or is NULL for the small form
// (one block).

int s2fp8_stats(const void* x, long long n, int dtype, unsigned long long* ws, int num_blocks,
                int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    s2fp8_stats_kernel<float><<<num_blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int64_t>(n), ws);
  else if (dtype == 1)
    s2fp8_stats_kernel<bf16><<<num_blocks, threads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<int64_t>(n), ws);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int s2fp8_quantize(const void* x, void* y, long long n, int dtype, const float* consts,
                   const unsigned long long* key, unsigned int call, int stochastic,
                   int check_inf, int num_blocks, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_quantize<float>(x, y, n, consts, key, call, stochastic, check_inf, num_blocks,
                           threads, s);
  else if (dtype == 1)
    launch_quantize<bf16>(x, y, n, consts, key, call, stochastic, check_inf, num_blocks,
                          threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `threads` threads resident on one SM, for the float32 kernels:
// kernel 0 s2fp8_stats, 1 s2fp8_quantize in the given mode.
int s2fp8_occupancy(int kernel, int stochastic, int check_inf, int threads,
                    int* blocks_per_sm) {
  const void* f =
      kernel == 0 ? reinterpret_cast<const void*>(s2fp8_stats_kernel<float>)
                  : reinterpret_cast<const void*>(quantize_kernel<float>(stochastic, check_inf));
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, f, threads, 0));
}

}  // extern "C"
