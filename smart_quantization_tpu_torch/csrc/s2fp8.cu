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
//
// The bfloat16 forms of the split path.  Instantiated at 4 bytes an element,
// the float32 design above gained nothing (quantize 42.6 against 43.5 us at
// 8 M elements, PERF.md): its per-element log2f, exp2f and rounding set
// the pace, not the bytes.  A bf16 magnitude takes one of 2^15 values, so:
//
//   (The wrapper picks these kernels from a size on, s2fp8_kernel.py:
//   split_forms; below it the float32 kernels' bfloat16 instances serve,
//   since the tables' fixed cost is more than they save there.)
//
//   s2fp8_stats_table      log2|x| is the exponent plus log2f of the
//                          mantissa, halved from kLog2Split on (above
//                          sqrt 2: the split the precise log2f makes
//                          itself), one rounding: measured on an H100 to be
//                          log2f's bits for all 32 512 normal magnitudes.
//                          Each block computes the 128 mantissas' and the
//                          128 subnormals' log2f and holds them once for
//                          each of 16 lanes, so the reads never share a
//                          bank.  The walk, the grid and the order of the
//                          double sums are the float32 kernel's, so the
//                          constants are its bits; a thread that meets an
//                          inf or NaN sums its elements again by log2f, in
//                          the same order.
//   s2fp8_quantize_window  one block of kBf16Threads a SM.  Each block
//                          tabulates the whole per-element function for
//                          the kWindowBinades binades at and below the
//                          max's exponent (from the stats' max; where that
//                          is 0, which zeros alone give, from its first
//                          chunks' exponents): for nearest the
//                          output, for stochastic rounding the two outputs
//                          it can give and the random-word threshold between
//                          them (the rounding adds rand & mask below the kept
//                          bits, so it rounds up where that reaches the
//                          next multiple; below one quantum it compares
//                          rand >> 8).  Each entry is the element's own
//                          expression run once, so the output is its bits.
//                          An element is then one shared-memory read and a
//                          compare (and a quarter of a Philox call); zeros
//                          are zeros.  An element outside the window (and
//                          inf, NaN) takes the full expression, on the
//                          chunk's registers and random words: a warp with
//                          one such element pays the parent kernel's
//                          per-element cost for its step, so the window
//                          pays on tensors whose nonzero magnitudes mostly
//                          lie within 16 binades (chip_smoke.py measures the
//                          share on a training step's maps: window_share).
//                          16-byte loads (8 bf16), the next one in flight.
//
// The stochastic quantize is bound by instruction issue again, now by its
// Philox words (a quarter of a call an element); the nearest one by memory.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

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

// The bfloat16 split forms: mantissas (of 128) at or above which log2f
// halves the mantissa (1 + 54/128 > sqrt 2 > 1 + 53/128); the quantize's
// largest block and the binades its table spans.
constexpr int kLog2Split = 54;
constexpr int kBf16Threads = 1024;
constexpr int kWindowBinades = 16;
constexpr int kWindow = kWindowBinades * 128;
// The window's top: at most this many binades above the sample's mean.
constexpr int kWindowAboveMean = 6;

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

// Row r of the bfloat16 stats' log2 table: for r < 128, log2f of mantissa
// r (1 + r/128, halved from kLog2Split on) and the bits of 1.5 * 2^23 less
// 127 (less 126 where halved): add an exponent field to them and the float
// is 1.5 * 2^23 + the exponent, exactly; for r >= 128, log2f of the
// subnormal with bits r - 128 (0 for zero, as abs_log2 has it) and the bits
// of 1.5 * 2^23 itself (their exponent field is 0).
__device__ __forceinline__ float2 log2_entry(int r) {
  if (r >= 128) {
    const uint32_t sub = static_cast<uint32_t>(r - 128);
    return make_float2(sub == 0u ? 0.f : log2f(__uint_as_float(sub << 16)),
                       __int_as_float(0x4B400000));
  }
  const float m = __uint_as_float((127u << 23) | (static_cast<uint32_t>(r) << 16));
  const bool half = r >= kLog2Split;
  return make_float2(log2f(half ? m * 0.5f : m), __int_as_float(0x4B400000 - 127 + half));
}

// abs_log2 of the bf16 with bits `h`, but for inf and NaN: the exponent
// (one more where the mantissa was halved) plus the table's log2f of the
// mantissa, one rounding, as log2f itself computes it; a subnormal's or
// zero's log2 from the table.  An inf or NaN gets 128 or more, which no
// finite bf16 reaches (the thread sums again by log2f where its max shows
// it).  The table holds each row once for each of 16 lanes (row r of lane
// l at 16 r + l % 16): a half-warp's 8-byte reads never share a bank.
__device__ __forceinline__ float abs_log2_bf16(uint32_t h, const float2* __restrict__ tab,
                                               uint32_t lane) {
  const uint32_t idx = h & 0x7FFFu, e = idx >> 7;
  const uint32_t row = (idx & 127u) | (e == 0u ? 128u : 0u);
  const float2 t = tab[(row << 4) | (lane & 15u)];
  return __fadd_rn(__int_as_float(__float_as_int(t.y) + static_cast<int>(e)) - 12582912.f, t.x);
}

// thread_stats of a bfloat16 x: the same groups in the same order, each
// element's log2 from the table (the raw bits of a group: elements 4g and
// 4g+1 in the low and high half of its first word), the next step's loads
// issued before this step's groups are added.  A thread whose max shows an
// inf or NaN (none in a tensor of the main path) sums its elements again by
// thread_stats, in the same order: the loop itself has no branch.
__device__ LogStats thread_stats_bf16(const bf16* __restrict__ x, int64_t n,
                                      const float2* __restrict__ tab) {
  const int64_t n4 = group_aligned<bf16>(x) ? n >> 2 : 0;
  const int64_t span = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint32_t lane = threadIdx.x & 31u;
  LogStats st{0.0, -CUDART_INF_F};
  auto acc = [&](uint32_t h) {
    const float lg = abs_log2_bf16(h, tab, lane);
    st.s += lg;
    st.mx = fmaxf(st.mx, lg);
  };
  uint2 v[kUnroll], w[kUnroll];
  auto load = [&](uint2* to, int64_t g0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g0 + u * span < n4) to[u] = smaq::load_raw(x, g0 + u * span);
  };
  load(v, tid);
  for (int64_t g0 = tid; g0 < n4; g0 += span * kUnroll) {
    load(w, g0 + span * kUnroll);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (g0 + u * span < n4) {
        acc(v[u].x);
        acc(v[u].x >> 16);
        acc(v[u].y);
        acc(v[u].y >> 16);
      }
      v[u] = w[u];
    }
  }
  for (int64_t e = (n4 << 2) + tid; e < n; e += span) acc(__bfloat16_as_ushort(x[e]));
  return st.mx >= 128.f ? thread_stats(x, n) : st;
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

// kTable (bfloat16 only): each element's log2 from the table
// (thread_stats_bf16), the same sums in the same order; the table is this
// instance's shared memory alone.
template <typename T, bool kTable = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
s2fp8_stats_kernel(const T* __restrict__ x, int64_t n, unsigned long long* __restrict__ ws,
                   double* __restrict__ sums) {
  __shared__ LogStats sm[32];
  __shared__ bool last;
  Consts* out = reinterpret_cast<Consts*>(ws + kCounterWords);
  double* partials = reinterpret_cast<double*>(ws + kCounterWords + kConstWords);

  LogStats s;
  if constexpr (kTable) {
    static_assert(std::is_same<T, bf16>::value, "the log2 table is bfloat16's");
    __shared__ float2 once[256];
    __shared__ float2 tab[256 * 16];
    for (int r = threadIdx.x; r < 256; r += blockDim.x) once[r] = log2_entry(r);
    __syncthreads();
    for (int i = threadIdx.x; i < 256 * 16; i += blockDim.x) tab[i] = once[i >> 4];
    __syncthreads();
    s = block_stats(thread_stats_bf16(x, n, tab), sm);
  } else {
    s = block_stats(thread_stats(x, n), sm);
  }
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
  const LogStats folded = block_stats(f, sm);
  const Coefs c = make_coefs(folded, n);
  for (int k = threadIdx.x; k < kTableSize; k += blockDim.x)
    out->table[k] = table_entry(k, c.beta, c.inv_alpha);
  if (threadIdx.x == 0) {
    if (sums != nullptr) {  // the folded sums, for a reduction over ranks
      sums[0] = folded.s;
      sums[1] = folded.mx;
    }
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
template <typename T, bool kStochastic, bool kCheckInf, bool kOffset = false>
__global__ void __launch_bounds__(kSmallThreads)
s2fp8_quantize_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                      const Consts* __restrict__ consts,
                      const unsigned long long* __restrict__ key, uint32_t call,
                      long long offset) {
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

  const smaq::Draws d = kStochastic ? smaq::draws(key, call, offset) : smaq::Draws{};
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
        const uint4 r =
            kStochastic ? smaq::group_words<kOffset>(d, g) : make_uint4(0u, 0u, 0u, 0u);
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
    y[e] = smaq::from_float<T>(sq(to_float(x[e]), kStochastic ? smaq::element_word(d, e) : 0u,
                                  table));
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 split form of the quantize (see the note at the top).  The
// table holds, for the kWindow magnitudes from `base` on, what the element
// function gives a positive element: for nearest the output; for stochastic
// rounding {mask, threshold, down, up}: the random word's key is rand & mask
// (or, below one quantum, where mask is 0, ~rand >> 8), and the output is
// `up` where the key reaches the threshold, else `down`.

// The unsqueeze of a rounded t, as Squeeze ends.
__device__ __forceinline__ uint32_t unsqueeze_bits(uint32_t t, const float* __restrict__ table) {
  const float tf = __uint_as_float(t);
  float out = table[(t >> 21) & (kTableSize - 1)];
  out = tf == 0.f ? 0.f : out;
  return __float_as_uint(tf < CUDART_INF_F ? out : tf);
}

// The stochastic entry of the positive magnitude `a`.  fp_round adds r =
// rand & mask to the squeezed bits and clears the mask: that rounds up
// exactly where r + (bits & mask) > mask, i.e. r >= mask + 1 - (bits &
// mask).  Below one quantum it rounds up where t > (rand >> 8) * 2^-24 (t =
// sq / quantum, below 1), i.e. where rand >> 8 < ceil(t * 2^24), i.e. where
// ~rand >> 8 >= 2^24 - ceil(t * 2^24); t * 2^24 is exact.  down and up are
// fp_round_finish with the words that give each, then the unsqueeze.
template <bool kCheckInf>
__device__ uint4 rounding_entry(float a, float alpha, float beta, const float* __restrict__ table) {
  const FloatFmt f{kMan, kEmin, kMaxBits, kQuantumBits, kQuantumScale, 1.f};
  const bool zero = a == 0.f;
  const float sq = exp2f(__fadd_rn(__fmul_rn(alpha, log2f(zero ? 1.f : a)), beta));
  const uint32_t bits = __float_as_uint(zero ? 0.f : sq);
  const uint2 shift = smaq::grid_shift((bits >> 23) & 0xFFu, f);
  const uint32_t mask = shift.x & 0x7FFFFFFFu;
  uint4 e;
  if (shift.x >> 31) {
    const float t = __uint_as_float(bits) * f.c1 * f.c2;
    e.x = 0u;
    e.y = (1u << 24) - static_cast<uint32_t>(ceilf(t * 0x1p24f));
    e.z = smaq::fp_round_finish(bits, 0u, mask, true, 0xFFFFFFFFu, f, true, kCheckInf);
    e.w = smaq::fp_round_finish(bits, 0u, mask, true, 0u, f, true, kCheckInf);
  } else {
    e.x = mask;
    e.y = mask + 1u - (bits & mask);
    e.z = smaq::fp_round_finish(bits, 0u, mask, false, 0u, f, true, kCheckInf);
    e.w = smaq::fp_round_finish(bits, mask, mask, false, 0u, f, true, kCheckInf);
  }
  e.z = unsqueeze_bits(e.z, table);
  e.w = unsqueeze_bits(e.w, table);
  return e;
}

// A window entry: the output (nearest), or the rounding's entry.
template <bool kStochastic>
using WindowEntry = std::conditional_t<kStochastic, uint4, float>;

// Element of bf16 bits `h` with its random word, from the window: the
// output's float32 bits; outside the window 0 (a zero's output), and
// `slow` set where the element is no zero (the full expression's).  The
// read is made whatever the element (clamped into the window), so the
// chunk loop has no branch.
__device__ __forceinline__ bool off_window(uint32_t h, uint32_t base) {
  const uint32_t idx = h & 0x7FFFu;
  return idx - base >= static_cast<uint32_t>(kWindow) && idx != 0u;
}

template <bool kStochastic>
__device__ __forceinline__ uint32_t from_window(
    uint32_t h, uint32_t rand, const WindowEntry<kStochastic>* __restrict__ win,
    uint32_t base, bool& slow) {
  const uint32_t k = (h & 0x7FFFu) - base;
  const bool in = k < static_cast<uint32_t>(kWindow);
  uint32_t o;
  if constexpr (kStochastic) {
    const uint4 e = win[in ? k : 0u];
    const uint32_t key = e.x != 0u ? rand & e.x : ~rand >> 8;
    o = key >= e.y ? e.w : e.z;
  } else {
    o = __float_as_uint(win[in ? k : 0u]);
  }
  slow |= off_window(h, base);
  return (in ? o : 0u) | ((h & 0x8000u) << 16);
}

// Launched on one block of kBf16Threads a SM (at most), against the
// constants s2fp8_stats wrote.  The first chunk's load is issued before the
// block builds its tables.
template <bool kStochastic, bool kCheckInf, bool kOffset = false>
__global__ void __launch_bounds__(kBf16Threads, 1)
s2fp8_quantize_window_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int64_t n,
                           const Consts* __restrict__ consts,
                           const unsigned long long* __restrict__ key, uint32_t call,
                           long long offset) {
  __shared__ float table[kTableSize];
  __shared__ WindowEntry<kStochastic> win[kWindow];
  __shared__ uint3 sample[kBf16Threads / 32];  // each warp's: max, sum, count

  const bool wide = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t chunks = wide ? n >> 3 : 0;  // 16-byte chunks: groups 2c and 2c + 1
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  uint4 v = make_uint4(0u, 0u, 0u, 0u), next = v;
  if (first < chunks) v = xv[first];

  for (int k = threadIdx.x; k < kTableSize; k += blockDim.x)
    table[(k + kTableBase) & (kTableSize - 1)] = consts->table[k];
  Squeeze<kStochastic, kCheckInf> sq;
  sq.alpha = consts->alpha;
  sq.beta = consts->beta;
  // The window's top binade: the max's exponent field (floor of its log2,
  // + 127), or one above where log2f rounded up to the next integer.  But
  // zeros count as log2 0 in the stats' max, so a max of exactly 0 may be
  // only the zeros' (a map of zeros and small gradients: 16 binades and
  // more above every element).  Then the block places its window from its
  // first chunks (its first 8192 elements at most): at their largest
  // nonzero exponent field, or kWindowAboveMean above their mean where
  // that is lower, so that a wide tensor keeps its bulk in the window; the
  // max's binade still where they hold no nonzero element.  (The branch is
  // the whole grid's; the sample waits for the first load, which the other
  // path overlaps with the window's build.)  The window decides only which
  // elements take the table, not their bits.
  __syncthreads();  // the unsqueeze table, which the window's entries read
  const float m = fminf(fmaxf(consts->m, -200.f), 200.f);
  int top = static_cast<int>(floorf(m)) + 127;
  if (consts->m == 0.f) {
    uint3 part = make_uint3(0u, 0u, 0u);  // max, sum, count of the exponents
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t h = (w[j >> 1] >> (16 * (j & 1))) & 0xFFFFu, e = (h >> 7) & 0xFFu;
      const bool nz = (h & 0x7FFFu) != 0u && e != 0xFFu;
      part.x = nz ? max(part.x, e) : part.x;
      part.y += nz ? e : 0u;
      part.z += nz;
    }
    // each warp folds its lanes into its slot, then every warp the slots
    part.x = __reduce_max_sync(0xFFFFFFFFu, part.x);
    part.y = __reduce_add_sync(0xFFFFFFFFu, part.y);
    part.z = __reduce_add_sync(0xFFFFFFFFu, part.z);
    const uint32_t lane = threadIdx.x & 31u;
    if (lane == 0u) sample[threadIdx.x >> 5] = part;
    __syncthreads();
    part = lane < (blockDim.x >> 5) ? sample[lane] : make_uint3(0u, 0u, 0u);
    part.x = __reduce_max_sync(0xFFFFFFFFu, part.x);
    part.y = __reduce_add_sync(0xFFFFFFFFu, part.y);
    part.z = __reduce_add_sync(0xFFFFFFFFu, part.z);
    if (part.z != 0u)
      top = min(static_cast<int>(part.x),
                static_cast<int>((part.y + part.z / 2u) / part.z) + kWindowAboveMean);
  }
  top = min(max(top, kWindowBinades - 1), 254);
  const uint32_t base = static_cast<uint32_t>(top - kWindowBinades + 1) << 7;
  for (int k = threadIdx.x; k < kWindow; k += blockDim.x) {
    const float a = __uint_as_float((base + static_cast<uint32_t>(k)) << 16);
    if constexpr (kStochastic)
      win[k] = rounding_entry<kCheckInf>(a, sq.alpha, sq.beta, table);
    else
      win[k] = sq(a, 0u, table);
  }
  __syncthreads();

  const smaq::Draws d = kStochastic ? smaq::draws(key, call, offset) : smaq::Draws{};
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t c = first; c < chunks; c += stride) {
    if (c + stride < chunks) next = xv[c + stride];
    const uint4 r0 = kStochastic ? smaq::group_words<kOffset>(d, 2 * c) : none;
    const uint4 r1 = kStochastic ? smaq::group_words<kOffset>(d, 2 * c + 1) : none;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const uint32_t rw[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    uint32_t o[4];
    bool slow = false;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = smaq::pack_bf16x2(
          __uint_as_float(from_window<kStochastic>(w[j] & 0xFFFFu, rw[2 * j], win, base, slow)),
          __uint_as_float(from_window<kStochastic>(w[j] >> 16, rw[2 * j + 1], win, base, slow)));
    if (slow) {
      // the elements off the window by the full expression, from the
      // chunk's words and random words (element j: half j & 1 of word
      // j >> 1, random word j), one element a step
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? (j < 2 ? v.x : v.y) : (j < 6 ? v.z : v.w);
        const uint32_t h = (j & 1) ? word >> 16 : word & 0xFFFFu;
        if (!off_window(h, base)) continue;
        const uint4 r = j < 4 ? r0 : r1;
        const uint32_t rand = (j & 3) < 2 ? ((j & 1) ? r.y : r.x) : ((j & 1) ? r.w : r.z);
        const uint32_t b = __bfloat16_as_ushort(
            smaq::from_float<bf16>(sq(__uint_as_float(h << 16), rand, table)));
        const int sh = (j & 1) * 16;
        const uint32_t keep = ~(0xFFFFu << sh), put = b << sh;
        o[0] = (j >> 1) == 0 ? (o[0] & keep) | put : o[0];
        o[1] = (j >> 1) == 1 ? (o[1] & keep) | put : o[1];
        o[2] = (j >> 1) == 2 ? (o[2] & keep) | put : o[2];
        o[3] = (j >> 1) == 3 ? (o[3] & keep) | put : o[3];
      }
    }
    yv[c] = make_uint4(o[0], o[1], o[2], o[3]);
    v = next;
  }
  // the elements past the last whole chunk (all of them when x or y is not
  // 16-byte aligned), by the full expression
  for (int64_t e = (chunks << 3) + first; e < n; e += stride) {
    const uint32_t rand = kStochastic ? smaq::element_word(d, e) : 0u;
    y[e] = smaq::from_float<bf16>(sq(to_float(x[e]), rand, table));
  }
}

template <typename T>
using QuantizeKernel = void (*)(const T*, T*, int64_t, const Consts*,
                                const unsigned long long*, uint32_t, long long);

// The instance of a mode; a stochastic launch at an element offset other
// than 0 takes the offset's (philox.cuh: Draws).
template <typename T>
QuantizeKernel<T> quantize_kernel(int stochastic, int check_inf, long long offset = 0) {
  if (stochastic && smaq::has_offset(offset))
    return check_inf ? s2fp8_quantize_kernel<T, true, true, true>
                     : s2fp8_quantize_kernel<T, true, false, true>;
  if (stochastic)
    return check_inf ? s2fp8_quantize_kernel<T, true, true>
                     : s2fp8_quantize_kernel<T, true, false>;
  return check_inf ? s2fp8_quantize_kernel<T, false, true>
                   : s2fp8_quantize_kernel<T, false, false>;
}

template <typename T>
void launch_quantize(const void* x, void* y, long long n, const float* consts,
                     const unsigned long long* key, unsigned int call, long long offset,
                     int stochastic, int check_inf, int num_blocks, int threads,
                     cudaStream_t stream) {
  quantize_kernel<T>(stochastic, check_inf, offset)<<<num_blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n),
      reinterpret_cast<const Consts*>(consts), key, call, offset);
}

using QuantizeWindowKernel = decltype(&s2fp8_quantize_window_kernel<true, true>);

QuantizeWindowKernel quantize_window_kernel(int stochastic, int check_inf,
                                            long long offset = 0) {
  if (stochastic && smaq::has_offset(offset))
    return check_inf ? s2fp8_quantize_window_kernel<true, true, true>
                     : s2fp8_quantize_window_kernel<true, false, true>;
  if (stochastic)
    return check_inf ? s2fp8_quantize_window_kernel<true, true>
                     : s2fp8_quantize_window_kernel<true, false>;
  return check_inf ? s2fp8_quantize_window_kernel<false, true>
                   : s2fp8_quantize_window_kernel<false, false>;
}

}  // namespace

extern "C" {

// The entry points launch on `stream` and return cudaGetLastError()
// (cudaErrorInvalidValue for a `dtype` they do not take).  `x` and `y` hold
// float32 (dtype 0) or bfloat16 (dtype 1) elements.  `ws` is the stream's
// workspace: kCounterWords 64-bit words, zero between calls, then the
// constants (kConstWords words), then 2 doubles per stats block.  `consts`
// points at the constants in the workspace, or is NULL for the small form
// (one block).  s2fp8_stats_table and s2fp8_quantize_window are the
// bfloat16 split form's table kernels (the note at the top; blocks of at
// most kBf16Threads for the second); the wrapper picks them
// (s2fp8_kernel.py: split_forms).  The stats kernels' `sums`, unless NULL,
// gets the folded sum and max of log2|x| (2 doubles) the constants come
// from, for a reduction over ranks.  The quantize kernels give element e
// the random word of element offset + e (philox.cuh: Draws).

int s2fp8_stats(const void* x, long long n, int dtype, unsigned long long* ws, double* sums,
                int num_blocks, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    s2fp8_stats_kernel<float><<<num_blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int64_t>(n), ws, sums);
  else if (dtype == 1)
    s2fp8_stats_kernel<bf16><<<num_blocks, threads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<int64_t>(n), ws, sums);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int s2fp8_quantize(const void* x, void* y, long long n, int dtype, const float* consts,
                   const unsigned long long* key, unsigned int call, long long offset,
                   int stochastic, int check_inf, int num_blocks, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_quantize<float>(x, y, n, consts, key, call, offset, stochastic, check_inf,
                           num_blocks, threads, s);
  else if (dtype == 1)
    launch_quantize<bf16>(x, y, n, consts, key, call, offset, stochastic, check_inf,
                          num_blocks, threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int s2fp8_stats_table(const void* x, long long n, unsigned long long* ws, double* sums,
                      int num_blocks, int threads, void* stream) {
  s2fp8_stats_kernel<bf16, true><<<num_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<int64_t>(n), ws, sums);
  return static_cast<int>(cudaGetLastError());
}

int s2fp8_quantize_window(const void* x, void* y, long long n, const float* consts,
                          const unsigned long long* key, unsigned int call, long long offset,
                          int stochastic, int check_inf, int num_blocks, int threads,
                          void* stream) {
  if (consts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  quantize_window_kernel(stochastic, check_inf, offset)<<<num_blocks, threads, 0,
                                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), static_cast<int64_t>(n),
      reinterpret_cast<const Consts*>(consts), key, call, offset);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `threads` threads resident on one SM: kernel 0 s2fp8_stats, 1
// s2fp8_quantize in the given mode (their float32 forms), 2
// s2fp8_quantize_window in the given mode, 3 s2fp8_stats_table.
int s2fp8_occupancy(int kernel, int stochastic, int check_inf, int threads,
                    int* blocks_per_sm) {
  const void* f =
      kernel == 0   ? reinterpret_cast<const void*>(s2fp8_stats_kernel<float>)
      : kernel == 1 ? reinterpret_cast<const void*>(quantize_kernel<float>(stochastic, check_inf))
      : kernel == 2 ? reinterpret_cast<const void*>(quantize_window_kernel(stochastic, check_inf))
                    : reinterpret_cast<const void*>(s2fp8_stats_kernel<bf16, true>);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, f, threads, 0));
}

}  // extern "C"
