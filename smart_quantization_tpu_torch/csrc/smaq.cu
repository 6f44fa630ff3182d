// Fused SmaQ quantize->dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernel smart_quantization_tpu/ops/pallas/smaq_kernel.py::
// smaq_fused (body _kernel, lines 62-190) together with the one-pass
// statistics reduction its wrapper runs first (lines 245-278).  It computes
// what that kernel computes, not how: the TPU's 1024-lane rows, power-of-two
// row bucketing, zero padding with its pad correction, and the SMEM scratch
// carried across a sequential grid do not carry over.  Blocks on Hopper run
// in parallel and in no order, so the work is two launches:
//
//   smaq_stats     one pass over x.  Every block computes the pivot (mean of
//                  the first min(n, 256) elements, which stay in L2), then
//                  accumulates sum(d) and sum(d*d) of d = x - pivot in double,
//                  plus min and max, and writes one partial per block.  No
//                  float atomics: the result does not depend on block order.
//   smaq_quantize  every block first folds the partials in a fixed order, in
//                  double, into mean and std (ddof=1, or the range estimator),
//                  applies the zero-std guard and the clamp and derives the
//                  folded reciprocals of smaq_kernel.py:119-130; then one read
//                  and one write per element.  Rounding is trunc or
//                  floor(q + u), u the top 24 bits of a counter-based
//                  Philox4x32-10 (philox.cuh) keyed by a per-call 64-bit seed
//                  and counted by element index (the output does not depend
//                  on the launch shape).  The outlier count goes through a
//                  block reduction and one 64-bit integer atomicAdd per
//                  block; the last block to finish turns it into the size in
//                  bits, on the device.
//   smaq_quantize_bn  the same pass with BatchNorm's per-channel (gamma,
//                  beta) folded in: the port of smaq_kernel.py::smaq_fused_bn
//                  (_kernel_bn 398-482).  Stats come from smaq_stats on the
//                  raw tensor, before the unfold (the reference quirk); gamma
//                  = 0 is taken as 1.  The tensor is NCHW, so the channel of
//                  element e is (e / (H*W)) % C; each block stages the four
//                  folded constants of every channel in shared memory.
//
// What bounds them: memory.  Full stats move 12 bytes per element (two
// reads, one write); caller-supplied stats 8 bytes.  The operations per
// element (about 20 float32 operations and a tenth of a Philox call, and
// for BN a 32-bit division per four elements) are far below the card's
// rate.  So the design keeps to two passes, writes no temporaries to device
// memory beyond one partial per block, and loads and stores float4 where
// both pointers are 16-byte aligned.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "philox.cuh"

namespace {

using smaq::block_reduce;
using smaq::block_sum;
using smaq::MaxOp;
using smaq::MinOp;

constexpr int kPivotElems = 256;

__global__ void smaq_stats_kernel(const float* __restrict__ x, int64_t n,
                                  double* __restrict__ partials) {
  __shared__ double sd[32];
  __shared__ float sf[32];

  const int64_t n_pivot = n < kPivotElems ? n : kPivotElems;
  float pv = 0.f;
  for (int64_t i = threadIdx.x; i < n_pivot; i += blockDim.x) pv += x[i];
  const float pivot = block_sum(pv, sf) / static_cast<float>(n_pivot);

  double s1 = 0.0, s2 = 0.0;
  float mn = CUDART_INF_F, mx = -CUDART_INF_F;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  auto acc = [&](float v) {
    const float d = v - pivot;
    s1 += d;
    s2 += static_cast<double>(d) * d;
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  };
  int64_t head = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      acc(v.x);
      acc(v.y);
      acc(v.z);
      acc(v.w);
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) acc(x[i]);

  s1 = block_sum(s1, sd);
  s2 = block_sum(s2, sd);
  mn = block_reduce(mn, sf, MinOp());
  mx = block_reduce(mx, sf, MaxOp());
  if (threadIdx.x == 0) {
    double* p = partials + 4 * static_cast<int64_t>(blockIdx.x);
    p[0] = s1;
    p[1] = s2;
    p[2] = mn;
    p[3] = mx;
    if (blockIdx.x == 0) partials[4 * static_cast<int64_t>(gridDim.x)] = pivot;
  }
}

struct Quant {
  float a, b, t, range_main, range_outlier, inv_main_std, inv_out_std, t_std, mean;
  bool stochastic, all_positive;

  // q = round((z + shift) * scale); y = q * std / scale + shift * std + mean
  __device__ __forceinline__ float operator()(float x, uint32_t bits, int& cnt) const {
    const float z = x * a + b;
    const bool hi = z > t, lo = z < -t, out = hi || lo;
    const float shift = hi ? -t : (lo ? t : 0.f);
    const float scale = out ? range_outlier : range_main;
    float q = (z + shift) * scale;
    q = stochastic ? floorf(q + static_cast<float>(bits >> 8) * 0x1p-24f) : truncf(q);
    const float inv = out ? inv_out_std : inv_main_std;
    const float st = hi ? t_std : (lo ? -t_std : 0.f);
    float y = q * inv + st + mean;
    if (all_positive && y < 0.f) y = 0.f;
    cnt += out;
    return y;
  }
};

struct Stats {
  float mean, std;
};

// stats_mode: 0 = stats[0..1] hold (mean, std); 1 = fold the partials with
// the ddof=1 std; 2 = fold the partials with the range std.  Then the
// zero-std guard and the clamp.  Every block does this first.
__device__ Stats fold_stats(int64_t n, const float* __restrict__ stats,
                            const double* __restrict__ partials, int num_partials,
                            int stats_mode, float std_lo, float std_hi, double* sd,
                            float* sf) {
  float mean, std;
  if (stats_mode == 0) {
    mean = stats[0];
    std = stats[1];
  } else {
    double s1 = 0.0, s2 = 0.0;
    float mn = CUDART_INF_F, mx = -CUDART_INF_F;
    for (int i = threadIdx.x; i < num_partials; i += blockDim.x) {
      const double* p = partials + 4 * static_cast<int64_t>(i);
      s1 += p[0];
      s2 += p[1];
      mn = fminf(mn, static_cast<float>(p[2]));
      mx = fmaxf(mx, static_cast<float>(p[3]));
    }
    s1 = block_sum(s1, sd);
    s2 = block_sum(s2, sd);
    const double nn = static_cast<double>(n);
    const double pivot = partials[4 * static_cast<int64_t>(num_partials)];
    mean = static_cast<float>(pivot + s1 / nn);
    if (stats_mode == 1) {
      const double var = fmax((s2 - s1 * (s1 / nn)) / fmax(nn - 1.0, 1.0), 0.0);
      std = static_cast<float>(sqrt(var));
    } else {
      mn = block_reduce(mn, sf, MinOp());
      mx = block_reduce(mx, sf, MaxOp());
      std = (mx - mn) / sqrtf(2.f * logf(static_cast<float>(n)));
    }
  }
  if (std == 0.f) std = 1.f;
  std = fminf(fmaxf(std, std_lo), std_hi);
  return Stats{mean, std};
}

// The size in bits from the block's outlier count: one 64-bit integer
// atomicAdd per block; the last block to finish writes the size.
__device__ void write_size(int cnt, int64_t n, int compute_size, int bits_main,
                           int bits_outlier, unsigned long long* __restrict__ counter,
                           float* __restrict__ size_out, unsigned long long* su) {
  if (!compute_size) {
    if (blockIdx.x == 0 && threadIdx.x == 0)
      size_out[0] = static_cast<float>(static_cast<double>(n) * bits_main);
    return;
  }
  const unsigned long long block_cnt = block_sum(static_cast<unsigned long long>(cnt), su);
  if (threadIdx.x == 0) {
    atomicAdd(&counter[0], block_cnt);
    __threadfence();
    const unsigned long long done = atomicAdd(&counter[1], 1ull);
    if (done == gridDim.x - 1) {
      const unsigned long long total = atomicAdd(&counter[0], 0ull);
      size_out[0] = static_cast<float>(static_cast<double>(n) * bits_main +
                                       static_cast<double>(total) * (bits_outlier - bits_main));
    }
  }
}

__global__ void smaq_quantize_kernel(
    const float* __restrict__ x, float* __restrict__ y, int64_t n,
    const float* __restrict__ stats, const double* __restrict__ partials,
    int num_partials, int stats_mode, uint64_t seed, int stochastic,
    int all_positive, int compute_size, float t, float range_main,
    float range_outlier, float inv_range_main, float inv_range_outlier,
    float std_lo, float std_hi, int bits_main, int bits_outlier,
    unsigned long long* __restrict__ counter, float* __restrict__ size_out) {
  __shared__ double sd[32];
  __shared__ float sf[32];
  __shared__ unsigned long long su[32];

  const Stats st = fold_stats(n, stats, partials, num_partials, stats_mode, std_lo, std_hi, sd, sf);
  const float mean = st.mean, std = st.std;

  Quant qz;
  qz.a = 1.f / std;
  qz.b = -mean * qz.a;
  qz.t = t;
  qz.range_main = range_main;
  qz.range_outlier = range_outlier;
  qz.inv_out_std = std * inv_range_outlier;
  qz.inv_main_std = std * inv_range_main;
  qz.t_std = t * std;
  qz.mean = mean;
  qz.stochastic = stochastic != 0;
  qz.all_positive = all_positive != 0;

  const uint2 key = smaq::philox_key(seed);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t groups = (n + 3) >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int cnt = 0;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (qz.stochastic)
      r = smaq::philox_group(g, key);
    const int64_t e = g << 2;
    if (aligned && e + 3 < n) {
      const float4 v = reinterpret_cast<const float4*>(x)[g];
      float4 o;
      o.x = qz(v.x, r.x, cnt);
      o.y = qz(v.y, r.y, cnt);
      o.z = qz(v.z, r.z, cnt);
      o.w = qz(v.w, r.w, cnt);
      reinterpret_cast<float4*>(y)[g] = o;
    } else {
      const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && e + j < n; ++j) y[e + j] = qz(x[e + j], rw[j], cnt);
    }
  }
  write_size(cnt, n, compute_size, bits_main, bits_outlier, counter, size_out, su);
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
__global__ void smaq_quantize_bn_kernel(
    const float* __restrict__ x, float* __restrict__ y, int64_t n,
    const float* __restrict__ stats, const double* __restrict__ partials,
    int num_partials, int stats_mode, const float* __restrict__ gamma,
    const float* __restrict__ beta, int channels, int64_t inner, uint64_t seed,
    int stochastic, int all_positive, int compute_size, float t, float range_main,
    float range_outlier, float inv_range_main, float inv_range_outlier,
    float std_lo, float std_hi, int bits_main, int bits_outlier,
    unsigned long long* __restrict__ counter, float* __restrict__ size_out) {
  __shared__ double sd[32];
  __shared__ float sf[32];
  __shared__ unsigned long long su[32];
  extern __shared__ float4 chan[];

  const Stats st = fold_stats(n, stats, partials, num_partials, stats_mode, std_lo, std_hi, sd, sf);
  const float mean = st.mean, std = st.std;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    const float g = gamma[c] == 0.f ? 1.f : gamma[c];
    const float b = beta[c];
    const float a = 1.f / (g * std);
    chan[c] = make_float4(a, -(b * a) - mean / std, std * g, mean * g + b);
  }
  __syncthreads();

  QuantBN qz{t, range_main, range_outlier, inv_range_main, inv_range_outlier,
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
  const uint2 key = smaq::philox_key(seed);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t groups = (n + 3) >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int cnt = 0;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const uint4 r = qz.stochastic ? smaq::philox_group(g, key) : make_uint4(0u, 0u, 0u, 0u);
    const int64_t e = g << 2;
    if (aligned && group_in_one && e + 3 < n) {
      const float4 k = chan[chan_of(e)];
      const float4 v = reinterpret_cast<const float4*>(x)[g];
      float4 o;
      o.x = qz(v.x, k, r.x, cnt);
      o.y = qz(v.y, k, r.y, cnt);
      o.z = qz(v.z, k, r.z, cnt);
      o.w = qz(v.w, k, r.w, cnt);
      reinterpret_cast<float4*>(y)[g] = o;
    } else {
      const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && e + j < n; ++j)
        y[e + j] = qz(x[e + j], chan[chan_of(e + j)], rw[j], cnt);
    }
  }
  write_size(cnt, n, compute_size, bits_main, bits_outlier, counter, size_out, su);
}

}  // namespace

extern "C" {

// The entry points launch on `stream` and return cudaGetLastError().

int smaq_stats(const float* x, long long n, double* partials, int num_blocks,
               int threads, void* stream) {
  smaq_stats_kernel<<<num_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int64_t>(n), partials);
  return static_cast<int>(cudaGetLastError());
}

int smaq_quantize(const float* x, float* y, long long n, const float* stats,
                  const double* partials, int num_partials, int stats_mode,
                  unsigned long long seed, int stochastic, int all_positive,
                  int compute_size, float t, float range_main,
                  float range_outlier, float inv_range_main,
                  float inv_range_outlier, float std_lo, float std_hi,
                  int bits_main, int bits_outlier, unsigned long long* counter,
                  float* size_out, int num_blocks, int threads, void* stream) {
  smaq_quantize_kernel<<<num_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, static_cast<int64_t>(n), stats, partials, num_partials, stats_mode,
      static_cast<uint64_t>(seed), stochastic, all_positive, compute_size, t,
      range_main, range_outlier, inv_range_main, inv_range_outlier, std_lo,
      std_hi, bits_main, bits_outlier, counter, size_out);
  return static_cast<int>(cudaGetLastError());
}

int smaq_quantize_bn(const float* x, float* y, long long n, const float* stats,
                     const double* partials, int num_partials, int stats_mode,
                     const float* gamma, const float* beta, int channels,
                     long long inner, unsigned long long seed, int stochastic,
                     int all_positive, int compute_size, float t, float range_main,
                     float range_outlier, float inv_range_main,
                     float inv_range_outlier, float std_lo, float std_hi,
                     int bits_main, int bits_outlier, unsigned long long* counter,
                     float* size_out, int num_blocks, int threads, void* stream) {
  const size_t smem = static_cast<size_t>(channels) * sizeof(float4);
  smaq_quantize_bn_kernel<<<num_blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, static_cast<int64_t>(n), stats, partials, num_partials, stats_mode, gamma,
      beta, channels, static_cast<int64_t>(inner), static_cast<uint64_t>(seed),
      stochastic, all_positive, compute_size, t, range_main, range_outlier,
      inv_range_main, inv_range_outlier, std_lo, std_hi, bits_main, bits_outlier,
      counter, size_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
