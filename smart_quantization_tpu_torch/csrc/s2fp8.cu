// S2FP8 (shifted-squeezed FP8) fake-quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel smart_quantization_tpu/ops/pallas/s2fp8_kernel.py::
// s2fp8_fused (_kernel 135-184) together with the statistics its wrapper
// computes first (223-237), in the kernel's "intrinsic" form: exp2f/log2f
// on every element.  The TPU's other two forms (hybrid, poly) were an A/B
// test of that chip's vector unit and are not ported.  Two launches, as for
// SmaQ (smaq.cu), since Hopper blocks run in parallel and in no order:
//
//   s2fp8_stats     one pass over x: per block, the sum of log2|x| in double
//                   and the max of log2|x| (zeros count as 0 in both, the
//                   reference quirk), written as one partial per block.  No
//                   atomics: the result does not depend on block order.
//   s2fp8_quantize  every block folds the partials in a fixed order into mu
//                   and max, then alpha = 15 / (max - mu) (15 where max ==
//                   mu), beta = -alpha * mu and 1 / alpha, on the device with
//                   no host sync; then per element: squeeze
//                   exp2(alpha * log2|x| + beta), round onto e5m2
//                   (float_round.cuh, random bits from philox.cuh when
//                   stochastic), unsqueeze exp2((log2 t - beta) / alpha) and
//                   put the sign back.  Zeros stay zeros; inf and NaN go
//                   through the selects of the TPU kernel.
//
// What bounds it: memory, though less clearly than the other kernels.  The
// stats read 4 bytes per element, the quantize reads 4 and writes 4.  Per
// element the quantize does two log2f, two exp2f (each a few instructions
// around a special-function unit op; 16 of those per SM per clock against
// 128 float32 operations) and the integer round: about 60 operations per
// element, which at the card's rate stays under the memory time.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "float_round.cuh"
#include "philox.cuh"

namespace {

using smaq::FloatFmt;

__device__ __forceinline__ float abs_log2(float v) {
  const float a = fabsf(v);
  return a == 0.f ? 0.f : log2f(a);
}

__global__ void s2fp8_stats_kernel(const float* __restrict__ x, int64_t n,
                                   double* __restrict__ partials) {
  __shared__ double sd[32];
  __shared__ float sf[32];
  double s = 0.0;
  float mx = -CUDART_INF_F;
  auto acc = [&](float v) {
    const float lg = abs_log2(v);
    s += lg;
    mx = fmaxf(mx, lg);
  };
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
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
  s = smaq::block_sum(s, sd);
  mx = smaq::block_reduce(mx, sf, smaq::MaxOp());
  if (threadIdx.x == 0) {
    partials[2 * static_cast<int64_t>(blockIdx.x)] = s;
    partials[2 * static_cast<int64_t>(blockIdx.x) + 1] = mx;
  }
}

struct Squeeze {
  float alpha, beta, inv_alpha;
  FloatFmt f;
  bool stochastic, check_inf;

  __device__ __forceinline__ float operator()(float v, uint32_t rand) const {
    const uint32_t bits = __float_as_uint(v);
    const uint32_t sign = bits & 0x80000000u;
    const float a = __uint_as_float(bits & 0x7FFFFFFFu);
    const bool zero = a == 0.f, nonfinite = a >= CUDART_INF_F;
    // the product and the sum rounded apart, as the plain version has them
    float sq = exp2f(__fadd_rn(__fmul_rn(alpha, log2f(zero || nonfinite ? 1.f : a)), beta));
    sq = zero ? 0.f : sq;
    sq = nonfinite ? a : sq;
    const float t = __uint_as_float(smaq::fp_round(__float_as_uint(sq), rand, f, stochastic, check_inf));
    const bool t_zero = t == 0.f, t_nonfinite = t >= CUDART_INF_F;
    float out = exp2f((log2f(t_zero || t_nonfinite ? 1.f : t) - beta) * inv_alpha);
    out = t_zero ? 0.f : out;
    out = t_nonfinite ? t : out;
    return __uint_as_float(__float_as_uint(out) | sign);
  }
};

__global__ void s2fp8_quantize_kernel(const float* __restrict__ x, float* __restrict__ y,
                                      int64_t n, const double* __restrict__ partials,
                                      int num_partials, FloatFmt f, uint64_t seed,
                                      int stochastic, int check_inf) {
  __shared__ double sd[32];
  __shared__ float sf[32];
  double s = 0.0;
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x; i < num_partials; i += blockDim.x) {
    s += partials[2 * static_cast<int64_t>(i)];
    m = fmaxf(m, static_cast<float>(partials[2 * static_cast<int64_t>(i) + 1]));
  }
  s = smaq::block_sum(s, sd);
  m = smaq::block_reduce(m, sf, smaq::MaxOp());
  const float mu = static_cast<float>(s / static_cast<double>(n));
  const float denom = m - mu;
  Squeeze sq;
  sq.alpha = 15.f / (denom == 0.f ? 15.f : denom);
  sq.beta = -sq.alpha * mu;
  sq.inv_alpha = 1.f / sq.alpha;
  sq.f = f;
  sq.stochastic = stochastic != 0;
  sq.check_inf = check_inf != 0;

  const uint2 key = smaq::philox_key(seed);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t groups = (n + 3) >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const uint4 r = sq.stochastic ? smaq::philox_group(g, key) : make_uint4(0u, 0u, 0u, 0u);
    const int64_t e = g << 2;
    if (aligned && e + 3 < n) {
      const float4 v = reinterpret_cast<const float4*>(x)[g];
      float4 o;
      o.x = sq(v.x, r.x);
      o.y = sq(v.y, r.y);
      o.z = sq(v.z, r.z);
      o.w = sq(v.w, r.w);
      reinterpret_cast<float4*>(y)[g] = o;
    } else {
      const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && e + j < n; ++j) y[e + j] = sq(x[e + j], rw[j]);
    }
  }
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` and return cudaGetLastError().

int s2fp8_stats(const float* x, long long n, double* partials, int num_blocks,
                int threads, void* stream) {
  s2fp8_stats_kernel<<<num_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int64_t>(n), partials);
  return static_cast<int>(cudaGetLastError());
}

int s2fp8_quantize(const float* x, float* y, long long n, const double* partials,
                   int num_partials, int man, int emin, unsigned int maxv_bits,
                   unsigned int quantum_bits, float c1, float c2,
                   unsigned long long seed, int stochastic, int check_inf,
                   int num_blocks, int threads, void* stream) {
  const FloatFmt f{man, emin, maxv_bits, quantum_bits, c1, c2};
  s2fp8_quantize_kernel<<<num_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, static_cast<int64_t>(n), partials, num_partials, f,
      static_cast<uint64_t>(seed), stochastic, check_inf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
