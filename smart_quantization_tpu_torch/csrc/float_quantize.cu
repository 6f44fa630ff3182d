// Float-format (exp/man) fake-quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel smart_quantization_tpu/ops/pallas/float_kernel.py::
// float_quantize_fused (_kernel 32-50, body fp_round_block 53-119).  It
// computes what float_format.py:96-155 computes, element by element, in the
// integer domain (float_round.cuh): stochastic rounding adds random bits
// under the kept mantissa and masks them off, nearest rounds to even,
// target subnormals sit on the fixed quantum grid, values saturate at the
// format's max, zeros keep their sign, +max becomes +inf under check_inf,
// and inf and NaN pass through.  Formats: e5m2 (FP8), e5m10 (FP16), e8m7
// (BF16).  The TPU's 1024-lane rows, row buckets and padding do not carry
// over.
//
// Random bits: one 32-bit Philox word per element, counted by element index
// and keyed by the step key in device memory mixed with the call's index
// (philox.cuh).
//
// Element types: float32 or bfloat16 in and out (elem.cuh): a bfloat16 call
// rounds the widened element as the float32 kernel does and rounds the
// result to nearest-even, so it is bit for bit the float32 kernel on
// x.float() followed by .to(torch.bfloat16), 2 + 2 bytes an element.
//
// What bounds it: memory.  One read and one write of 4 bytes per element;
// about 25 integer operations per element, plus a Philox call per 4
// elements when stochastic, are well under the card's rate.  So the kernel
// is one pass, loads and stores float4 where both pointers are 16-byte
// aligned, and keeps no temporaries in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "float_round.cuh"
#include "philox.cuh"

namespace {

using smaq::FloatFmt;
using smaq::fp_round;
using smaq::group_aligned;
using smaq::to_float;

__device__ __forceinline__ float round_one(float v, uint32_t rand, const FloatFmt& f,
                                           bool stochastic, bool check_inf) {
  return __uint_as_float(fp_round(__float_as_uint(v), rand, f, stochastic, check_inf));
}

template <typename T>
__global__ void float_quantize_kernel(const T* __restrict__ x, T* __restrict__ y,
                                      int64_t n, FloatFmt f,
                                      const unsigned long long* __restrict__ key,
                                      uint32_t call, int stochastic, int check_inf) {
  const bool st = stochastic != 0, ci = check_inf != 0;
  const uint2 pkey = st ? smaq::philox_key(key, call) : make_uint2(0u, 0u);
  const bool aligned = group_aligned<T>(x) && group_aligned<T>(y);
  const int64_t groups = (n + 3) >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const uint4 r = st ? smaq::philox_group(g, pkey) : make_uint4(0u, 0u, 0u, 0u);
    const int64_t e = g << 2;
    if (aligned && e + 3 < n) {
      const float4 v = smaq::load_group(x, g);
      float4 o;
      o.x = round_one(v.x, r.x, f, st, ci);
      o.y = round_one(v.y, r.y, f, st, ci);
      o.z = round_one(v.z, r.z, f, st, ci);
      o.w = round_one(v.w, r.w, f, st, ci);
      smaq::store_group(y, g, o);
    } else {
      const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && e + j < n; ++j)
        y[e + j] = smaq::from_float<T>(round_one(to_float(x[e + j]), rw[j], f, st, ci));
    }
  }
}

template <typename T>
void launch(const void* x, void* y, long long n, const FloatFmt& f,
            const unsigned long long* key, unsigned int call, int stochastic, int check_inf,
            int num_blocks, int threads, cudaStream_t stream) {
  float_quantize_kernel<T><<<num_blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n), f, key, call,
      stochastic, check_inf);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for a `dtype` it does not take).  `x` and `y` hold float32 (dtype 0) or
// bfloat16 (dtype 1) elements: a bfloat16 result is the float32 one rounded
// to nearest-even (elem.cuh).
int float_quantize(const void* x, void* y, long long n, int dtype, int man, int emin,
                   unsigned int maxv_bits, unsigned int quantum_bits, float c1,
                   float c2, const unsigned long long* key, unsigned int call,
                   int stochastic, int check_inf,
                   int num_blocks, int threads, void* stream) {
  const FloatFmt f{man, emin, maxv_bits, quantum_bits, c1, c2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, y, n, f, key, call, stochastic, check_inf, num_blocks, threads, s);
  else if (dtype == 1)
    launch<smaq::bf16>(x, y, n, f, key, call, stochastic, check_inf, num_blocks, threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
