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
// from the call's element offset and keyed by the step key in device memory
// mixed with the call's index (philox.cuh: Draws).
//
// Element types: float32 or bfloat16 in and out (elem.cuh): a bfloat16 call
// rounds the widened element as the float32 kernel does and rounds the
// result to nearest-even, so it is bit for bit the float32 kernel on
// x.float() followed by .to(torch.bfloat16), 2 + 2 bytes an element.
//
// What bounds it: memory.  One read and one write of 4 bytes per element
// (2 + 2 in bfloat16); about 25 integer operations per element, plus a
// Philox call per 4 elements when stochastic, are under the card's rate.
// So the kernel is one pass and keeps no temporaries in device memory.
// The float32 form takes a group of four (a float4) a thread per loop step
// on quant_blocks' grid.  The bfloat16 form has its own loop: a thread
// reads two adjacent groups (8 bf16) in one 16-byte load, on a grid of
// every block the card holds at once (the wrapper's occupancy query), and
// issues the next chunk's load before it rounds this one.  The rounding
// (about 25 integer operations an element, and a Philox call a group when
// stochastic) is what sets the pace at half the bytes, so the loop keeps
// one load ahead rather than four before any rounding: measured on an
// H100, four in flight ran 29.8 us at 8 M elements, one ahead 25.4
// (PERF.md, PR 9).  The ragged tail and pointers that are not 16-byte
// aligned take the group-at-a-time path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"
#include "float_round.cuh"
#include "philox.cuh"

namespace {

using smaq::bf16;
using smaq::FloatFmt;
using smaq::fp_round;
using smaq::group_aligned;
using smaq::to_float;

__device__ __forceinline__ float round_one(float v, uint32_t rand, const FloatFmt& f,
                                           bool stochastic, bool check_inf) {
  return __uint_as_float(fp_round(__float_as_uint(v), rand, f, stochastic, check_inf));
}

// Groups first, first + stride, ... of x, one a thread per step: a float4
// (or 8 bytes of bf16) where both pointers allow it, else element by
// element.
template <typename T, bool kOffset>
__device__ __forceinline__ void round_groups(const T* __restrict__ x, T* __restrict__ y,
                                             int64_t n, int64_t first, int64_t stride,
                                             const FloatFmt& f, const smaq::Draws& d, bool st,
                                             bool ci) {
  const bool aligned = group_aligned<T>(x) && group_aligned<T>(y);
  const int64_t groups = (n + 3) >> 2;
  for (int64_t g = first; g < groups; g += stride) {
    const uint4 r = st ? smaq::group_words<kOffset>(d, g) : make_uint4(0u, 0u, 0u, 0u);
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

template <typename T, bool kOffset>
__global__ void float_quantize_kernel(const T* __restrict__ x, T* __restrict__ y,
                                      int64_t n, FloatFmt f,
                                      const unsigned long long* __restrict__ key,
                                      uint32_t call, long long offset, int stochastic,
                                      int check_inf) {
  const bool st = stochastic != 0, ci = check_inf != 0;
  const smaq::Draws d = st ? smaq::draws(key, call, offset) : smaq::Draws{};
  round_groups<T, kOffset>(x, y, n,
                             static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
                             static_cast<int64_t>(gridDim.x) * blockDim.x, f, d, st, ci);
}

// The bfloat16 loop looks each element's grid_shift up by its exponent
// field in a table of 256 entries that every block builds once: the same
// values fp_round computes, so the same bits, for fewer operations an
// element.
__device__ __forceinline__ uint32_t round_with(uint32_t bits, uint32_t rand,
                                               const uint2* __restrict__ shifts,
                                               const FloatFmt& f, bool st, bool ci) {
  return smaq::fp_round_shift(bits, rand, shifts[(bits >> 23) & 0xFFu], f, st, ci);
}

// Two bf16 of a word rounded, with their two Philox words.
__device__ __forceinline__ uint32_t round_word(uint32_t w, uint32_t r0, uint32_t r1,
                                               const uint2* __restrict__ shifts,
                                               const FloatFmt& f, bool st, bool ci) {
  return smaq::pack_bf16x2(
      __uint_as_float(round_with(__float_as_uint(smaq::widen_lo(w)), r0, shifts, f, st, ci)),
      __uint_as_float(round_with(__float_as_uint(smaq::widen_hi(w)), r1, shifts, f, st, ci)));
}

// Chunk c of 8 bf16 (groups 2c and 2c + 1) rounded.
template <bool kOffset>
__device__ __forceinline__ uint4 round_chunk(uint4 v, int64_t c, const uint2* shifts,
                                             const FloatFmt& f, const smaq::Draws& d, bool st,
                                             bool ci) {
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  const uint4 r0 = st ? smaq::group_words<kOffset>(d, 2 * c) : none;
  const uint4 r1 = st ? smaq::group_words<kOffset>(d, 2 * c + 1) : none;
  return make_uint4(round_word(v.x, r0.x, r0.y, shifts, f, st, ci),
                    round_word(v.y, r0.z, r0.w, shifts, f, st, ci),
                    round_word(v.z, r1.x, r1.y, shifts, f, st, ci),
                    round_word(v.w, r1.z, r1.w, shifts, f, st, ci));
}

// The rounding mode and check_inf are template parameters here, so the
// issue-bound loop carries one rounding path, not both and a select.
template <bool st, bool ci, bool kOffset>
__global__ void __launch_bounds__(256)
float_quantize_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int64_t n,
                           FloatFmt f, const unsigned long long* __restrict__ key,
                           uint32_t call, long long offset) {
  __shared__ uint2 shifts[256];
  for (int e = threadIdx.x; e < 256; e += blockDim.x) shifts[e] = smaq::grid_shift(e, f);
  __syncthreads();
  const smaq::Draws d = st ? smaq::draws(key, call, offset) : smaq::Draws{};
  const bool wide = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int64_t pairs = wide ? n >> 3 : 0;  // 16-byte chunks: groups 2c and 2c + 1
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  // the next chunk's load goes out before this one is rounded
  uint4 v = make_uint4(0u, 0u, 0u, 0u), next = v;
  if (first < pairs) v = xv[first];
  for (int64_t c = first; c < pairs; c += stride) {
    if (c + stride < pairs) next = xv[c + stride];
    yv[c] = round_chunk<kOffset>(v, c, shifts, f, d, st, ci);
    v = next;
  }
  // the groups past the last whole chunk (all of them when not 16-byte aligned)
  round_groups<bf16, kOffset>(x, y, n, 2 * pairs + first, stride, f, d, st, ci);
}

// The bfloat16 loop's instances: [4 * has_offset + 2 * stochastic + check_inf].
using Bf16Kernel = decltype(&float_quantize_bf16_kernel<true, true, false>);
const Bf16Kernel kBf16Kernels[] = {
    float_quantize_bf16_kernel<false, false, false>, float_quantize_bf16_kernel<false, true, false>,
    float_quantize_bf16_kernel<true, false, false>,  float_quantize_bf16_kernel<true, true, false>,
    float_quantize_bf16_kernel<false, false, true>,  float_quantize_bf16_kernel<false, true, true>,
    float_quantize_bf16_kernel<true, false, true>,   float_quantize_bf16_kernel<true, true, true>};

template <typename T>
void launch(const void* x, void* y, long long n, const FloatFmt& f,
            const unsigned long long* key, unsigned int call, long long offset, int stochastic,
            int check_inf, int num_blocks, int threads, cudaStream_t stream) {
  const auto kernel = smaq::has_offset(offset) ? float_quantize_kernel<T, true>
                                               : float_quantize_kernel<T, false>;
  kernel<<<num_blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int64_t>(n), f, key, call,
      offset, stochastic, check_inf);
}

template <>
void launch<bf16>(const void* x, void* y, long long n, const FloatFmt& f,
                  const unsigned long long* key, unsigned int call, long long offset,
                  int stochastic, int check_inf, int num_blocks, int threads,
                  cudaStream_t stream) {
  const Bf16Kernel kernel =
      kBf16Kernels[4 * smaq::has_offset(offset) + 2 * (stochastic != 0) + (check_inf != 0)];
  kernel<<<num_blocks, threads, 0, stream>>>(static_cast<const bf16*>(x), static_cast<bf16*>(y),
                                             static_cast<int64_t>(n), f, key, call, offset);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for a `dtype` it does not take).  `x` and `y` hold float32 (dtype 0) or
// bfloat16 (dtype 1) elements: a bfloat16 result is the float32 one rounded
// to nearest-even (elem.cuh).  Stochastic rounding gives element e the word
// of element offset + e (philox.cuh: Draws).
int float_quantize(const void* x, void* y, long long n, int dtype, int man, int emin,
                   unsigned int maxv_bits, unsigned int quantum_bits, float c1,
                   float c2, const unsigned long long* key, unsigned int call,
                   long long offset, int stochastic, int check_inf,
                   int num_blocks, int threads, void* stream) {
  const FloatFmt f{man, emin, maxv_bits, quantum_bits, c1, c2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, y, n, f, key, call, offset, stochastic, check_inf, num_blocks, threads, s);
  else if (dtype == 1)
    launch<bf16>(x, y, n, f, key, call, offset, stochastic, check_inf, num_blocks, threads, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `threads` threads resident on one SM for the form of `dtype`
// (for bfloat16, the fewest of its four instances at offset 0).
int float_occupancy(int dtype, int threads, int* blocks_per_sm) {
  if (dtype == 0)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, float_quantize_kernel<float, false>, threads, 0));
  int fewest = 1 << 30;
  // the grid is sized for offset 0 (the first four instances); a launch at
  // another offset runs on the same grid
  for (int i = 0; i < 4; ++i) {
    const Bf16Kernel kernel = kBf16Kernels[i];
    int b = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, threads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (b < fewest) fewest = b;
  }
  *blocks_per_sm = fewest;
  return 0;
}

}  // extern "C"
