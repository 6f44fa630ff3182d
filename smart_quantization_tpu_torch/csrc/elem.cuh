// The element types the port's elementwise kernels take: float32 and
// bfloat16.
//
// A kernel reads and writes its tensor in groups of four consecutive
// elements (group g holds elements 4g .. 4g+3, the group a Philox counter
// covers, philox.cuh): a 16-byte float4 for float32, an 8-byte pair of
// bf16x2 for bfloat16.  Every kernel does its arithmetic in float32 (and
// float64 where it sums) on the widened elements whatever the storage
// type, and a bfloat16 result is rounded to nearest-even once, at the
// store.  Widening is exact; where a kernel sums, its bfloat16 form adds
// the same groups in each thread's order as the float32 form, however many
// it loads at once, and where it works element by element (rounding, with
// Philox words counted by group index) the walk order does not matter.  So
// a bfloat16 call computes bit for bit what the float32 kernel computes on
// x.float(), followed by .to(torch.bfloat16), moving half the bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace smaq {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// Whether a pointer can be read and written a group at a time.
template <typename T>
__device__ __forceinline__ bool group_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

// A bf16 is the top half of its float32, and of two bf16 in a 32-bit word
// the first is the low half.
__device__ __forceinline__ float widen_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float widen_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Two floats rounded to nearest-even, as one word of two bf16.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Group g of x as it lies in memory (a float4, or a pair of words holding
// four bf16), and its widening: a streaming loop keeps the raw groups in
// flight, half the registers for bf16.
template <typename T>
struct Group;
template <>
struct Group<float> {
  using Raw = float4;
};
template <>
struct Group<bf16> {
  using Raw = uint2;
};

__device__ __forceinline__ float4 load_raw(const float* __restrict__ x, int64_t g) {
  return reinterpret_cast<const float4*>(x)[g];
}
__device__ __forceinline__ uint2 load_raw(const bf16* __restrict__ x, int64_t g) {
  return reinterpret_cast<const uint2*>(x)[g];
}
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 u) {
  return make_float4(widen_lo(u.x), widen_hi(u.x), widen_lo(u.y), widen_hi(u.y));
}

// Group g of x, widened.
template <typename T>
__device__ __forceinline__ float4 load_group(const T* __restrict__ x, int64_t g) {
  return widen(load_raw(x, g));
}

// Group g of y, rounded to y's type.
__device__ __forceinline__ void store_group(float* __restrict__ y, int64_t g, float4 v) {
  reinterpret_cast<float4*>(y)[g] = v;
}
__device__ __forceinline__ void store_group(bf16* __restrict__ y, int64_t g, float4 v) {
  reinterpret_cast<uint2*>(y)[g] = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

}  // namespace smaq
