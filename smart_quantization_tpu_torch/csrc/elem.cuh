// The element types the port's elementwise kernels take: float32 and
// bfloat16.
//
// A kernel reads and writes its tensor in groups of four consecutive
// elements (group g holds elements 4g .. 4g+3, the group a Philox counter
// covers, philox.cuh), one vector access a group: a 16-byte float4 for
// float32, an 8-byte pair of bf16x2 for bfloat16.  Every kernel does its
// arithmetic in float32 (and float64 where it sums) on the widened
// elements whatever the storage type, and a bfloat16 result is rounded to
// nearest-even once, at the store.  Widening bf16 to float32 is exact, and
// a thread visits the same groups in the same order for either type, so a
// bfloat16 call computes bit for bit what the float32 kernel computes on
// x.float(), followed by .to(torch.bfloat16).  The narrower type halves
// the bytes a group moves; the groups, the grid and the ragged tail (the
// elements past the last whole group) stay the float32 kernel's.

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

// Group g of x, widened.
__device__ __forceinline__ float4 load_group(const float* __restrict__ x, int64_t g) {
  return reinterpret_cast<const float4*>(x)[g];
}
__device__ __forceinline__ float4 load_group(const bf16* __restrict__ x, int64_t g) {
  const uint2 u = reinterpret_cast<const uint2*>(x)[g];
  // a bf16 is the top half of its float32: element 2k is the low half of word k
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}

// Group g of y, rounded to y's type.
__device__ __forceinline__ void store_group(float* __restrict__ y, int64_t g, float4 v) {
  reinterpret_cast<float4*>(y)[g] = v;
}
__device__ __forceinline__ void store_group(bf16* __restrict__ y, int64_t g, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(y)[g] = u;
}

}  // namespace smaq
