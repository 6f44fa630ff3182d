// Counter-based random bits for the port's kernels: Philox4x32-10.
//
// Every kernel that rounds stochastically draws one 32-bit word per element
// from here, counted by element index: the four words of counter g belong
// to elements 4g .. 4g+3, and the key is a 64-bit seed the wrapper draws
// from the caller's host generator.  So the bits do not depend on the
// launch shape, and no state lives on the device between calls.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace smaq {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

__device__ __forceinline__ uint2 philox_key(uint64_t seed) {
  return make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

// The words of elements 4g .. 4g+3.
__device__ __forceinline__ uint4 philox_group(int64_t g, uint2 key) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u), key);
}

// Element e's word of philox_group(e >> 2, key).
__device__ __forceinline__ uint32_t philox_word(uint4 r, int64_t e) {
  const int j = static_cast<int>(e & 3);
  return j == 0 ? r.x : (j == 1 ? r.y : (j == 2 ? r.z : r.w));
}

}  // namespace smaq
