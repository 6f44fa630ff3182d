// Counter-based random bits for the port's kernels: Philox4x32-10.
//
// Every kernel that rounds stochastically draws one 32-bit word per element
// from here, counted by element index: the four words of counter g belong
// to elements 4g .. 4g+3.  The key comes from device memory: a 64-bit step
// key (ops/keys.py) that the kernel reads, mixed with the call index the
// wrapper passes by value (philox_key).  A CUDA graph that captures a launch
// bakes the pointer and the index, not the key, so each replay draws the
// bits of the key the host wrote into that slot before it.  The bits do not
// depend on the launch shape, and no state lives on the device between
// calls.

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

// The mix of a step key and a call index into a Philox key: splitmix64's
// output function on key + (call + 1) * gamma.  ops/keys.py::mix is its
// host mirror (the constants are pinned against it by the tests).
constexpr uint64_t kMixGamma = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kMixM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kMixM2 = 0x94D049BB133111EBull;
constexpr int kMixS1 = 30, kMixS2 = 27, kMixS3 = 31;

__host__ __device__ __forceinline__ uint64_t mix(uint64_t key, uint32_t call) {
  uint64_t z = key + (static_cast<uint64_t>(call) + 1ull) * kMixGamma;
  z = (z ^ (z >> kMixS1)) * kMixM1;
  z = (z ^ (z >> kMixS2)) * kMixM2;
  return z ^ (z >> kMixS3);
}

// The Philox key of draw `call` of the step whose key is at `key`: every
// thread reads the same 8 bytes (one broadcast load a warp).
__device__ __forceinline__ uint2 philox_key(const unsigned long long* key, uint32_t call) {
  const uint64_t k = mix(static_cast<uint64_t>(__ldg(key)), call);
  return make_uint2(static_cast<uint32_t>(k), static_cast<uint32_t>(k >> 32));
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

// The draws of one call on a part of a larger tensor that starts at
// element `offset` of it: element e of the call takes the word that
// element offset + e of the whole takes, so that parts quantized each at
// its offset draw what one call on the whole draws (a rank's rows of a
// global batch).  Offset 0 is the call's own counting.  An offset that is
// not a multiple of 4 puts the call's group g across two of the whole's
// (lanes s.. of one, then ..s-1 of the next): a second Philox call for
// each group, on a branch uniform over the launch.  The kernels' hot loops
// are instantiated with and without an offset (kOffset), and the launch
// picks one, so that offset 0 runs the loop it always ran, in as many
// registers.
struct Draws {
  uint2 key;
  int64_t group;  // offset >> 2
  int shift;      // offset & 3
};

__device__ __forceinline__ Draws draws(const unsigned long long* key, uint32_t call,
                                       long long offset) {
  return Draws{philox_key(key, call), static_cast<int64_t>(offset >> 2),
               static_cast<int>(offset & 3)};
}

// The words of the call's elements 4g .. 4g+3, in a loop instantiated for
// offset 0 (kOffset false) or any other.
template <bool kOffset>
__device__ __forceinline__ uint4 group_words(const Draws& d, int64_t g) {
  if constexpr (!kOffset) {
    return philox_group(g, d.key);
  } else {
    const uint4 a = philox_group(g + d.group, d.key);
    if (d.shift == 0) return a;
    const uint4 b = philox_group(g + d.group + 1, d.key);
    return d.shift == 1 ? make_uint4(a.y, a.z, a.w, b.x)
                        : (d.shift == 2 ? make_uint4(a.z, a.w, b.x, b.y)
                                        : make_uint4(a.w, b.x, b.y, b.z));
  }
}

// Whether a launch at `offset` takes the kOffset instances.
__host__ __device__ __forceinline__ bool has_offset(long long offset) { return offset != 0; }

// The word of the call's element e.
__device__ __forceinline__ uint32_t element_word(const Draws& d, int64_t e) {
  const int64_t f = e + (d.group << 2) + d.shift;
  return philox_word(philox_group(f >> 2, d.key), f);
}

}  // namespace smaq
