// Random words on the card from a step key in device memory (sm_90a).
//
// Not the port of a TPU kernel: the JAX package draws its tensor-op noise
// with jax.random from keys it derives on the device from the step count.
// This fill is what lets the port do the same.  The codebook, the row-wise
// and log2 momentum codecs, the packer, the float formats' plain path,
// BERT's dropout masks and the sampled-stats offset draw their noise here,
// keyed by (step key, call index) exactly as the quantize kernels are
// (philox.cuh), so a CUDA graph that captures a step replays it with the
// key the host wrote into the step's slot, not the key of the capture.
//
// Word e is the word the quantize kernels give element e of a call at the
// same element offset (philox.cuh: Draws); at offset 0,
// philox_word(philox_group(e >> 2, philox_key(key, call)), e).  Two outputs: the 32-bit
// words themselves (uniform == 0, into int32 storage), or float32 uniforms
// in [0, 1) from their top 24 bits ((w >> 8) * 2^-24, exact in float32).
// ops/cuda/philox_kernel.py::philox_fill_reference is the plain version.
//
// What bounds it: memory.  4 bytes written per element; a Philox call (10
// rounds of two 32-bit multiplies) per 4 elements is far below the card's
// integer rate.  Each thread writes one 16-byte store per group where the
// output is aligned.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

template <bool kOffset>
__global__ void philox_fill_kernel(uint32_t* __restrict__ out, int64_t n,
                                   const unsigned long long* __restrict__ key, uint32_t call,
                                   long long offset, int uniform) {
  const smaq::Draws d = smaq::draws(key, call, offset);
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int64_t groups = (n + 3) >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    uint4 r = smaq::group_words<kOffset>(d, g);
    if (uniform) {
      r = make_uint4(__float_as_uint(static_cast<float>(r.x >> 8) * 0x1p-24f),
                     __float_as_uint(static_cast<float>(r.y >> 8) * 0x1p-24f),
                     __float_as_uint(static_cast<float>(r.z >> 8) * 0x1p-24f),
                     __float_as_uint(static_cast<float>(r.w >> 8) * 0x1p-24f));
    }
    const int64_t e = g << 2;
    if (aligned && e + 3 < n) {
      reinterpret_cast<uint4*>(out)[g] = r;
    } else {
      const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
      for (int j = 0; j < 4 && e + j < n; ++j) out[e + j] = rw[j];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError().  `out` holds n 32-bit
// words (int32 or float32 storage); `key` points at one 64-bit step key;
// word e is element offset + e's of the whole (philox.cuh: Draws).
int philox_fill(void* out, long long n, const unsigned long long* key, unsigned int call,
                long long offset, int uniform, int num_blocks, int threads, void* stream) {
  const auto kernel =
      smaq::has_offset(offset) ? philox_fill_kernel<true> : philox_fill_kernel<false>;
  kernel<<<num_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<int64_t>(n), key, call, offset, uniform);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
