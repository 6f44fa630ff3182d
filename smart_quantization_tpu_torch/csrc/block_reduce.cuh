// Block-wide reductions in a fixed order, shared by the port's kernels.

#pragma once

#include <cuda_runtime.h>

namespace smaq {

struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Reduce over the block in a fixed order; every thread gets the result.
// `smem` holds at least 32 values.  Lanes past the last warp re-read
// smem[0], which is harmless for min and max; block_sum pads with zeros.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* smem, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = smem[lane < nwarps ? lane : 0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  v = smem[0];
  __syncthreads();
  return v;
}

template <typename T>
__device__ T block_sum(T v, T* smem) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? smem[lane] : T(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  v = smem[0];
  __syncthreads();
  return v;
}

}  // namespace smaq
