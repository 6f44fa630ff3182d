// Rounding of one float32 onto an exp/man float grid, in the integer domain.
//
// The device form of smart_quantization_tpu/ops/float_format.py:96-155 (the
// per-element integer version; the TPU kernel's constant-shift split,
// float_kernel.py:65-70, was a Mosaic limit and does not carry over), and
// the plain version in ops/float_format.py.  Shared by float_quantize.cu
// and s2fp8.cu.
//
// Everything but the below-one-quantum test works on the bit pattern, so
// the result does not depend on how the card treats denormals.  That test
// multiplies |x| by two powers of two, which is exact as long as denormals
// are kept: the library is built without -ftz/--use_fast_math for that.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace smaq {

struct FloatFmt {
  int man;                // mantissa bits kept
  int emin;               // least normal exponent
  uint32_t maxv_bits;     // bits of the largest finite value
  uint32_t quantum_bits;  // bits of the subnormal step 2^(emin - man)
  float c1, c2;           // 1 / quantum as two exact powers of two
};

// The rounding's last steps, once the bits to add (`r`) and to clear
// (`mask`) are known, and whether x lies below one quantum (`below`).
__device__ __forceinline__ uint32_t fp_round_finish(uint32_t bits, uint32_t r, uint32_t mask,
                                                    bool below, uint32_t rand,
                                                    const FloatFmt& f, bool stochastic,
                                                    bool check_inf) {
  const uint32_t sign = bits & 0x80000000u;
  const uint32_t mag = bits & 0x7FFFFFFFu;
  uint32_t out = (mag + r) & ~mask;
  if (below) {  // below one quantum: 0 or the quantum
    const float t = __uint_as_float(mag) * f.c1 * f.c2;
    const bool up = stochastic ? t > static_cast<float>(rand >> 8) * 0x1p-24f : t > 0.5f;
    out = up ? f.quantum_bits : 0u;
  }
  if (out > f.maxv_bits) out = f.maxv_bits;  // saturate
  if (mag == 0u) out = 0u;
  if (check_inf && out == f.maxv_bits && sign == 0u) out = 0x7F800000u;  // +max -> +inf
  out |= sign;
  if ((mag & 0x7F800000u) == 0x7F800000u) out = bits;  // inf and NaN pass through
  return out;
}

// `rand` is this element's 32-bit word (read only when stochastic).
__device__ __forceinline__ uint32_t fp_round(uint32_t bits, uint32_t rand, const FloatFmt& f,
                                             bool stochastic, bool check_inf) {
  const uint32_t mag = bits & 0x7FFFFFFFu;
  // fp32 lattice bits below the target grid: 23 - man on the normal range,
  // one more per binade below emin (fp32 subnormals share e == -126)
  const int e_x = static_cast<int>(mag >> 23) - 127;
  const int p_raw = (23 - f.man) + max(f.emin - max(e_x, -126), 0);
  const int p = min(max(p_raw, 0), 23);
  const uint32_t mask = (1u << p) - 1u;
  uint32_t r;
  if (stochastic) {
    r = rand & mask;
  } else {  // nearest even: add half - 1 + the kept lsb, then truncate
    r = p > 0 ? (1u << (p - 1)) - 1u + ((mag >> p) & 1u) : 0u;
  }
  return fp_round_finish(bits, r, mask, p_raw > 23, rand, f, stochastic, check_inf);
}

// fp_round's mask, the kept grid's last bit (0 where no bit is rounded
// away) and "below one quantum", which depend on x's exponent field alone,
// packed for a table of the 256 exponents: the mask with "below" in bit
// 31, and the lsb.  With them, nearest adds half - 1 and the kept lsb:
// the same r as fp_round's.
__device__ __forceinline__ uint2 grid_shift(uint32_t exponent, const FloatFmt& f) {
  const int e_x = static_cast<int>(exponent) - 127;
  const int p_raw = (23 - f.man) + max(f.emin - max(e_x, -126), 0);
  const int p = min(max(p_raw, 0), 23);
  const uint32_t mask = (1u << p) - 1u;
  return make_uint2(mask | (p_raw > 23 ? 0x80000000u : 0u), p > 0 ? mask + 1u : 0u);
}

__device__ __forceinline__ uint32_t fp_round_shift(uint32_t bits, uint32_t rand, uint2 shift,
                                                   const FloatFmt& f, bool stochastic,
                                                   bool check_inf) {
  const uint32_t mask = shift.x & 0x7FFFFFFFu;
  const uint32_t r = stochastic ? rand & mask
                                : (mask >> 1) + ((bits & shift.y) != 0u ? 1u : 0u);
  return fp_round_finish(bits, r, mask, (shift.x >> 31) != 0u, rand, f, stochastic, check_inf);
}

}  // namespace smaq
