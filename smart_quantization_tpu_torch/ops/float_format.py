"""Parametric low-precision float fake-quantization (exp/man), plain PyTorch.

The counterpart of ``smart_quantization_tpu/ops/float_format.py``, with its
per-element integer form (lines 96-155):

- stochastic rounding adds random bits below the kept mantissa and
  truncates; a carry runs into the exponent field, which is the round-up
  across a binade;
- nearest is round-to-nearest-even on the kept mantissa;
- target subnormals sit on the fixed grid ``2^(emin - man)``; below one
  quantum the value rounds to 0 or the quantum;
- overflow saturates to the format's max (no inf/nan code points are
  reserved in the target format);
- ``check_inf`` keeps the reference's quirk: a result of exactly ``+max``
  (and only ``+max``) becomes ``+inf``;
- zeros keep their sign, non-finite inputs pass through.

All of it is done on the float32 bit pattern (as int64 here), so float
denormal handling never enters.  This is the path every CPU tensor takes and
the plain version of the kernel in ``ops/cuda/float_kernel.py``.

Formats: FP8 = e5m2, FP16 = e5m10, BF16 = e8m7, FP32 = e8m23.
"""

from __future__ import annotations

import dataclasses
import struct

import torch

from smart_quantization_tpu_torch.ops.rounding import random_bits

_U32 = 0xFFFFFFFF


def f32_bits(v: float) -> int:
    return struct.unpack("<I", struct.pack("<f", v))[0]


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """A binary float format with ``exp`` exponent and ``man`` mantissa bits."""

    exp: int
    man: int

    def __post_init__(self):
        if not (1 <= self.exp <= 8):
            raise ValueError(f"exp must be in [1, 8], got {self.exp}")
        if not (0 <= self.man <= 23):
            raise ValueError(f"man must be in [0, 23], got {self.man}")

    @property
    def bias(self) -> int:
        return 2 ** (self.exp - 1) - 1

    @property
    def emax(self) -> int:
        # no inf/nan reservation: the full exponent range encodes finite values
        return self.bias

    @property
    def emin(self) -> int:
        return 1 - self.bias

    @property
    def max_value(self) -> float:
        return float((2.0 - 2.0 ** (-self.man)) * 2.0**self.emax)

    @property
    def total_bits(self) -> int:
        return 1 + self.exp + self.man

    @property
    def quantum(self) -> float:
        """The subnormal grid step ``2^(emin - man)``."""
        return 2.0 ** (self.emin - self.man)

    @property
    def quantum_scale(self) -> tuple[float, float]:
        """``1 / quantum`` as two float32-exact powers of two."""
        shift = self.man - self.emin
        return 2.0 ** min(shift, 100), 2.0 ** max(shift - 100, 0)


FP8_FORMAT = FloatFormat(exp=5, man=2)
FP16_FORMAT = FloatFormat(exp=5, man=10)
BF16_FORMAT = FloatFormat(exp=8, man=7)
FP32_FORMAT = FloatFormat(exp=8, man=23)


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """The float32 bit patterns of ``x`` as int64 in ``[0, 2^32)``."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32


def from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_bits`."""
    signed = torch.where(bits >= 2**31, bits - 2**32, bits)
    return signed.to(torch.int32).view(torch.float32)


def float_quantize(
    x: torch.Tensor,
    fmt: FloatFormat,
    gen: torch.Generator | None = None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
    rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """Quantize ``x`` onto ``fmt``'s grid; returns float32 of ``x``'s shape.

    Stochastic mode draws one 32-bit word per element from ``gen``;
    ``rand`` (uint32 values as int64, or int32 bit patterns, ``x``'s shape)
    replaces the draw, so a test can hand both frameworks the same bits."""
    xf = x.to(torch.float32)
    bits = to_bits(xf)
    sign = bits & 0x80000000
    mag = bits & 0x7FFFFFFF

    # per-element count of fp32 lattice bits below the target grid: 23 - man
    # on the normal range, one more per binade below emin; fp32's own
    # subnormals share the e == -126 lattice
    e_x = (mag >> 23) - 127
    p_raw = (23 - fmt.man) + (fmt.emin - e_x.clamp_min(-126)).clamp_min(0)
    p = p_raw.clamp(0, 23)
    mask = (1 << p) - 1
    if stochastic:
        if rand is None:
            if gen is None:
                raise ValueError("stochastic float_quantize requires a torch.Generator")
            rand = random_bits(xf.shape, gen, xf.device)
        rand = rand.to(device=xf.device, dtype=torch.int64).reshape(xf.shape) & _U32
        r = rand & mask
    else:
        # round-to-nearest-even: add (half - 1 + kept lsb), then truncate
        half = torch.where(p > 0, 1 << (p - 1).clamp_min(0), 0)
        lsb = (mag >> p) & 1
        r = torch.where(p > 0, half - 1 + lsb, 0)
    rounded = (mag + r) & ~mask

    # below one quantum: 0 or the quantum; t = |x| / quantum by two exact
    # power-of-two products
    c1, c2 = fmt.quantum_scale
    t = xf.abs() * c1 * c2
    if stochastic:
        up = t > (rand >> 8).to(torch.float32) * 2.0**-24
    else:
        up = t > 0.5  # a tie rounds to even, i.e. 0
    below = torch.where(up, f32_bits(fmt.quantum), 0)
    out = torch.where(p_raw > 23, below, rounded)

    maxv = f32_bits(fmt.max_value)
    out = out.clamp_max(maxv)
    out = torch.where(mag == 0, 0, out)
    if check_inf:
        out = torch.where((out == maxv) & (sign == 0), 0x7F800000, out)
    out = out | sign
    out = torch.where(torch.isfinite(xf), out, bits)
    return from_bits(out)
