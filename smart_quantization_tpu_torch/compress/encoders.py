"""The six encoders: SmaQ, FP8, S2FP8, FP16, BF16 and the FP32 passthrough.

Counterparts of ``smart_quantization_tpu/compress/encoders.py``.  Each runs
its hand-written kernel on a CUDA tensor (``ops/cuda/``) and its plain
version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from smart_quantization_tpu_torch.compress.base import CompressorBase, SizeStats
from smart_quantization_tpu_torch.ops.cuda.float_kernel import float_quantize_fused_or_reference
from smart_quantization_tpu_torch.ops.cuda.s2fp8_kernel import s2fp8_fused_or_reference
from smart_quantization_tpu_torch.ops.cuda.smaq_kernel import smaq_fused_or_reference
from smart_quantization_tpu_torch.ops.float_format import (
    BF16_FORMAT,
    FP8_FORMAT,
    FP16_FORMAT,
    FloatFormat,
)
from smart_quantization_tpu_torch.ops.s2fp8 import OVERHEAD_BITS, s2fp8_quantize_dequantize
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, smaq_quantize_dequantize


@dataclasses.dataclass(frozen=True)
class SmaQ(CompressorBase):
    params: SmaQParams = SmaQParams()
    # fold BatchNorm's (gamma, beta) in where a tap passes them; with
    # bn_scalar_params the per-channel pair is averaged to one 0-d pair
    use_batch_norm: bool = False
    bn_scalar_params: bool = False
    # False skips the kernel's outlier count (sizes are only accounted under
    # --measure_compression_ratio); SizeStats are then the all-main floor
    measure_sizes: bool = True

    name = "smart"

    def __call__(self, x, gen, *, all_positive=False, gamma=None, beta=None,
                 mean=None, std=None):
        if not self.use_batch_norm:
            gamma = beta = None
        elif gamma is not None and self.bn_scalar_params:
            gamma, beta = gamma.mean(), beta.mean()
        x_hat, new_bits = smaq_fused_or_reference(
            x, gen, self.params, all_positive=all_positive,
            compute_size=self.measure_sizes, mean=mean, std=std, gamma=gamma, beta=beta,
        )
        orig = torch.full((), float(x.numel() * 32), device=x.device)
        return x_hat, SizeStats(orig, new_bits)

    def rowwise(self, rows, gen, *, all_positive=False, mean=None, std=None):
        # the plain path on every device, as the JAX package's vmap takes it
        y, new_bits = smaq_quantize_dequantize(
            rows, gen, self.params, all_positive=all_positive, mean=mean, std=std, rows=True)
        return y, SizeStats(torch.full((), float(rows.numel() * 32), device=rows.device), new_bits)


@dataclasses.dataclass(frozen=True)
class FloatEncoder(CompressorBase):
    """Shared fixed-float-format fake quantizer (FP8/FP16/BF16)."""

    fmt: FloatFormat = FP8_FORMAT
    check_inf: bool = True
    stochastic: bool = True

    name = "float"
    # JAX differentiates the rounding's bit arithmetic as 0, so a compressed
    # loss gives every gradient 0 (a JAX-side fault the port reproduces)
    loss_derivative = 0.0

    def __call__(self, x, gen, *, all_positive=False, gamma=None, beta=None,
                 mean=None, std=None):
        y = float_quantize_fused_or_reference(
            x, self.fmt, gen, stochastic=self.stochastic, check_inf=self.check_inf
        )
        if self.precision == 16:
            # the fp16 training mode round-trips through the fp16 grid
            y = float_quantize_fused_or_reference(
                y, FP16_FORMAT, None, stochastic=False, check_inf=False
            )
        return y.to(x.dtype), SizeStats.of(x.numel(), 32, self.fmt.total_bits, x.device)


@dataclasses.dataclass(frozen=True)
class FP8(FloatEncoder):
    fmt: FloatFormat = FP8_FORMAT
    name = "fp8"


@dataclasses.dataclass(frozen=True)
class FP16(FloatEncoder):
    fmt: FloatFormat = FP16_FORMAT
    name = "fp16"


@dataclasses.dataclass(frozen=True)
class BF16(FloatEncoder):
    fmt: FloatFormat = BF16_FORMAT
    name = "bf16"


@dataclasses.dataclass(frozen=True)
class S2FP8(CompressorBase):
    check_inf: bool = True
    stochastic: bool = True

    name = "s2fp8"

    def __call__(self, x, gen, *, all_positive=False, gamma=None, beta=None,
                 mean=None, std=None, log2_stats=None):
        # log2_stats: the mean and max of log2|x| given (reduced over ranks)
        y = s2fp8_fused_or_reference(
            x, gen, stochastic=self.stochastic, check_inf=self.check_inf, stats=log2_stats
        )
        stats = SizeStats.of(x.numel(), 32, 8, x.device, overhead=OVERHEAD_BITS)
        return y, stats

    def rowwise(self, rows, gen, *, all_positive=False, mean=None, std=None):
        y = s2fp8_quantize_dequantize(
            rows, gen, stochastic=self.stochastic, check_inf=self.check_inf, rows=True)
        stats = SizeStats.of(rows.numel(), 32, 8, rows.device,
                             overhead=OVERHEAD_BITS * rows.shape[0])
        return y, stats


@dataclasses.dataclass(frozen=True)
class FP32(CompressorBase):
    name = "fp32"

    def __call__(self, x, gen, *, all_positive=False, gamma=None, beta=None,
                 mean=None, std=None):
        return x, SizeStats.of(x.numel(), 32, 32, x.device)
