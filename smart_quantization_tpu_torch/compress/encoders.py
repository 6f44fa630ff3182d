"""Encoders ported so far: SmaQ and the FP32 passthrough.

Counterparts of ``smart_quantization_tpu/compress/encoders.py::SmaQ`` and
``::FP32``.  FP8, S2FP8, FP16 and BF16 are still to be ported (ROADMAP
Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses

import torch

from smart_quantization_tpu_torch.compress.base import CompressorBase, SizeStats
from smart_quantization_tpu_torch.ops.cuda.smaq_kernel import smaq_fused_or_reference
from smart_quantization_tpu_torch.ops.smaq import SmaQParams


@dataclasses.dataclass(frozen=True)
class SmaQ(CompressorBase):
    params: SmaQParams = SmaQParams()
    use_batch_norm: bool = False
    bn_scalar_params: bool = False
    # False skips the kernel's outlier count (sizes are only accounted under
    # --measure_compression_ratio); SizeStats are then the all-main floor
    measure_sizes: bool = True

    name = "smart"

    def __post_init__(self):
        if self.use_batch_norm or self.bn_scalar_params:
            raise NotImplementedError(
                "BN-folded SmaQ (--use_batch_norm / --bn_scalar_params) is not "
                "yet ported (ROADMAP Queue 1 item 10)"
            )

    def __call__(self, x, gen, *, all_positive=False, mean=None, std=None):
        x_hat, new_bits = smaq_fused_or_reference(
            x, gen, self.params, all_positive=all_positive,
            compute_size=self.measure_sizes, mean=mean, std=std,
        )
        orig = torch.full((), float(x.numel() * 32), device=x.device)
        return x_hat, SizeStats(orig, new_bits)


@dataclasses.dataclass(frozen=True)
class FP32(CompressorBase):
    name = "fp32"

    def __call__(self, x, gen, *, all_positive=False, mean=None, std=None):
        return x, SizeStats.of(x.numel(), 32, 32, x.device)
