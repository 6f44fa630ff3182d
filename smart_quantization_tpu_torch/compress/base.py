"""Compressor protocol + compression-size telemetry types.

Counterpart of ``smart_quantization_tpu/compress/base.py``.  A compressor
is a frozen dataclass whose ``__call__(x, gen, ...)`` returns
``(x_hat, SizeStats)``; sizes are 0-d float32 tensors on the data's device,
so recording them never waits on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

TAGS = (
    "forward_autograd",
    "backward_autograd",
    "optimizer_weight",
    "optimizer_grad",
    "optimizer_momentum",
    "loss",
    "forward_hook",
)


class SizeStats(NamedTuple):
    """Per-call compressed-size accounting in bits (0-d float32 tensors).

    When the SmaQ compressor is built with ``measure_sizes=False`` the
    kernel skips its outlier count and ``new_bits`` is the static
    all-main-bucket floor, not a measurement."""

    orig_bits: torch.Tensor
    new_bits: torch.Tensor

    @staticmethod
    def of(n: int, orig_bitwidth: float, new_bitwidth: float, device,
           overhead: float = 0.0) -> "SizeStats":
        return SizeStats(
            orig_bits=torch.full((), float(n * orig_bitwidth), device=device),
            new_bits=torch.full((), float(n * new_bitwidth + overhead), device=device),
        )


class SizeTotals:
    """Per-tag running ``[orig_bits, new_bits]`` sums as (2,) tensors on the
    device; one per training step, owned by the trainer."""

    def __init__(self):
        self.totals: dict[str, torch.Tensor] = {}

    def add(self, tag: str, stats: SizeStats) -> None:
        pair = torch.stack([stats.orig_bits, stats.new_bits])
        prev = self.totals.get(tag)
        self.totals[tag] = pair if prev is None else prev + pair


@dataclasses.dataclass(frozen=True)
class CompressorBase:
    """Base for all encoders.  ``precision=16`` selects the fp16-training
    mode's adjustments (the SmaQ std clamp range)."""

    precision: int = 32

    name: str = dataclasses.field(default="base", init=False, repr=False)
    # the derivative the JAX package's autodiff gives through this encoder
    # on a one-element tensor (``--compress_loss``): 1 where the encoder
    # passes it through or its value follows x through its statistics
    # (SmaQ below min_size, S2FP8, FP32); 0 for the float formats
    loss_derivative = 1.0

    def __call__(
        self,
        x: torch.Tensor,
        gen: torch.Generator | None,
        *,
        all_positive: bool = False,
        gamma: torch.Tensor | None = None,
        beta: torch.Tensor | None = None,
        mean: torch.Tensor | None = None,
        std: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, SizeStats]:
        raise NotImplementedError

    def rowwise(
        self,
        rows: torch.Tensor,
        gen: torch.Generator | None,
        *,
        all_positive: bool = False,
        mean: torch.Tensor | None = None,
        std: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, SizeStats]:
        """Each row of the 2-D ``rows`` as a tensor of its own (the JAX
        package ``vmap``s the call over rows), with the sizes summed over
        the rows; ``mean``/``std`` hold one value per row.  An elementwise
        encoder's rows are its call on the whole tensor."""
        return self(rows, gen, all_positive=all_positive)
