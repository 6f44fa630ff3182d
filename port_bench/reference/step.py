"""What one reference training step needs besides the weights: its draw
counter, the quantizer of its compression taps, and the precision of its
convolutions and matrix products.

A tap is an identity that quantizes the feature map on the way forward
and the gradient map on the way back (straight-through), each with a
block of draw numbers reserved when the forward reaches it.

``precision`` is the configuration's (``float32`` or ``bfloat16``) or one
below it, for the control: ``tf32`` runs float32 products on the tensor
cores' TF32 path, ``fp8`` rounds every operand of a convolution or a
matrix product to float8 e4m3 on the way forward.
"""

from __future__ import annotations

import torch

from port_bench.reference import philox
from port_bench.reference.keys import DRAWS, Counter
from port_bench.reference.smaq import SmaQ, quantize


class _Tap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, step, fwd, bwd):
        ctx.step, ctx.bwd = step, bwd
        y = quantize(x, step.noise(fwd), step.smaq)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        step = ctx.step
        return quantize(g.contiguous(), step.noise(ctx.bwd), step.smaq), None, None, None


class Step:
    def __init__(self, key: int, smaq: SmaQ | None, device, precision: str,
                 dropout_key: int | None = None):
        self.counter = Counter(key)
        # dropout draws from the step's counter, or from a key of its own
        # (a data-parallel rank's)
        self.drops = self.counter if dropout_key is None else Counter(dropout_key)
        self.smaq = smaq
        self.device = device
        self.fp8 = precision == "fp8"

    def noise(self, call: int):
        key, device = self.counter.key, self.device
        return lambda n: philox.uniform(n, key, call, device)

    def tap(self, x: torch.Tensor) -> torch.Tensor:
        if self.smaq is None:
            return x
        fwd = self.counter.reserve(DRAWS)
        bwd = self.counter.reserve(DRAWS)
        return _Tap.apply(x, self, fwd, bwd)

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep_prob = 1.0 - rate
        u = philox.uniform(x.numel(), self.drops.key, self.drops.take(), self.device)
        return torch.where(u.view(x.shape) < keep_prob, x / keep_prob, 0.0)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a product takes it: rounded to float8 e4m3 under the
        ``fp8`` control (straight-through for the gradient)."""
        if not self.fp8:
            return x
        return x + (x.to(torch.float8_e4m3fn).to(x.dtype) - x).detach()
