"""S2FP8 (shifted-squeezed FP8) fake-quantization, plain PyTorch.

The counterpart of ``smart_quantization_tpu/ops/s2fp8.py`` (22-53): the
per-tensor mean ``mu`` and max ``m`` of ``log2|x|`` (zeros count as 0 in
both), ``alpha = 15 / (m - mu)`` (15 where ``m == mu``, the JAX package's
guard of a constant tensor), ``beta = -alpha * mu``; the magnitudes are
squeezed to ``|x|^alpha * 2^beta``, rounded onto FP8 e5m2, unsqueezed and
given their signs back (zeros stay zeros).

``mu`` is summed in float64 and rounded once to float32, as the stats
kernel folds it (``log2_stats``).  The JAX package takes a float32 mean,
which on a constant whose log2 is inexact (-0.375) can miss the max by an
ulp: its guard then misses, ``alpha`` is huge and the output NaN.  Here
such a tensor takes the guard (``alpha = 1``), on the CPU as on the card.

This is the path every CPU tensor takes.  CUDA tensors go to the kernels in
``ops/cuda/s2fp8_kernel.py``, whose plain version computes the squeeze as
``exp2(alpha * log2|x| + beta)`` like the TPU kernel.
"""

from __future__ import annotations

import torch

from smart_quantization_tpu_torch.ops.float_format import FP8_FORMAT, float_quantize

# two float32 scalars (alpha, beta) per tensor
OVERHEAD_BITS = 64


def squeeze_coefs(mu: torch.Tensor, m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha, beta) from the mean and max of ``log2|x|``."""
    denom = m - mu
    fifteen = torch.full_like(denom, 15.0)
    # a true division: `15.0 / tensor` would be 15 * reciprocal, one more rounding
    alpha = fifteen / torch.where(denom == 0.0, fifteen, denom)
    return alpha, -alpha * mu


def log2_stats(lg: torch.Tensor, rows: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, max) of ``lg = log2|x|`` (of each row of a 2-D ``lg`` with
    ``rows``): the sum in float64 over the count, rounded once to float32."""
    if rows:
        return (lg.double().sum(1, keepdim=True) / lg.shape[1]).float(), lg.amax(1, keepdim=True)
    return (lg.double().sum() / lg.numel()).float(), lg.max()


def s2fp8_quantize_dequantize(
    x: torch.Tensor,
    gen: torch.Generator | None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
    rand: torch.Tensor | None = None,
    rows: bool = False,
    stats: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """S2FP8 of ``x``; ``rand`` is passed on to ``float_quantize``.
    ``rows``: ``x`` is 2-D and each row takes its own (alpha, beta).
    ``stats``: the mean and max of ``log2|x|`` given (as reduced over
    ranks), in place of ``x``'s own."""
    xf = x.to(torch.float32)
    x_abs = xf.abs()
    if stats is None:
        lg = torch.where(x_abs == 0.0, x_abs, torch.log2(x_abs))
        stats = log2_stats(lg, rows)
    alpha, beta = squeeze_coefs(*stats)
    beta_pow2 = torch.exp2(beta)
    squeezed = torch.pow(x_abs, alpha) * beta_pow2
    t = float_quantize(
        squeezed, FP8_FORMAT, gen, stochastic=stochastic, check_inf=check_inf, rand=rand
    )
    out = torch.pow(t / beta_pow2, 1.0 / alpha) * torch.sign(xf)
    return out.to(x.dtype)
