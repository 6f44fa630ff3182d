"""SmaQ z-score quantize->dequantize, plain PyTorch.

The counterpart of ``smart_quantization_tpu/ops/smaq.py`` (its jnp path),
with the same math:

1. tensors with fewer than ``min_size`` elements pass through untouched;
2. per-tensor mean/std: full (unbiased, ddof=1, two-pass), sampled (one
   stratified strided slice at a drawn offset, biased std; from a step key
   the offset stays on the device and the slice is a gather), or the
   Range-BN estimator ``(max - min) / sqrt(2 ln N)``;
3. ``z = (x - mean) / clamp(std)``; elements with ``|z| > t_main`` are
   outliers, shifted toward zero by ``t_main`` and scaled by
   ``range_outlier``; the rest are scaled by ``range_main``;
4. stochastic rounding (or truncation) to the integer grid;
5. exact inversion back through scale, shift, std and mean;
6. optional ``all_positive`` clamp at zero (Adam's second moment);
7. data-dependent size: ``outliers * b_out + rest * b_main`` bits.

With ``rows=True`` a 2-D tensor is quantized row by row, each row with its
own stats (and its own ``min_size`` pass-through), in one vectorized pass:
the row-wise momentum codec, which the JAX package runs by ``vmap`` over
rows of its jnp path (``optim/compressed.py:250-328``).

With BatchNorm's ``gamma``/``beta`` (``--use_batch_norm``) the quantizer
works on the unfolded ``(x - beta) / gamma`` and folds the result back;
the stats still come from the raw tensor (the reference quirk).  The fold
runs over dim 1 (NCHW; the JAX package's NHWC uses the last axis), a 0-d
pair over the whole tensor, and a zero gamma is taken as 1, as the TPU
kernel does (the JAX jnp path divides by it and returns NaN).

This is the path every CPU tensor takes.  CUDA tensors go to the kernels in
``ops/cuda/smaq_kernel.py``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from smart_quantization_tpu_torch.ops.keys import DeviceKey
from smart_quantization_tpu_torch.ops.rounding import randint, round_to_grid


@dataclasses.dataclass(frozen=True)
class SmaQParams:
    """Static configuration of the SmaQ quantizer."""

    num_bits_main: int = 6
    num_bits_outlier: int = 8
    main_std_dev_threshold: float = 1.0
    outlier_std_dev_threshold: float = 2.5
    min_size: int = 8
    num_samples: int = 16
    use_sample_stats: bool = False
    use_range_std_dev: bool = False
    stochastic_rounding: bool = True
    # std clamp range: fp16 runs clamp to (1e-4, 1e4), fp32 to (1e-38, 1e38)
    std_clamp_lo: float = 1e-38
    std_clamp_hi: float = 1e38

    @property
    def range_main(self) -> float:
        return ((2 ** (self.num_bits_main - 2)) - 1) / self.main_std_dev_threshold

    @property
    def range_outlier(self) -> float:
        return ((2 ** (self.num_bits_outlier - 2)) - 1) / (
            self.outlier_std_dev_threshold - self.main_std_dev_threshold
        )


def _range_std(flat: torch.Tensor) -> torch.Tensor:
    """Range-BN std estimator: (max - min) / sqrt(2 ln N)."""
    rng = flat.max() - flat.min()
    return rng / math.sqrt(2.0 * math.log(float(flat.numel())))


def stratum_offset(gen, m: int, device) -> torch.Tensor | int:
    """The offset ``j`` in ``[0, m)`` at which sampled stats take one
    element of each stratum of ``m``, drawn from ``gen``: a 1-element
    tensor on ``device`` from a step key (no host read), an int from a host
    generator."""
    if gen is None:
        raise ValueError("sampled stats require a torch.Generator")
    if isinstance(gen, DeviceKey):
        return randint(m, (1,), gen, device)
    return int(torch.randint(0, m, (), generator=gen))


def sample_moments(sample: torch.Tensor, params: SmaQParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Sampled stats' (mean, std) of the contiguous float32 sample (a
    strided one sums in another order): the biased std, or the range
    std."""
    mean = sample.mean()
    if params.use_range_std_dev:
        return mean, _range_std(sample)
    return mean, sample.std(correction=0)


def compute_stats(
    x: torch.Tensor, params: SmaQParams, gen: torch.Generator | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor (mean, std) as 0-d float32 tensors on ``x``'s device.

    Full stats use the unbiased std; sampled stats take one element per
    equal stratum at a shared offset drawn from ``gen`` and use the biased
    std."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    if params.use_sample_stats and n > params.num_samples:
        k = params.num_samples
        m = n // k
        j = stratum_offset(gen, m, flat.device)
        if isinstance(j, torch.Tensor):
            sample = flat[: k * m].view(k, m).index_select(1, j).reshape(k)
        else:
            sample = flat[: k * m].view(k, m)[:, j].contiguous()
        mean, std = sample_moments(sample, params)
    else:
        mean = flat.mean()
        if params.use_range_std_dev:
            std = _range_std(flat)
        else:
            std = flat.std(correction=1 if n > 1 else 0)
    return mean, std


def row_stats(
    rows: torch.Tensor, params: SmaQParams, gen: torch.Generator | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``compute_stats`` of each row of a 2-D float32 tensor, as (R, 1)
    tensors; sampled stats draw one offset per row from ``gen``."""
    n_rows, n = rows.shape
    if params.use_sample_stats and n > params.num_samples:
        if gen is None:
            raise ValueError("sampled stats require a torch.Generator")
        k = params.num_samples
        m = n // k
        j = randint(m, (n_rows, 1, 1), gen, rows.device).expand(n_rows, k, 1)
        sample = rows[:, : k * m].reshape(n_rows, k, m).gather(2, j).squeeze(2)
        n, rows = k, sample
        correction = 0
    else:
        correction = 1 if n > 1 else 0
    mean = rows.mean(1, keepdim=True)
    if params.use_range_std_dev:
        rng = rows.amax(1, keepdim=True) - rows.amin(1, keepdim=True)
        return mean, rng / math.sqrt(2.0 * math.log(float(n)))
    return mean, rows.std(1, correction=correction, keepdim=True)


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``v`` (0-d, or one value per channel of dim 1) broadcastable to ``x``."""
    v = v.to(torch.float32)
    if v.dim() == 0:
        return v
    if v.dim() != 1 or x.dim() < 2 or x.shape[1] != v.numel():
        raise ValueError(
            f"BatchNorm parameters of shape {tuple(v.shape)} do not fold over "
            f"dim 1 of {tuple(x.shape)}"
        )
    return v.view(1, -1, *([1] * (x.dim() - 2)))


def smaq_quantize_dequantize(
    x: torch.Tensor,
    gen: torch.Generator | None,
    params: SmaQParams = SmaQParams(),
    *,
    all_positive: bool = False,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
    gamma: torch.Tensor | None = None,
    beta: torch.Tensor | None = None,
    rows: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fake-quantize ``x`` with SmaQ; returns ``(x_hat, new_size_bits)``.

    ``new_size_bits`` is a 0-d float32 tensor on ``x``'s device (the
    original size is the static ``x.numel() * 32``).  Given ``mean``/``std``
    skip the stats pass; ``gamma``/``beta`` fold BatchNorm's affine in.
    ``rows``: ``x`` is 2-D and each row is quantized as a tensor of its
    own (given stats then hold one value per row); the size is the rows'
    total."""
    n = x.numel()
    if (x.shape[1] if rows else n) < params.min_size:
        return x, torch.full((), float(n * 32), device=x.device)

    xf = x.float()
    if mean is None or std is None:
        mean, std = row_stats(xf, params, gen) if rows else compute_stats(xf, params, gen)
    elif rows:
        mean, std = mean.reshape(-1, 1), std.reshape(-1, 1)

    use_bn = gamma is not None and beta is not None
    if use_bn and rows:
        raise ValueError("the row-wise codec folds no BatchNorm parameters")
    if use_bn:
        gamma, beta = _per_channel(gamma, xf), _per_channel(beta, xf)
        gamma = torch.where(gamma == 0.0, torch.ones_like(gamma), gamma)
        xf = (xf - beta) / gamma

    std = torch.where(std == 0.0, torch.ones_like(std), std)
    std = std.clamp(params.std_clamp_lo, params.std_clamp_hi)

    t = params.main_std_dev_threshold
    z = (xf - mean) / std
    is_hi = z > t
    is_lo = z < -t
    is_outlier = is_hi | is_lo

    shift = is_hi.float() * -t + is_lo.float() * t
    scale = torch.where(is_outlier, params.range_outlier, params.range_main)

    q = round_to_grid((z + shift) * scale, gen, params.stochastic_rounding)
    x_hat = (q / scale - shift) * std + mean
    if use_bn:
        x_hat = x_hat * gamma + beta
    if all_positive:
        x_hat = x_hat.clamp_min(0.0)

    n_outliers = is_outlier.sum().float()
    new_size = (
        n_outliers * params.num_bits_outlier
        + (float(n) - n_outliers) * params.num_bits_main
    )
    return x_hat.to(x.dtype), new_size
