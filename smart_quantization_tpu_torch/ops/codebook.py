"""Unified-codebook SmaQ storage: real compressed state in one byte an element.

The counterpart of ``smart_quantization_tpu/ops/codebook.py`` (single-chip
layout; the shard-local form waits for the distributed paths).  Once
outliers are clamped, SmaQ's two-bucket alphabet,

    main bucket:     2^(b_main - 1)          codes  (|z| <= t_main)
    outlier buckets: 2 * 2^(b_outlier - 2)   codes  (t_main < |z|)

has ``2^(b_main-1) + 2^(b_outlier-1)`` values, at most 256 for every bit
width the reference sweeps (6/8 -> 160), so every element is one uint8
code and the decode is elementwise arithmetic.  The spare codes extend the
outlier grid: each side holds ``H = (256 - 2^(bm-1)) // 2 - 1`` integer
steps, so the clamp bites only at ``|z| > t_main + H / range_outlier``
(3.64 sigma at 6/8 bits; ``storage_z_limit``).

The arithmetic follows the JAX package's order, which is the plain fake
path's (``ops/smaq.py``): the two-pass ``(x - mean) / std``, and a decode
of ``q / range + t`` by division, then ``z * std + mean``.  On the CPU,
``smaq_decode(smaq_encode(x, gen))`` is therefore bitwise the fake path's
output for the same generator state wherever ``|z| <= storage_z_limit``.
On a CUDA tensor the stats come from the ``smaq_stats`` kernel (the
ported one-pass reduction) and the code pass is tensor ops; the card's
fake path multiplies ``x - mean`` by ``a = 1/std`` instead of dividing, so
there the two agree by the flip rule, not bitwise.

A ``SmaQCodes`` really occupies ``8 n + 64`` bits (codes and two float32
stats), whatever the outlier fraction: exactly 4x less than float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smart_quantization_tpu_torch.ops.cuda.smaq_kernel import read_consts, smaq_stats
from smart_quantization_tpu_torch.ops.rounding import round_to_grid
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, compute_stats


class SmaQCodes(NamedTuple):
    """A compressed tensor: one uint8 code per element (the original shape)
    and the float32 stats it was encoded with (0-d; std already guarded
    and clamped)."""

    codes: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor


def codebook_size(params: SmaQParams) -> int:
    """The nominal alphabet's size; at most 256 for uint8 storage."""
    return 2 ** (params.num_bits_main - 1) + 2 ** (params.num_bits_outlier - 1)


def supports_codebook(params: SmaQParams) -> bool:
    return codebook_size(params) <= 256


def outlier_side_steps(params: SmaQParams) -> int:
    """The largest |q| stored on each outlier side: the nominal
    ``2^(bo-2) - 1`` grid extended into the spare uint8 codes."""
    return (256 - 2 ** (params.num_bits_main - 1)) // 2 - 1


def storage_z_limit(params: SmaQParams) -> float:
    """The |z| beyond which the codebook clamps (the fake path never does)."""
    return params.main_std_dev_threshold + outlier_side_steps(params) / params.range_outlier


def _encode_stats(flat: torch.Tensor, params: SmaQParams, gen) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) after the zero-std guard and the clamp: the stats
    kernel's on a CUDA tensor with full stats, else ``compute_stats``."""
    if flat.is_cuda and not params.use_sample_stats:
        return read_consts(smaq_stats(flat.contiguous(), params))
    mean, std = compute_stats(flat, params, gen)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    return mean, std.clamp(params.std_clamp_lo, params.std_clamp_hi)


def smaq_encode(x: torch.Tensor, gen: torch.Generator | None,
                params: SmaQParams = SmaQParams()) -> SmaQCodes:
    """Quantize ``x`` into uint8 codes.  Draws from ``gen`` as the fake
    path does (the sampled stats' offset, then the rounding noise)."""
    if not supports_codebook(params):
        raise ValueError(
            f"codebook needs 2^(bm-1)+2^(bo-1) <= 256, got {codebook_size(params)} for "
            f"{params.num_bits_main}/{params.num_bits_outlier} bits"
        )
    if x.numel() < params.min_size:
        # the fake path passes such tensors through untouched: keep them float32
        raise ValueError(
            f"tensor of {x.numel()} elements is below min_size={params.min_size}: the "
            "fake-quant path passes it through, so store it uncompressed instead of encoding"
        )
    xf = x.float()
    mean, std = _encode_stats(xf.reshape(-1), params, gen)

    t = params.main_std_dev_threshold
    z = (xf - mean) / std
    hi, lo = z > t, z < -t
    shift = hi.float() * -t + lo.float() * t
    scale = torch.where(hi | lo, params.range_outlier, params.range_main)
    # the fake path's grid, unclamped; the only clamp is the code's range
    q = round_to_grid((z + shift) * scale, gen, params.stochastic_rounding)

    main_max = 2 ** (params.num_bits_main - 2) - 1
    base = 2 ** (params.num_bits_main - 1)
    h = outlier_side_steps(params)
    qi = q.clamp(-2.0e9, 2.0e9).to(torch.int32)  # inf inputs before the cast
    code_main = qi.clamp(-main_max - 1, main_max) + (main_max + 1)
    qo = qi.clamp(-h, h)
    codes = torch.where(hi, base + qo, torch.where(lo, base + (h + 1) - qo, code_main))
    return SmaQCodes(codes.to(torch.uint8), mean, std)


def smaq_decode(packed: SmaQCodes, params: SmaQParams = SmaQParams(), *,
                all_positive: bool = False, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The values of ``packed``: the fake path's dequantization
    (``q / scale - shift``, then ``* std + mean``) of the stored codes."""
    t = params.main_std_dev_threshold
    main_max = 2 ** (params.num_bits_main - 2) - 1
    base = 2 ** (params.num_bits_main - 1)
    h = outlier_side_steps(params)

    c = packed.codes.to(torch.int32)
    is_hi = (c >= base) & (c <= base + h)
    is_lo = c > base + h
    # float32 grid scales, as the fake path's torch.where gives them
    r_main = torch.tensor(params.range_main, dtype=torch.float32)
    r_out = torch.tensor(params.range_outlier, dtype=torch.float32)
    z_main = (c - (main_max + 1)).float() / r_main
    q_hi = (c - base).float()
    q_lo = -(c - (base + h + 1)).float()
    z = torch.where(is_hi, q_hi / r_out + t, torch.where(is_lo, q_lo / r_out - t, z_main))
    y = z * packed.std + packed.mean
    if all_positive:
        y = y.clamp_min(0.0)
    return y.to(dtype)


def real_bits(packed: SmaQCodes) -> int:
    """The storage a ``SmaQCodes`` takes, in bits."""
    return packed.codes.numel() * 8 + 64
