"""Fused SmaQ on the card: the wrappers of ``csrc/smaq.cu``, their plain
PyTorch version, and the dispatcher.

The port of ``smart_quantization_tpu/ops/pallas/smaq_kernel.py::smaq_fused``
(and of the one-pass statistics reduction its wrapper runs first).  The
source note in ``csrc/smaq.cu`` gives the design.  Here:

- ``smaq_stats`` and ``smaq_quantize`` launch the two kernels on PyTorch's
  current stream and count their launches in ``LAUNCHES``;
- ``smaq_fused`` is the kernel path of one SmaQ call on a CUDA tensor;
- ``smaq_fused_reference`` is the kernel's plain version: the same
  arithmetic in PyTorch ops (pivot-shifted one-pass stats, folded
  reciprocals), for any device;
- ``smaq_fused_or_reference`` sends a CUDA tensor to the kernels and a CPU
  tensor to ``ops/smaq.py``.  There is no size threshold: on the card every
  tensor of ``min_size`` or more elements goes to the kernels.

Stochastic rounding draws one 64-bit seed per call from the caller's host
``torch.Generator``; the kernel's Philox stream will never give the bits of
any other generator, so stochastic outputs compare by statistics only.
"""

from __future__ import annotations

import math

import torch

from smart_quantization_tpu_torch.ops.cuda import build
from smart_quantization_tpu_torch.ops.rounding import draw_seed, uniform
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, smaq_quantize_dequantize

# Launches of each kernel since the last reset (one per launch, nowhere else).
LAUNCHES = {"smaq_stats": 0, "smaq_quantize": 0}

_THREADS = 256
# Partials per stats launch: every quantize block folds all of them, so they
# are kept few (264 = 2 per SM of an H100).
_MAX_STATS_BLOCKS = 264
# 8 blocks of 256 threads fill an SM; larger tensors loop inside the block.
_MAX_QUANT_BLOCKS = 1056
# The TPU kernel's in-kernel sample spans its first block of 512 x 1024.
_SAMPLE_SPAN = 512 * 1024
_STATS_GIVEN, _STATS_FULL, _STATS_RANGE = 0, 1, 2


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _blocks(n: int, per_block: int, cap: int) -> int:
    return max(1, min(cap, -(-n // per_block)))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def _check_input(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"the SmaQ kernels take CUDA tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the SmaQ kernels take float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the SmaQ kernels take contiguous tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {x.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )


def smaq_stats(xf: torch.Tensor) -> torch.Tensor:
    """Launch the stats kernel; returns the float64 partials
    ``[s1, s2, min, max] * blocks + [pivot]``."""
    _check_input(xf)
    n = xf.numel()
    blocks = _blocks(n, _THREADS * 16, _MAX_STATS_BLOCKS)
    partials = torch.empty(4 * blocks + 1, dtype=torch.float64, device=xf.device)
    rc = build.library().smaq_stats(
        xf.data_ptr(), n, partials.data_ptr(), blocks, _THREADS,
        torch.cuda.current_stream(xf.device).cuda_stream,
    )
    _raise_on(rc, "smaq_stats")
    LAUNCHES["smaq_stats"] += 1
    return partials


def smaq_quantize(
    xf: torch.Tensor,
    params: SmaQParams,
    *,
    seed: int,
    stats: torch.Tensor | None = None,
    partials: torch.Tensor | None = None,
    all_positive: bool = False,
    compute_size: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantize kernel against ``stats`` (a float32 (mean, std)
    pair on the device) or the stats kernel's ``partials``; returns the
    flat output and the size in bits as a 0-d float32 device tensor."""
    _check_input(xf)
    if (stats is None) == (partials is None):
        raise ValueError("pass exactly one of stats= and partials=")
    n = xf.numel()
    if stats is not None:
        if stats.dtype != torch.float32 or stats.numel() != 2 or stats.device != xf.device:
            raise ValueError("stats must be a float32 (mean, std) pair on the tensor's device")
        stats = stats.contiguous()
        mode, num_partials = _STATS_GIVEN, 0
    else:
        mode = _STATS_RANGE if params.use_range_std_dev else _STATS_FULL
        num_partials = (partials.numel() - 1) // 4
    y = torch.empty_like(xf)
    size = torch.empty((), dtype=torch.float32, device=xf.device)
    counter = torch.zeros(2, dtype=torch.int64, device=xf.device) if compute_size else None
    blocks = _blocks(n, _THREADS * 4, _MAX_QUANT_BLOCKS)
    rc = build.library().smaq_quantize(
        xf.data_ptr(), y.data_ptr(), n,
        None if stats is None else stats.data_ptr(),
        None if partials is None else partials.data_ptr(),
        num_partials, mode, seed, int(params.stochastic_rounding),
        int(all_positive), int(compute_size),
        params.main_std_dev_threshold, params.range_main, params.range_outlier,
        1.0 / params.range_main, 1.0 / params.range_outlier,
        params.std_clamp_lo, params.std_clamp_hi,
        params.num_bits_main, params.num_bits_outlier,
        None if counter is None else counter.data_ptr(), size.data_ptr(),
        blocks, _THREADS, torch.cuda.current_stream(xf.device).cuda_stream,
    )
    _raise_on(rc, "smaq_quantize")
    LAUNCHES["smaq_quantize"] += 1
    return y, size


def sample_stats(flat: torch.Tensor, params: SmaQParams) -> torch.Tensor:
    """``use_sample_stats``: mean and biased std (or the range std) over the
    TPU kernel's deterministic positions ``flat[:n_block:stride]``
    (smaq_kernel.py:101-114); a float32 (mean, std) pair."""
    n = flat.numel()
    n_block = min(n, _SAMPLE_SPAN)
    stride = max(n_block // params.num_samples, 1)
    s = flat[:n_block:stride].float()
    k = s.numel()
    m1 = s.sum() / k
    if params.use_range_std_dev:
        std = (s.max() - s.min()) / math.sqrt(2.0 * math.log(k))
    else:
        std = ((s * s).sum() / k - m1 * m1).clamp_min(0.0).sqrt()
    return torch.stack([m1, std])


def pivot_stats_reference(
    flat: torch.Tensor, params: SmaQParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """The stats kernel's plain version, folded as the quantize kernel
    folds it: mean and ddof=1 std from the sums of ``d = x - pivot`` in
    float64 (pivot = mean of the first 256 elements), or the range std."""
    n = flat.numel()
    pivot = flat[: min(n, 256)].mean()
    d = (flat - pivot).double()
    s1, s2 = d.sum(), (d * d).sum()
    mean = (pivot.double() + s1 / n).float()
    if params.use_range_std_dev:
        std = (flat.max() - flat.min()) / math.sqrt(2.0 * math.log(n))
    else:
        var = ((s2 - s1 * (s1 / n)) / max(n - 1.0, 1.0)).clamp_min(0.0)
        std = var.sqrt().float()
    return mean, std


def fold_partials(
    partials: torch.Tensor, n: int, params: SmaQParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and std from the stats kernel's partials, in PyTorch ops (the
    fold the quantize kernel does first), for reading the stats kernel's
    result on its own."""
    p = partials[:-1].view(-1, 4)
    s1, s2 = p[:, 0].sum(), p[:, 1].sum()
    mean = (partials[-1] + s1 / n).float()
    if params.use_range_std_dev:
        std = ((p[:, 3].max() - p[:, 2].min()) / math.sqrt(2.0 * math.log(n))).float()
    else:
        var = ((s2 - s1 * (s1 / n)) / max(n - 1.0, 1.0)).clamp_min(0.0)
        std = var.sqrt().float()
    return mean, std


def _given_stats(mean, std, device) -> torch.Tensor:
    return torch.stack([torch.as_tensor(mean), torch.as_tensor(std)]).to(
        device=device, dtype=torch.float32
    )


def _seed(gen: torch.Generator | None, params: SmaQParams) -> int:
    if not params.stochastic_rounding:
        return 0
    if gen is None:
        raise ValueError("stochastic rounding requires a torch.Generator")
    return draw_seed(gen)


def smaq_fused(
    x: torch.Tensor,
    gen: torch.Generator | None,
    params: SmaQParams = SmaQParams(),
    *,
    all_positive: bool = False,
    compute_size: bool = True,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SmaQ of a CUDA tensor through the kernels; same contract as
    ``smaq_quantize_dequantize``.  ``compute_size=False`` skips the outlier
    count and returns the static all-main-bucket floor as the size."""
    if not x.is_cuda:
        raise ValueError(f"smaq_fused takes CUDA tensors, got {x.device}")
    n = x.numel()
    if n < params.min_size:
        return x, torch.full((), float(n * 32), device=x.device)
    xf = x.reshape(-1).to(torch.float32).contiguous()
    seed = _seed(gen, params)
    stats = partials = None
    if mean is not None and std is not None:
        stats = _given_stats(mean, std, x.device)
    elif params.use_sample_stats and n > params.num_samples:
        stats = sample_stats(xf, params)
    else:
        partials = smaq_stats(xf)
    y, size = smaq_quantize(
        xf, params, seed=seed, stats=stats, partials=partials,
        all_positive=all_positive, compute_size=compute_size,
    )
    return y.view(x.shape).to(x.dtype), size


def smaq_fused_reference(
    x: torch.Tensor,
    gen: torch.Generator | None,
    params: SmaQParams = SmaQParams(),
    *,
    all_positive: bool = False,
    compute_size: bool = True,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' plain version, in PyTorch ops on any device.

    Follows the kernel's arithmetic: pivot-shifted one-pass sums folded in
    float64 (``smaq_kernel.py:268-278``), the folded reciprocals
    (119-130) and ``q * inv_scale_std + shift_term + mean`` (167-172).
    ``u`` (float32, ``x``'s shape) replaces the rounding noise, so a test
    can put every element on its lower (``u = 0``) or upper (``u = 1``)
    grid point."""
    n = x.numel()
    if n < params.min_size:
        return x, torch.full((), float(n * 32), device=x.device)
    flat = x.reshape(-1).to(torch.float32)
    if mean is not None and std is not None:
        mean, std = _given_stats(mean, std, x.device).unbind()
    elif params.use_sample_stats and n > params.num_samples:
        mean, std = sample_stats(flat, params).unbind()
    else:
        mean, std = pivot_stats_reference(flat, params)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    std = std.clamp(params.std_clamp_lo, params.std_clamp_hi)

    t = params.main_std_dev_threshold
    a = 1.0 / std
    b = -mean * a
    inv_out_std = std * (1.0 / params.range_outlier)
    inv_main_std = std * (1.0 / params.range_main)
    t_std = t * std

    z = flat * a + b
    hi, lo = z > t, z < -t
    outlier = hi | lo
    shift = torch.where(hi, -t, torch.where(lo, t, 0.0))
    scale = torch.where(outlier, params.range_outlier, params.range_main)
    q = (z + shift) * scale
    if params.stochastic_rounding or u is not None:
        if u is None:
            if gen is None:
                raise ValueError("stochastic rounding requires a torch.Generator")
            # top 24 random bits, as the kernel takes them
            u = torch.floor(uniform(q.shape, gen, q.device) * 2**24) * 2.0**-24
        q = torch.floor(q + u.reshape(-1))
    else:
        q = torch.trunc(q)
    inv_scale_std = torch.where(outlier, inv_out_std, inv_main_std)
    shift_term = torch.where(hi, t_std, torch.where(lo, -t_std, torch.zeros_like(t_std)))
    y = q * inv_scale_std + shift_term + mean
    if all_positive:
        y = y.clamp_min(0.0)
    bm, bo = params.num_bits_main, params.num_bits_outlier
    if compute_size:
        size = (n * bm + outlier.sum().double() * (bo - bm)).float()
    else:
        size = torch.full((), float(n * bm), device=x.device)
    return y.view(x.shape).to(x.dtype), size


def smaq_fused_or_reference(
    x: torch.Tensor,
    gen: torch.Generator | None,
    params: SmaQParams = SmaQParams(),
    *,
    all_positive: bool = False,
    compute_size: bool = True,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A CUDA tensor goes to the kernels, a CPU tensor to ``ops/smaq.py``.

    The CPU path always computes the true size; ``compute_size`` only
    spares the kernel's outlier count."""
    if x.is_cuda:
        return smaq_fused(
            x, gen, params, all_positive=all_positive,
            compute_size=compute_size, mean=mean, std=std,
        )
    if x.device.type == "cpu":
        return smaq_quantize_dequantize(
            x, gen, params, all_positive=all_positive, mean=mean, std=std
        )
    raise ValueError(f"no SmaQ path for device {x.device}")
