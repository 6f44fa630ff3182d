"""S2FP8 on the card: the wrappers of ``csrc/s2fp8.cu``, their plain PyTorch
version, and the dispatcher.

The port of ``smart_quantization_tpu/ops/pallas/s2fp8_kernel.py::
s2fp8_fused`` (its default ``intrinsic`` form) and of the statistics its
wrapper computes first.  The source note in ``csrc/s2fp8.cu`` gives the
design.  Here:

- ``s2fp8_stats`` and ``s2fp8_quantize`` launch the two kernels on
  PyTorch's current stream and count their launches in ``LAUNCHES``;
- ``s2fp8_fused`` is the kernel path of one S2FP8 call on a CUDA tensor;
- ``s2fp8_fused_reference`` is the kernels' plain version, for any device:
  the stats summed in float64, the squeeze as ``exp2(alpha * log2|x| +
  beta)`` and its inverse as ``exp2((log2 t - beta) / alpha)``, as the
  kernel computes them;
- ``s2fp8_fused_or_reference`` sends a CUDA tensor to the kernels and a CPU
  tensor to ``ops/s2fp8.py``.  There is no size threshold.
"""

from __future__ import annotations

import torch

from smart_quantization_tpu_torch.ops.cuda import build
from smart_quantization_tpu_torch.ops.cuda.float_kernel import format_args
from smart_quantization_tpu_torch.ops.cuda.launch import (
    THREADS,
    check_input,
    quant_blocks,
    raise_on,
    seed_for,
    stats_blocks,
    stream,
)
from smart_quantization_tpu_torch.ops.float_format import (
    FP8_FORMAT,
    float_quantize,
    from_bits,
    to_bits,
)
from smart_quantization_tpu_torch.ops.s2fp8 import s2fp8_quantize_dequantize, squeeze_coefs

# Launches of each kernel since the last reset (one per launch, nowhere else).
LAUNCHES = {"s2fp8_stats": 0, "s2fp8_quantize": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def s2fp8_stats(xf: torch.Tensor) -> torch.Tensor:
    """Launch the stats kernel; returns the float64 partials
    ``[sum log2|x|, max log2|x|] * blocks``."""
    check_input(xf)
    n = xf.numel()
    blocks = stats_blocks(n)
    partials = torch.empty(2 * blocks, dtype=torch.float64, device=xf.device)
    rc = build.library().s2fp8_stats(
        xf.data_ptr(), n, partials.data_ptr(), blocks, THREADS, stream(xf)
    )
    raise_on(rc, "s2fp8_stats")
    LAUNCHES["s2fp8_stats"] += 1
    return partials


def s2fp8_quantize(
    xf: torch.Tensor, partials: torch.Tensor, *, seed: int, stochastic: bool, check_inf: bool
) -> torch.Tensor:
    """Launch the fused kernel against the stats kernel's ``partials``;
    returns the flat output."""
    check_input(xf)
    n = xf.numel()
    y = torch.empty_like(xf)
    rc = build.library().s2fp8_quantize(
        xf.data_ptr(), y.data_ptr(), n, partials.data_ptr(), partials.numel() // 2,
        *format_args(FP8_FORMAT), seed, int(stochastic), int(check_inf),
        quant_blocks(n), THREADS, stream(xf),
    )
    raise_on(rc, "s2fp8_quantize")
    LAUNCHES["s2fp8_quantize"] += 1
    return y


def fold_partials(partials: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mu, max) of ``log2|x|`` from the stats kernel's partials, in PyTorch
    ops (the fold the fused kernel does first)."""
    p = partials.view(-1, 2)
    return (p[:, 0].sum() / n).float(), p[:, 1].max().float()


def stats_reference(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The stats kernel's plain version: (mu, max) of ``log2|x|``, zeros
    as 0, the sum in float64."""
    a = flat.abs()
    lg = torch.where(a == 0.0, torch.zeros_like(a), torch.log2(a))
    return (lg.double().sum() / flat.numel()).float(), lg.max()


def s2fp8_fused(
    x: torch.Tensor,
    gen: torch.Generator | None = None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
) -> torch.Tensor:
    """S2FP8 of a CUDA tensor through the kernels; same contract as
    ``s2fp8_quantize_dequantize``."""
    if not x.is_cuda:
        raise ValueError(f"s2fp8_fused takes CUDA tensors, got {x.device}")
    if x.numel() == 0:
        return x
    xf = x.reshape(-1).to(torch.float32).contiguous()
    y = s2fp8_quantize(
        xf, s2fp8_stats(xf), seed=seed_for(gen, stochastic),
        stochastic=stochastic, check_inf=check_inf,
    )
    return y.view(x.shape).to(x.dtype)


def s2fp8_fused_reference(
    x: torch.Tensor,
    gen: torch.Generator | None = None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
    rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernels' plain version, in PyTorch ops on any device
    (``s2fp8_kernel.py:146-184`` in its ``intrinsic`` form, stats as
    223-237).  ``rand`` replaces the rounding's random words."""
    flat = x.reshape(-1).to(torch.float32)
    alpha, beta = squeeze_coefs(*stats_reference(flat))
    inv_alpha = 1.0 / alpha

    bits = to_bits(flat)
    sign = bits & 0x80000000
    a = from_bits(bits & 0x7FFFFFFF)
    one = torch.ones_like(a)
    zero, nonfinite = a == 0.0, a >= float("inf")
    sq = torch.exp2(alpha * torch.log2(torch.where(zero | nonfinite, one, a)) + beta)
    sq = torch.where(nonfinite, a, torch.where(zero, 0.0, sq))
    t = float_quantize(
        sq, FP8_FORMAT, gen, stochastic=stochastic, check_inf=check_inf, rand=rand
    )
    t_zero, t_nonfinite = t == 0.0, t >= float("inf")
    out = torch.exp2((torch.log2(torch.where(t_zero | t_nonfinite, one, t)) - beta) * inv_alpha)
    out = torch.where(t_nonfinite, t, torch.where(t_zero, 0.0, out))
    y = from_bits(to_bits(out) | sign)
    return y.view(x.shape).to(x.dtype)


def s2fp8_fused_or_reference(
    x: torch.Tensor,
    gen: torch.Generator | None = None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
) -> torch.Tensor:
    """A CUDA tensor goes to the kernels, a CPU tensor to ``ops/s2fp8.py``."""
    if x.is_cuda:
        return s2fp8_fused(x, gen, stochastic=stochastic, check_inf=check_inf)
    if x.device.type == "cpu":
        return s2fp8_quantize_dequantize(x, gen, stochastic=stochastic, check_inf=check_inf)
    raise ValueError(f"no S2FP8 path for device {x.device}")
