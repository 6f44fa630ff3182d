"""Statistics of the whole global batch, on ranks that each hold rows of it.

The JAX package's XLA-managed FSDP step (``parallel/train_fsdp.py``) is one
``jax.jit`` over the global arrays, so every statistic in it covers the
whole batch: flax's BatchNorm normalizes with the global batch's mean and
variance (XLA inserts the all-reduce), and each tap quantizes with the
statistics of the whole feature or gradient map.  A :class:`StatsGroup`
on the tap context (``inject/tap.py``) gives a rank that view of its rows:

- :meth:`StatsGroup.compress`: one encoder call on this rank's rows with
  the statistics and the random draws of the whole tensor.  SmaQ: every
  rank's folded float64 sums about its pivot (``smaq_stats``' ``sums``),
  gathered and folded in rank order about rank 0's pivot into the mean and
  the ddof=1 std (or the range std from the min and max;
  ``smaq_kernel.fold_sums``); under ``use_sample_stats`` the one-device
  sample of the whole tensor (``ops/smaq.py::compute_stats``: one element
  of each of ``num_samples`` strata at an offset ``j`` drawn from the
  shared key), each rank writing the elements in its rows into a vector
  of zeros, summed over the ranks (adding zeros is exact); S2FP8: the sum
  and max of ``log2|x|`` (``s2fp8_stats``' ``sums``); the float formats
  need none.  ``min_size`` is decided on the whole tensor's count.  The
  quantize kernels take the statistics as given (``smaq_fused``'s
  ``mean``/``std``, ``s2fp8_fused``'s ``stats``).  On the card the sums
  come from the stats kernels, on the CPU from their plain versions
  (``pivot_sums_reference``, ``log2_sums``).  Every rank draws from the
  same key, and the call's :class:`~smart_quantization_tpu_torch.ops.keys.
  PartKey` places its rows in the whole tensor (rank ``r`` of ``W``, ``n``
  elements each: offset ``r n`` of ``W n``), so an element draws the noise
  one device draws for it.
- :meth:`StatsGroup.batch_norm`: BatchNorm's training-mode normalization
  with the whole batch's per-channel mean and biased variance (float64
  sums of x and x * x all-reduced; flax's ``E[x^2] - E[x]^2``),
  differentiable: the backward all-reduces the sums' gradients, as a
  synchronized BatchNorm does; the running statistics are updated from the
  same values, the biased variance as flax's (``models/resnet.py``).

A group of one rank (or ``group=None``: one device holding the whole
batch) runs the same arithmetic with no collective.  Every rank holds the
same number of rows, rank ``r`` of the group the ``r``-th block of them.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from smart_quantization_tpu_torch.compress.base import SizeStats
from smart_quantization_tpu_torch.compress.encoders import S2FP8, SmaQ
from smart_quantization_tpu_torch.ops.cuda.launch import kernel_input
from smart_quantization_tpu_torch.ops.cuda.s2fp8_kernel import s2fp8_stats
from smart_quantization_tpu_torch.ops.cuda.smaq_kernel import (
    SUM_WORDS,
    fold_sums,
    pivot_sums_reference,
    smaq_stats,
)
from smart_quantization_tpu_torch.ops.keys import PartKey
from smart_quantization_tpu_torch.ops.smaq import sample_moments, stratum_offset
from smart_quantization_tpu_torch.parallel.collectives import all_gather_single


def smaq_sums(x: torch.Tensor, params) -> torch.Tensor:
    """This rank's folded SmaQ sums of ``x``: float64 ``[sum(d), sum(d *
    d), min, max, pivot]``, from ``smaq_stats`` on the card."""
    flat = kernel_input(x)
    if not flat.is_cuda:
        return pivot_sums_reference(flat)
    sums = torch.empty(SUM_WORDS, dtype=torch.float64, device=flat.device)
    smaq_stats(flat, params, sums=sums)
    return sums


def log2_sums(x: torch.Tensor) -> torch.Tensor:
    """This rank's S2FP8 sums of ``x``: float64 ``[sum, max]`` of
    ``log2|x|`` (zeros as 0), from ``s2fp8_stats`` on the card."""
    flat = kernel_input(x)
    if flat.is_cuda:
        sums = torch.empty(2, dtype=torch.float64, device=flat.device)
        s2fp8_stats(flat, sums=sums)
        return sums
    a = flat.float().abs()
    lg = torch.where(a == 0.0, torch.zeros_like(a), torch.log2(a))
    return torch.stack([lg.double().sum(), lg.max().double()])


def fold_log2(sums: torch.Tensor, total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """S2FP8's mean and max of ``log2|x|`` (0-d float32) from every rank's
    ``log2_sums`` (W, 2), the sums added in rank order."""
    return (sums[:, 0].sum() / total).float(), sums[:, 1].max().float()


@functools.lru_cache(maxsize=None)
def _without_min_size(compressor: SmaQ) -> SmaQ:
    """The compressor with no ``min_size`` of its own: the whole tensor's
    count decides, before the call."""
    return dataclasses.replace(compressor, params=dataclasses.replace(compressor.params,
                                                                      min_size=0))


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group's ranks whose gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class StatsGroup:
    """The ranks over which a step's statistics run: ``group`` (a process
    group of ``size`` ranks, each with the same number of rows), of which
    this process is rank ``rank``, or None for one device."""

    def __init__(self, group=None, size: int = 1, rank: int = 0):
        if group is None and size != 1:
            raise ValueError(f"a group of {size} ranks needs its process group")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a group of {size}")
        self.group = group
        self.size = size
        self.rank = rank

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order, ``(size, *t.shape)``."""
        if self.size == 1:
            return t.unsqueeze(0)
        out = torch.empty((self.size * t.numel(),), dtype=t.dtype, device=t.device)
        all_gather_single(out, t.reshape(-1).contiguous(), group=self.group)
        return out.view(self.size, *t.shape)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable."""
        if self.size == 1:
            return t
        return _AllReduceSum.apply(t, self.group)

    def sample(self, x: torch.Tensor, params, key) -> tuple[torch.Tensor, torch.Tensor]:
        """Sampled stats' (mean, std) of the whole tensor, this rank holding
        ``x``: the one-device sample (``ops/smaq.py::compute_stats``) of
        the ``W n`` elements, ``j`` drawn from ``key`` on every rank (a
        device tensor from a step key), the elements of this rank's range
        written into a vector of zeros and the vectors summed."""
        n = x.numel()
        k = params.num_samples
        m = n * self.size // k
        j = stratum_offset(key, m, x.device)
        idx = torch.arange(k, device=x.device) * m + (j - self.rank * n)
        mine = (idx >= 0) & (idx < n)
        flat = x.reshape(-1).float()
        sample = torch.where(mine, flat[idx.clamp(0, n - 1)], torch.zeros((), device=x.device))
        if self.size > 1:
            dist.all_reduce(sample, op=dist.ReduceOp.SUM, group=self.group)
        return sample_moments(sample, params)

    def compress(self, compressor, x: torch.Tensor, key, *, gamma=None, beta=None):
        """``compressor(x, key)`` on this rank's rows with the statistics and
        the random draws of the whole tensor over the ranks; returns ``(y,
        SizeStats)`` of this rank's part."""
        n = x.numel()
        part = PartKey(key, self.rank * n, self.size * n)
        if isinstance(compressor, SmaQ):
            params = compressor.params
            if n * self.size < params.min_size:
                return x, SizeStats.of(n, 32, 32, x.device)
            if params.use_sample_stats and n * self.size > params.num_samples:
                mean, std = self.sample(x, params, key)
            else:
                mean, std = fold_sums(self.gather(smaq_sums(x, params)), n, params)
            return _without_min_size(compressor)(x, part, gamma=gamma, beta=beta,
                                                 mean=mean, std=std)
        if isinstance(compressor, S2FP8):
            if n == 0:
                return compressor(x, part)
            return compressor(x, part, log2_stats=fold_log2(self.gather(log2_sums(x)),
                                                            n * self.size))
        return compressor(x, part, gamma=gamma, beta=beta)

    def batch_norm(self, bn, xf: torch.Tensor) -> torch.Tensor:
        """Training-mode BatchNorm of module ``bn`` (``models/resnet.py``:
        ``weight``, ``bias``, the running buffers, ``momentum``, ``eps``) on
        this rank's float32 rows, with the whole batch's statistics over
        dim 1; updates the running statistics."""
        dims = [0, *range(2, xf.dim())]
        count = xf.numel() // xf.shape[1] * self.size
        xd = xf.double()
        sums = self.all_reduce(torch.stack([xd.sum(dims), (xd * xd).sum(dims)]))
        mean = sums[0] / count
        var = (sums[1] / count - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            bn.running_mean.mul_(bn.momentum).add_(mean.float(), alpha=1 - bn.momentum)
            bn.running_var.mul_(bn.momentum).add_(var.float(), alpha=1 - bn.momentum)
        shape = (1, -1, *([1] * (xf.dim() - 2)))
        scale = torch.rsqrt(var + bn.eps).float() * bn.weight
        return (xf - mean.float().view(shape)) * scale.view(shape) + bn.bias.view(shape)
