"""SmaQ z-score fake quantization in plain PyTorch (Nahmias et al.,
"SmaQ: Smart Quantization for DNN Training by Exploiting Value
Clustering"), with stochastic rounding on given noise.

One call on a tensor ``x`` of ``n >= min_size`` elements:

1. statistics in float64 about a pivot (the float32 mean of the first 256
   elements, summed in a fixed order): ``d = x - pivot`` in float32, ``mean
   = pivot + sum(d) / n``, ``std`` with ddof=1; a zero std is taken as 1;
2. ``z = (x - mean) / std`` (as ``(x - mean) * (1 / std)``); elements with
   ``|z| > t_main`` are outliers, shifted toward zero by ``t_main`` and
   scaled by ``range_outlier``, the rest scaled by ``range_main``;
3. ``q = floor(scaled + u)`` with ``u`` in ``[0, 1)`` (stochastic
   rounding);
4. back through the scale and the shift (``q * std / scale + shift *
   std`` rounded once), then ``mean``; an
   ``all_positive`` buffer (Adam's second moment) is clamped at zero.

Smaller tensors pass through.  A bfloat16 tensor is quantized in float32
and rounded back to bfloat16 once.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SmaQ:
    num_bits_main: int = 6
    num_bits_outlier: int = 8
    main_std_dev_threshold: float = 1.0
    outlier_std_dev_threshold: float = 2.5
    min_size: int = 8

    @property
    def range_main(self) -> float:
        return ((2 ** (self.num_bits_main - 2)) - 1) / self.main_std_dev_threshold

    @property
    def range_outlier(self) -> float:
        return ((2 ** (self.num_bits_outlier - 2)) - 1) / (
            self.outlier_std_dev_threshold - self.main_std_dev_threshold)


PIVOT_ELEMS, LANES = 256, 32


def pivot(flat: torch.Tensor) -> torch.Tensor:
    """The float32 mean of the first 256 elements (zeros past the end),
    summed as 32 lanes each add their 8 elements ``lane + 32 k`` in turn,
    then a butterfly over the lanes (offsets 16, 8, 4, 2, 1), then divided
    by the count: every float32 rounding in a fixed order."""
    n = min(flat.numel(), PIVOT_ELEMS)
    v = torch.zeros(PIVOT_ELEMS, dtype=torch.float32, device=flat.device)
    v[:n] = flat[:n]
    v = v.view(PIVOT_ELEMS // LANES, LANES)
    s = v[0]
    for k in range(1, v.shape[0]):
        s = s + v[k]
    lanes = torch.arange(LANES, device=flat.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[lanes ^ off]
    return s[0] / torch.full((), float(n), dtype=torch.float32, device=flat.device)


def stats(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float32 (mean, std) of a float32 vector: float64 sums of the float32
    differences from the pivot, ddof=1."""
    n = flat.numel()
    p = pivot(flat)
    d = (flat - p).double()
    s1, s2 = d.sum(), (d * d).sum()
    mean = (p.double() + s1 / n).float()
    var = ((s2 - s1 * (s1 / n)) / max(n - 1.0, 1.0)).clamp_min(0.0)
    return mean, var.sqrt().float()


def quantize(x: torch.Tensor, u_of, q: SmaQ, all_positive: bool = False) -> torch.Tensor:
    """SmaQ of ``x`` with rounding noise ``u_of(n)`` (a float32 vector of
    ``n`` uniforms, asked for only when the tensor is quantized)."""
    n = x.numel()
    if n < q.min_size:
        return x
    flat = x.reshape(-1).to(torch.float32)
    mean, std = stats(flat)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    std = std.clamp(1e-38, 1e38)
    a = 1.0 / std
    inv_main = std * (1.0 / q.range_main)
    inv_out = std * (1.0 / q.range_outlier)
    t = q.main_std_dev_threshold
    t_std = t * std
    z = (flat - mean) * a
    hi, lo = z > t, z < -t
    outlier = hi | lo
    shift = torch.where(hi, -t, torch.where(lo, t, 0.0))
    scale = torch.where(outlier, q.range_outlier, q.range_main)
    qz = torch.floor((z + shift) * scale + u_of(n))
    # q * inv + shift rounded once (a fused multiply-add: the product is
    # exact in float64), then + mean
    st = torch.where(hi, t_std, torch.where(lo, -t_std, torch.zeros_like(t_std)))
    y = (qz.double() * torch.where(outlier, inv_out, inv_main).double() + st.double()).float() \
        + mean
    if all_positive:
        y = y.clamp_min(0.0)
    return y.view(x.shape).to(x.dtype)
