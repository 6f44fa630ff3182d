"""CIFAR-adapted ResNet-18/34/50 in PyTorch (NCHW).

Counterpart of ``smart_quantization_tpu/models/resnet.py``, matched to its
flax modules: a 3x3 stride-1 stem without max-pool, BasicBlock/Bottleneck
blocks, kaiming fan-out normal conv init, zero-init of the last BN of each
residual branch, and an fc layer with ``variance_scaling(1/3, fan_in,
uniform)`` weights and a zero bias.  A compression tap sits at every site
the JAX model taps: after each conv, BN, ReLU, block output, the pool, the
fc and the model output (68 sites in ResNet-18).

Module and attribute names follow the flax ones (``conv1``, ``bn1``,
``layer1_0.downsample_conv`` ...), so ``convert.params_from_jax`` maps one
tree onto the other by name.

``dtype`` is the compute dtype (``--compute_dtype``), with flax's
semantics of ``dtype=`` on each module, by explicit casts: the input is
cast to it; each conv and the fc cast their float32 weight to it at use
and compute in it; a BatchNorm takes its statistics and normalizes in
float32 (flax's ``_compute_stats`` and ``_normalize`` promote to float32)
and returns its input's dtype; ReLU, the residual add and the pool run in
it, and the logits come back float32.  Parameters and running statistics
stay float32.  Under bfloat16 every tap sees bfloat16 feature maps and
gradient maps.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from smart_quantization_tpu_torch.inject.policy import LayerKind
from smart_quantization_tpu_torch.inject.tap import TapConfig, TapContext, module_tap


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: the float32 weight is cast at
    use, as flax's ``nn.Conv(dtype=...)`` casts its kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype (flax's ``nn.Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    # flax 'SAME' on the 1x1 stride-2 downsample is padding 0; the 3x3 convs
    # pad 1 explicitly in both
    conv = Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
    return conv


class TappedBatchNorm(nn.Module):
    """BatchNorm + compression tap (BN-folded under ``--use_batch_norm``),
    with flax's statistics: momentum 0.9
    (torch's 0.1), eps 1e-5, and the running variance updated with the
    BIASED batch variance, as ``flax.linen.BatchNorm`` does (torch's own
    BatchNorm2d uses the unbiased one, so the update is written here).  The
    statistics and the normalization are float32 whatever ``x``'s dtype,
    and the output takes ``x``'s dtype, as flax's ``BatchNorm(dtype=...)``.
    A context with a ``stats_group`` takes the statistics of the whole
    batch over its ranks (``parallel/whole_batch.py``)."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, channels: int, tap: TapConfig | None, zero_init: bool = False):
        super().__init__()
        self.tap = tap
        self.weight = nn.Parameter(
            torch.zeros(channels) if zero_init else torch.ones(channels)
        )
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, tap_ctx: TapContext | None = None) -> torch.Tensor:
        xf = x.float()
        group = tap_ctx.stats_group if tap_ctx is not None else None
        if self.training and group is not None:
            y = group.batch_norm(self, xf)
        elif self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
            y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0, self.eps)
        else:
            y = F.batch_norm(
                xf, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        y = y.to(x.dtype)
        # --use_batch_norm folds gamma and beta into the forward compress;
        # they are detached: their gradient comes from F.batch_norm alone
        return module_tap(y, LayerKind.NORM, self.tap, tap_ctx,
                          gamma=self.weight.detach(), beta=self.bias.detach())


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, tap: TapConfig | None):
        super().__init__()
        self.tap = tap
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = TappedBatchNorm(filters, tap)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = TappedBatchNorm(filters, tap, zero_init=True)
        self.has_downsample = stride != 1 or cin != filters
        if self.has_downsample:
            self.downsample_conv = _conv(cin, filters, 1, stride)
            self.downsample_bn = TappedBatchNorm(filters, tap)

    def forward(self, x, tap_ctx=None):
        tap, ctx = self.tap, tap_ctx
        y = module_tap(self.conv1(x), LayerKind.CONV, tap, ctx)
        y = F.relu(self.bn1(y, ctx))
        y = module_tap(y, LayerKind.ACTIVATION, tap, ctx)
        y = module_tap(self.conv2(y), LayerKind.CONV, tap, ctx)
        y = self.bn2(y, ctx)
        residual = x
        if self.has_downsample:
            residual = module_tap(self.downsample_conv(x), LayerKind.CONV, tap, ctx)
            residual = self.downsample_bn(residual, ctx)
        y = module_tap(F.relu(y + residual), LayerKind.ACTIVATION, tap, ctx)
        return module_tap(y, LayerKind.BLOCK, tap, ctx)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, tap: TapConfig | None):
        super().__init__()
        self.tap = tap
        out = filters * self.expansion
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = TappedBatchNorm(filters, tap)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = TappedBatchNorm(filters, tap)
        self.conv3 = _conv(filters, out, 1)
        self.bn3 = TappedBatchNorm(out, tap, zero_init=True)
        self.has_downsample = stride != 1 or cin != out
        if self.has_downsample:
            self.downsample_conv = _conv(cin, out, 1, stride)
            self.downsample_bn = TappedBatchNorm(out, tap)

    def forward(self, x, tap_ctx=None):
        tap, ctx = self.tap, tap_ctx
        y = module_tap(self.conv1(x), LayerKind.CONV, tap, ctx)
        y = module_tap(F.relu(self.bn1(y, ctx)), LayerKind.ACTIVATION, tap, ctx)
        y = module_tap(self.conv2(y), LayerKind.CONV, tap, ctx)
        y = module_tap(F.relu(self.bn2(y, ctx)), LayerKind.ACTIVATION, tap, ctx)
        y = module_tap(self.conv3(y), LayerKind.CONV, tap, ctx)
        y = self.bn3(y, ctx)
        residual = x
        if self.has_downsample:
            residual = module_tap(self.downsample_conv(x), LayerKind.CONV, tap, ctx)
            residual = self.downsample_bn(residual, ctx)
        y = module_tap(F.relu(y + residual), LayerKind.ACTIVATION, tap, ctx)
        return module_tap(y, LayerKind.BLOCK, tap, ctx)


class ResNet(nn.Module):
    """CIFAR ResNet; ``num_classes`` float32 logits from (N, 3, 32, 32)
    input, computed in ``dtype``."""

    def __init__(self, stage_sizes, block_cls, num_classes: int = 10,
                 tap: TapConfig | None = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tap = tap
        self.compute_dtype = dtype
        self.conv1 = _conv(3, 64, 3)
        self.bn1 = TappedBatchNorm(64, tap)
        cin = 64
        self.block_names = []
        for i, num_blocks in enumerate(stage_sizes):
            filters = 64 * 2**i
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block_cls(cin, filters, stride, tap))
                self.block_names.append(name)
                cin = filters * block_cls.expansion
        self.fc = Linear(cin, num_classes)
        bound = 1.0 / math.sqrt(cin)  # variance_scaling(1/3, fan_in, uniform)
        nn.init.uniform_(self.fc.weight, -bound, bound)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor, tap_ctx: TapContext | None = None) -> torch.Tensor:
        tap, ctx = self.tap, tap_ctx
        x = module_tap(self.conv1(x.to(self.compute_dtype)), LayerKind.CONV, tap, ctx)
        x = module_tap(F.relu(self.bn1(x, ctx)), LayerKind.ACTIVATION, tap, ctx)
        for name in self.block_names:
            x = getattr(self, name)(x, ctx)
        x = module_tap(x.mean(dim=(2, 3)), LayerKind.POOL, tap, ctx)
        x = module_tap(self.fc(x), LayerKind.LINEAR, tap, ctx)
        return module_tap(x, LayerKind.BLOCK, tap, ctx).float()


resnet18 = partial(ResNet, (2, 2, 2, 2), BasicBlock)
resnet34 = partial(ResNet, (3, 4, 6, 3), BasicBlock)
resnet50 = partial(ResNet, (3, 4, 6, 3), Bottleneck)
