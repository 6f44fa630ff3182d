"""CIFAR-adapted Inception-v3 in PyTorch (NCHW).

Counterpart of ``smart_quantization_tpu/models/inception.py``, matched to
its flax modules: the CIFAR stem is one 3x3 stride-1 pad-1 conv to 192
channels (no downsampling, so the first four stages run at 32x32), then
InceptionA(32), A(64), A(64), B, C(128), C(160), C(160), C(192), D, E, E,
the mean over H and W, dropout 0.5 and the fc layer; no auxiliary logits.

``BasicConv2d`` is a bias-free conv, a tap, ``TappedBatchNorm`` (ResNet's:
flax's statistics, BN-folded under ``--use_batch_norm``), ReLU and a tap.
Each block taps its pooled branch and its output; the head taps the pool,
the fc and the model output: 295 sites (90 convs x 3, 11 pools, 11 blocks,
3 in the head).

- Convs take kaiming fan-out normal weights (JAX ``_conv_init``); the fc
  takes flax ``nn.Dense``'s defaults (lecun normal, truncated at two
  standard deviations; zero bias), not ResNet's.
- flax's asymmetric paddings ``((0, 0), (3, 3))`` and the like are
  ``padding=(0, 3)``; the stride-2 convs of B and D are VALID.
- ``_avg_pool_3x3_same`` is ``F.avg_pool2d(x, 3, 1, 1)``: flax's
  ``avg_pool`` counts the padding, as torch's default, so border means are
  over 9.  ``_max_pool_3x3_s2`` is VALID: 32x32 -> 15x15 -> 7x7.
- Branches concatenate along the channels in flax's order, which is the
  order the next conv's input channels take after ``convert``.
- The pre-fc dropout draws its mask from ``TapContext.dropout_gen`` (a
  generator on the CPU, the step's ``DeviceKey`` on the card, so a
  ``--steps_per_call`` graph captures it), as BERT's does; off in eval.

Module names are the flax ones (``Conv2d_1a_3x3``, ``Mixed_5b.branch5x5_2
.conv``, ``....bn``, ``fc``), so ``convert.params_from_jax`` carries a JAX
``Inception3``'s variables over.  ``dtype`` is the compute dtype, with
``models/resnet.py``'s semantics (explicit casts, BatchNorm in float32,
float32 logits).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from smart_quantization_tpu_torch.inject.policy import LayerKind
from smart_quantization_tpu_torch.inject.tap import TapConfig, TapContext, module_tap
from smart_quantization_tpu_torch.models.bert import dropout
from smart_quantization_tpu_torch.models.resnet import Conv2d, Linear, TappedBatchNorm
from smart_quantization_tpu_torch.models.tiny import _TRUNC_STD


class BasicConv2d(nn.Module):
    """conv (no bias) -> tap -> TappedBatchNorm -> ReLU -> tap."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0,
                 tap: TapConfig | None = None):
        super().__init__()
        self.tap = tap
        self.conv = Conv2d(cin, cout, kernel, stride, padding=padding, bias=False)
        nn.init.kaiming_normal_(self.conv.weight, mode="fan_out", nonlinearity="relu")
        self.bn = TappedBatchNorm(cout, tap)

    def forward(self, x: torch.Tensor, tap_ctx: TapContext | None = None) -> torch.Tensor:
        x = module_tap(self.conv(x), LayerKind.CONV, self.tap, tap_ctx)
        x = F.relu(self.bn(x, tap_ctx))
        return module_tap(x, LayerKind.ACTIVATION, self.tap, tap_ctx)


def _avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1)


def _max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """A block of named ``BasicConv2d`` chains whose outputs, with the
    tapped pooled input (through ``branch_pool`` where there is one), are
    concatenated along the channels and tapped."""

    pool = staticmethod(_avg_pool_3x3_same)

    def __init__(self, tap: TapConfig | None, convs):
        super().__init__()
        self.tap = tap
        for name, args in convs:
            self.add_module(name, BasicConv2d(*args, tap=tap))

    def chain(self, x, tap_ctx, *names):
        for name in names:
            x = getattr(self, name)(x, tap_ctx)
        return x

    def pooled(self, x, tap_ctx):
        return module_tap(self.pool(x), LayerKind.POOL, self.tap, tap_ctx)

    def out(self, branches, tap_ctx):
        return module_tap(torch.cat(branches, dim=1), LayerKind.BLOCK, self.tap, tap_ctx)


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int, tap: TapConfig | None = None):
        super().__init__(tap, [
            ("branch1x1", (cin, 64, 1)),
            ("branch5x5_1", (cin, 48, 1)), ("branch5x5_2", (48, 64, 5, 1, 2)),
            ("branch3x3dbl_1", (cin, 64, 1)), ("branch3x3dbl_2", (64, 96, 3, 1, 1)),
            ("branch3x3dbl_3", (96, 96, 3, 1, 1)),
            ("branch_pool", (cin, pool_features, 1)),
        ])
        self.out_channels = 224 + pool_features

    def forward(self, x, tap_ctx=None):
        c = tap_ctx
        return self.out([
            self.chain(x, c, "branch1x1"),
            self.chain(x, c, "branch5x5_1", "branch5x5_2"),
            self.chain(x, c, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
            self.branch_pool(self.pooled(x, c), c),
        ], c)


class InceptionB(_Block):
    pool = staticmethod(_max_pool_3x3_s2)

    def __init__(self, cin: int, tap: TapConfig | None = None):
        super().__init__(tap, [
            ("branch3x3", (cin, 384, 3, 2)),
            ("branch3x3dbl_1", (cin, 64, 1)), ("branch3x3dbl_2", (64, 96, 3, 1, 1)),
            ("branch3x3dbl_3", (96, 96, 3, 2)),
        ])
        self.out_channels = 480 + cin

    def forward(self, x, tap_ctx=None):
        c = tap_ctx
        return self.out([
            self.chain(x, c, "branch3x3"),
            self.chain(x, c, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
            self.pooled(x, c),
        ], c)


# flax's ((0, 0), (3, 3)) and ((3, 3), (0, 0)) on the 1x7 and 7x1 kernels
_P17, _P71 = (0, 3), (3, 0)


class InceptionC(_Block):
    def __init__(self, cin: int, channels_7x7: int, tap: TapConfig | None = None):
        c7 = channels_7x7
        super().__init__(tap, [
            ("branch1x1", (cin, 192, 1)),
            ("branch7x7_1", (cin, c7, 1)), ("branch7x7_2", (c7, c7, (1, 7), 1, _P17)),
            ("branch7x7_3", (c7, 192, (7, 1), 1, _P71)),
            ("branch7x7dbl_1", (cin, c7, 1)), ("branch7x7dbl_2", (c7, c7, (7, 1), 1, _P71)),
            ("branch7x7dbl_3", (c7, c7, (1, 7), 1, _P17)),
            ("branch7x7dbl_4", (c7, c7, (7, 1), 1, _P71)),
            ("branch7x7dbl_5", (c7, 192, (1, 7), 1, _P17)),
            ("branch_pool", (cin, 192, 1)),
        ])
        self.out_channels = 768

    def forward(self, x, tap_ctx=None):
        c = tap_ctx
        return self.out([
            self.chain(x, c, "branch1x1"),
            self.chain(x, c, "branch7x7_1", "branch7x7_2", "branch7x7_3"),
            self.chain(x, c, *(f"branch7x7dbl_{i}" for i in range(1, 6))),
            self.branch_pool(self.pooled(x, c), c),
        ], c)


class InceptionD(_Block):
    pool = staticmethod(_max_pool_3x3_s2)

    def __init__(self, cin: int, tap: TapConfig | None = None):
        super().__init__(tap, [
            ("branch3x3_1", (cin, 192, 1)), ("branch3x3_2", (192, 320, 3, 2)),
            ("branch7x7x3_1", (cin, 192, 1)), ("branch7x7x3_2", (192, 192, (1, 7), 1, _P17)),
            ("branch7x7x3_3", (192, 192, (7, 1), 1, _P71)),
            ("branch7x7x3_4", (192, 192, 3, 2)),
        ])
        self.out_channels = 512 + cin

    def forward(self, x, tap_ctx=None):
        c = tap_ctx
        return self.out([
            self.chain(x, c, "branch3x3_1", "branch3x3_2"),
            self.chain(x, c, *(f"branch7x7x3_{i}" for i in range(1, 5))),
            self.pooled(x, c),
        ], c)


class InceptionE(_Block):
    def __init__(self, cin: int, tap: TapConfig | None = None):
        super().__init__(tap, [
            ("branch1x1", (cin, 320, 1)),
            ("branch3x3_1", (cin, 384, 1)), ("branch3x3_2a", (384, 384, (1, 3), 1, (0, 1))),
            ("branch3x3_2b", (384, 384, (3, 1), 1, (1, 0))),
            ("branch3x3dbl_1", (cin, 448, 1)), ("branch3x3dbl_2", (448, 384, 3, 1, 1)),
            ("branch3x3dbl_3a", (384, 384, (1, 3), 1, (0, 1))),
            ("branch3x3dbl_3b", (384, 384, (3, 1), 1, (1, 0))),
            ("branch_pool", (cin, 192, 1)),
        ])
        self.out_channels = 2048

    def forward(self, x, tap_ctx=None):
        c = tap_ctx
        b1 = self.chain(x, c, "branch1x1")
        b3 = self.chain(x, c, "branch3x3_1")
        b3 = torch.cat([self.chain(b3, c, "branch3x3_2a"), self.chain(b3, c, "branch3x3_2b")], 1)
        bd = self.chain(x, c, "branch3x3dbl_1", "branch3x3dbl_2")
        bd = torch.cat([self.chain(bd, c, "branch3x3dbl_3a"),
                        self.chain(bd, c, "branch3x3dbl_3b")], 1)
        return self.out([b1, b3, bd, self.branch_pool(self.pooled(x, c), c)], c)


# the blocks after the stem, in order: (name, class, its arguments after
# the input channels)
BLOCKS = (
    ("Mixed_5b", InceptionA, (32,)), ("Mixed_5c", InceptionA, (64,)),
    ("Mixed_5d", InceptionA, (64,)), ("Mixed_6a", InceptionB, ()),
    ("Mixed_6b", InceptionC, (128,)), ("Mixed_6c", InceptionC, (160,)),
    ("Mixed_6d", InceptionC, (160,)), ("Mixed_6e", InceptionC, (192,)),
    ("Mixed_7a", InceptionD, ()), ("Mixed_7b", InceptionE, ()), ("Mixed_7c", InceptionE, ()),
)


class Inception3(nn.Module):
    """CIFAR Inception-v3: (N, 3, 32, 32) -> ``num_classes`` float32
    logits, computed in ``dtype``."""

    def __init__(self, num_classes: int = 10, tap: TapConfig | None = None,
                 dropout_rate: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tap = tap
        self.dropout_rate = dropout_rate
        self.compute_dtype = dtype
        self.Conv2d_1a_3x3 = BasicConv2d(3, 192, 3, 1, 1, tap=tap)
        cin = 192
        for name, cls, extra in BLOCKS:
            block = cls(cin, *extra, tap=tap)
            self.add_module(name, block)
            cin = block.out_channels
        self.fc = Linear(cin, num_classes)
        std = math.sqrt(1.0 / cin) / _TRUNC_STD  # flax's lecun_normal
        nn.init.trunc_normal_(self.fc.weight, 0.0, std, -2 * std, 2 * std)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor, tap_ctx: TapContext | None = None) -> torch.Tensor:
        tap, ctx = self.tap, tap_ctx
        x = self.Conv2d_1a_3x3(x.to(self.compute_dtype), ctx)
        for name, _, _ in BLOCKS:
            x = getattr(self, name)(x, ctx)
        x = module_tap(x.mean(dim=(2, 3)), LayerKind.POOL, tap, ctx)
        if self.training:
            x = dropout(x, self.dropout_rate, None if ctx is None else ctx.dropout_gen)
        x = module_tap(self.fc(x), LayerKind.LINEAR, tap, ctx)
        return module_tap(x, LayerKind.BLOCK, tap, ctx).float()


def inception_v3(num_classes: int = 10, tap: TapConfig | None = None,
                 dtype: torch.dtype = torch.float32) -> Inception3:
    return Inception3(num_classes=num_classes, tap=tap, dtype=dtype)
