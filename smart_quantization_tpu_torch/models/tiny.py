"""A tiny CNN for fast tests (CIFAR-shaped in and out, every site tapped).

Counterpart of ``smart_quantization_tpu/models/tiny.py``, NCHW: a 3x3
stride-2 conv of 16 filters, a tapped BatchNorm, ReLU, a 3x3 stride-2 conv
of 32, the mean over H and W, and an fc layer; taps after each conv, the
BatchNorm, the ReLU, the pool and the fc (6 sites).  The convs take
kaiming fan-out normal weights as ResNet's (``_conv_init``), the fc flax
``nn.Dense``'s defaults (lecun normal, truncated at two standard
deviations; zero bias).  The names are the flax ones, so
``convert.params_from_jax`` carries a JAX ``TinyCNN``'s variables over.
``dtype`` is the compute dtype, as ResNet's (``models/resnet.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from smart_quantization_tpu_torch.inject.policy import LayerKind
from smart_quantization_tpu_torch.inject.tap import TapConfig, TapContext, module_tap
from smart_quantization_tpu_torch.models.resnet import Linear, TappedBatchNorm, _conv

# flax's truncated normal: std / 0.8796 keeps the standard deviation after
# the cut at two standard deviations
_TRUNC_STD = 0.87962566103423978


class TinyCNN(nn.Module):
    def __init__(self, num_classes: int = 10, tap: TapConfig | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tap = tap
        self.compute_dtype = dtype
        self.conv1 = _conv(3, 16, 3, 2)
        self.bn1 = TappedBatchNorm(16, tap)
        self.conv2 = _conv(16, 32, 3, 2)
        self.fc = Linear(32, num_classes)
        std = math.sqrt(1.0 / 32) / _TRUNC_STD
        nn.init.trunc_normal_(self.fc.weight, 0.0, std, -2 * std, 2 * std)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor, tap_ctx: TapContext | None = None) -> torch.Tensor:
        tap, ctx = self.tap, tap_ctx
        x = module_tap(self.conv1(x.to(self.compute_dtype)), LayerKind.CONV, tap, ctx)
        x = F.relu(self.bn1(x, ctx))
        x = module_tap(x, LayerKind.ACTIVATION, tap, ctx)
        x = module_tap(self.conv2(x), LayerKind.CONV, tap, ctx)
        x = module_tap(x.mean(dim=(2, 3)), LayerKind.POOL, tap, ctx)
        return module_tap(self.fc(x), LayerKind.LINEAR, tap, ctx).float()
