"""CIFAR ResNet-18 (He et al. 2016, arXiv:1512.03385, in the CIFAR form
the SmaQ reference trains), forward and loss in plain PyTorch over a dict
of float32 parameters.

A 3x3 stride-1 stem of 64 channels and no max-pool; BasicBlocks 2-2-2-2
at widths 64-128-256-512, the first block of stages 2-4 with stride 2 and
a 1x1 projection; global average pool; a linear head.  BatchNorm takes
the batch's statistics in float32 (eps 1e-5).  The compute dtype casts
the input and each weight at use; BatchNorm returns its input's dtype,
the logits come back float32.

A compression tap sits at every layer output: after each convolution,
BatchNorm and ReLU, at each block's output, after the pool, after the head
and on the logits (68 in ResNet-18), in this order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def blocks(cfg: dict):
    """(name, in channels, width, stride) of each BasicBlock."""
    out, cin = [], cfg["stem_channels"]
    for i, (n, width) in enumerate(zip(cfg["stage_blocks"], cfg["stage_widths"])):
        for j in range(n):
            out.append((f"layer{i + 1}_{j}", cin, width, 2 if i > 0 and j == 0 else 1))
            cin = width
    return out


def param_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    c0 = cfg["stem_channels"]
    shapes = [("conv1.weight", (c0, cfg["image_channels"], 3, 3)),
              ("bn1.weight", (c0,)), ("bn1.bias", (c0,))]
    for name, cin, w, stride in blocks(cfg):
        shapes += [(f"{name}.conv1.weight", (w, cin, 3, 3)),
                   (f"{name}.bn1.weight", (w,)), (f"{name}.bn1.bias", (w,)),
                   (f"{name}.conv2.weight", (w, w, 3, 3)),
                   (f"{name}.bn2.weight", (w,)), (f"{name}.bn2.bias", (w,))]
        if stride != 1 or cin != w:
            shapes += [(f"{name}.downsample_conv.weight", (w, cin, 1, 1)),
                       (f"{name}.downsample_bn.weight", (w,)),
                       (f"{name}.downsample_bn.bias", (w,))]
    last = cfg["stage_widths"][-1]
    return shapes + [("fc.weight", (cfg["num_classes"], last)), ("fc.bias", (cfg["num_classes"],))]


def _conv(step, p, name, x, stride=1):
    w = p[name + ".weight"]
    return F.conv2d(step.operand(x), step.operand(w.to(x.dtype)), None, stride,
                    w.shape[-1] // 2)


def _bn(step, p, name, x):
    y = F.batch_norm(x.float(), None, None, p[name + ".weight"], p[name + ".bias"], True, 0.0,
                     BN_EPS)
    return step.tap(y.to(x.dtype))


def forward(cfg: dict, p: dict, x: torch.Tensor, step, dtype: torch.dtype) -> torch.Tensor:
    """Float32 logits of NCHW float32 images ``x``."""
    tap = step.tap
    x = tap(_conv(step, p, "conv1", x.to(dtype)))
    x = tap(F.relu(_bn(step, p, "bn1", x)))
    for name, cin, w, stride in blocks(cfg):
        y = tap(_conv(step, p, f"{name}.conv1", x, stride))
        y = tap(F.relu(_bn(step, p, f"{name}.bn1", y)))
        y = tap(_conv(step, p, f"{name}.conv2", y))
        y = _bn(step, p, f"{name}.bn2", y)
        residual = x
        if stride != 1 or cin != w:
            residual = tap(_conv(step, p, f"{name}.downsample_conv", x, stride))
            residual = _bn(step, p, f"{name}.downsample_bn", residual)
        x = tap(tap(F.relu(y + residual)))
    x = tap(x.mean(dim=(2, 3)))
    w, b = p["fc.weight"], p["fc.bias"]
    x = tap(F.linear(step.operand(x), step.operand(w.to(x.dtype)), b.to(x.dtype)))
    return tap(x).float()


def loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())
