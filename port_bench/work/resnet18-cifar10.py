"""The work of a ResNet-18 CIFAR training step, counted from the
configuration's published shapes (not from what the program launches).

- ``flops_per_sample``: 3 x the forward pass's 2 x multiply-accumulates of
  the convolutions and the head (BatchNorm, ReLU and the pool left out);
- ``compression``: the elements SmaQ quantizes in a step on one chip, by
  structure and element type: the 68 tapped feature maps forward and
  their gradient maps backward (in the compute dtype), and, in float32,
  every gradient, every weight but BatchNorm's, every momentum buffer.
  Each element is read once and written once (2 passes).
"""


def _layers(cfg):
    """(kind, channels out, channels in, kernel, spatial out) of every
    convolution, in forward order, and the head."""
    size, c = cfg["image_size"], cfg["stem_channels"]
    out = [("conv", c, cfg["image_channels"], 3, size)]
    cin = c
    for i, (n, w) in enumerate(zip(cfg["stage_blocks"], cfg["stage_widths"])):
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            size //= stride
            out += [("conv", w, cin, 3, size), ("conv", w, w, 3, size)]
            if stride != 1 or cin != w:
                out.append(("conv", w, cin, 1, size))
            cin = w
    return out + [("fc", cfg["num_classes"], cin, 1, 1)]


def flops_per_sample(cfg) -> float:
    macs = sum(co * ci * k * k * s * s for _, co, ci, k, s in _layers(cfg))
    return 3 * 2.0 * macs


def _tapped_elements(cfg) -> int:
    """Elements of the 68 tapped maps of one sample."""
    size, c = cfg["image_size"], cfg["stem_channels"]
    total = 3 * c * size * size  # stem: conv, BatchNorm, ReLU
    cin = c
    for i, (n, w) in enumerate(zip(cfg["stage_blocks"], cfg["stage_widths"])):
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            size //= stride
            ds = stride != 1 or cin != w
            total += (9 if ds else 7) * w * size * size
            cin = w
    return total + cin + 2 * cfg["num_classes"]  # pool, head, logits


def _params(cfg) -> tuple[int, int]:
    """(all parameters, BatchNorm's)."""
    conv = sum(co * ci * k * k for kind, co, ci, k, _ in _layers(cfg) if kind == "conv")
    bn_channels = cfg["stem_channels"]
    cin = cfg["stem_channels"]
    for i, (n, w) in enumerate(zip(cfg["stage_blocks"], cfg["stage_widths"])):
        for j in range(n):
            ds = (i > 0 and j == 0) or cin != w
            bn_channels += (3 if ds else 2) * w
            cin = w
    fc = cfg["num_classes"] * (cin + 1)
    return conv + fc + 2 * bn_channels, 2 * bn_channels


def compression(cfg, mix) -> list[tuple[str, int, str, int]]:
    """``(structure, elements a step on one chip, element type, passes)``;
    empty when the cell compresses nothing."""
    if not mix["compress"]:
        return []
    rows = mix["batch"] // mix["chips"]
    maps = rows * _tapped_elements(cfg)
    params, bn = _params(cfg)
    dt = mix["compute_dtype"]
    return [("forward_maps", maps, dt, 2), ("gradient_maps", maps, dt, 2),
            ("gradients", params, "float32", 2), ("weights", params - bn, "float32", 2),
            ("momentum", params, "float32", 2)]
