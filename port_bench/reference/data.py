"""A training batch as the model takes it, worked out from the raw batch.

CIFAR: the standard augmentation (a random crop of the image padded by 4
pixels, a random horizontal flip), drawn on the device from a generator
of the run's seed, batch after batch; then the per-channel
standardization with CIFAR-10's mean and std, and NHWC to NCHW.  Text
batches go to the model as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.247, 0.243, 0.261)


def augment(batch_u8: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    n, h, w, _ = batch_u8.shape
    dev = batch_u8.device
    padded = F.pad(batch_u8, (0, 0, 4, 4, 4, 4))
    off = torch.randint(0, 9, (n, 2), generator=gen, device=dev)
    flip = torch.rand(n, generator=gen, device=dev) < 0.5
    rows = off[:, :1] + torch.arange(h, device=dev)
    cols = off[:, 1:] + torch.arange(w, device=dev)
    cols = torch.where(flip[:, None], cols.flip(1), cols)
    idx = torch.arange(n, device=dev)[:, None, None]
    return padded[idx, rows[:, :, None], cols[:, None, :]]


def normalize(batch_u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CIFAR_MEAN, dtype=torch.float32, device=batch_u8.device)
    std = torch.tensor(CIFAR_STD, dtype=torch.float32, device=batch_u8.device)
    return (batch_u8.to(torch.float32) / 255.0 - mean) / std


class Prepare:
    """The model's inputs of successive raw batches of one run, by the
    configuration's ``prepare``: ``cifar_augment`` or ``none``."""

    def __init__(self, kind: str, seed: int, device):
        if kind not in ("cifar_augment", "none"):
            raise ValueError(f"no batch preparation {kind!r}")
        self.kind = kind
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, x, y):
        if self.kind == "none":
            return x, y
        return normalize(augment(x, self.gen)).permute(0, 3, 1, 2).contiguous(), y
