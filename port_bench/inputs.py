"""The benchmark's inputs and initial weights, made on the device from the
seed, the same for the program and for the reference.

A mix's ``inputs`` object names a generator (``kind``) and its
parameters; every batch of a run comes from a pool of ``pool_batches``
batches, taken in turn.

- ``cifar``: uint8 NHWC images and int32 labels, class-separable as the
  program's synthetic CIFAR is: ``(noise + label * class_shift) // 2``;
- ``stsb``: sentence pairs ``[CLS] a [SEP] b [SEP]`` of ``sentence_tokens``
  tokens each (drawn per pair), word ids in ``[word_ids_from, vocab)``,
  padded to ``length``, with their attention mask, token types and a
  float label uniform in ``label_range``.

Weights follow the configuration's ``init`` rules (the first rule whose
pattern matches a leaf's name): every normal leaf comes from one draw and
every uniform leaf from another, then each is scaled to its rule.
"""

from __future__ import annotations

import math
import re

import torch

CLS, SEP, PAD = 101, 102, 0


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _cifar(p: dict, n: int, gen: torch.Generator, device):
    size, ch = p["image_size"], p["channels"]
    y = torch.randint(0, p["classes"], (n,), generator=gen, device=device, dtype=torch.int32)
    x = torch.randint(0, 256, (n, size, size, ch), generator=gen, device=device,
                      dtype=torch.int32)
    x = ((x + (y * p["class_shift"])[:, None, None, None]) // 2).to(torch.uint8)
    return x, y


def _stsb(p: dict, n: int, gen: torch.Generator, device):
    length = p["length"]
    lo, hi = p["sentence_tokens"]
    la = torch.randint(lo, hi + 1, (n, 1), generator=gen, device=device)
    lb = torch.randint(lo, hi + 1, (n, 1), generator=gen, device=device)
    words = torch.randint(p["word_ids_from"], p["vocab"], (n, length), generator=gen,
                          device=device)
    pos = torch.arange(length, device=device)[None]
    end_a, end = la + 1, la + lb + 2
    ids = torch.where((pos == end_a) | (pos == end), SEP, words)
    ids = torch.where(pos == 0, CLS, ids)
    real = pos <= end
    ids = torch.where(real, ids, PAD).to(torch.int32)
    types = ((pos > end_a) & real).to(torch.int32)
    r0, r1 = p["label_range"]
    labels = r0 + (r1 - r0) * torch.rand(n, generator=gen, device=device)
    return {"input_ids": ids, "attention_mask": real.to(torch.int32),
            "token_type_ids": types}, labels


KINDS = {"cifar": _cifar, "stsb": _stsb}


class Pool:
    """``pool_batches`` batches of ``batch`` rows made from ``seed``."""

    def __init__(self, inputs: dict, batch: int, seed: int, device):
        self.n = inputs["pool_batches"]
        x, y = KINDS[inputs["kind"]](inputs, self.n * batch, generator(seed, device), device)
        self.batch = batch
        self.x, self.y = x, y

    def __getitem__(self, i: int):
        j = i % self.n
        rows = slice(j * self.batch, (j + 1) * self.batch)
        if isinstance(self.x, dict):
            return {k: v[rows] for k, v in self.x.items()}, self.y[rows]
        return self.x[rows], self.y[rows]


def _scale(rule: dict, shape: tuple[int, ...]) -> float:
    if "std" in rule:
        return rule["std"]
    if rule.get("std_rule") == "kaiming_fan_out":
        return math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
    if rule.get("bound_rule") == "inv_sqrt_fan_in":
        return 1.0 / math.sqrt(shape[1])
    raise ValueError(f"no scale in init rule {rule}")


def weights(cfg: dict, shapes: list, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 initial weights ``{name: tensor}`` in the order of
    ``shapes`` (``(name, shape)`` pairs)."""
    rules = []
    for name, shape in shapes:
        rule = next((r for r in cfg["init"] if re.search(r["match"], name)), None)
        if rule is None:
            raise ValueError(f"no init rule of {cfg['name']} matches {name}")
        rules.append(rule)
    gen = generator(seed, device)

    def total(dist):
        return sum(math.prod(s) for (_, s), r in zip(shapes, rules) if r["dist"] == dist)

    draws = {"normal": torch.empty(total("normal"), device=device).normal_(generator=gen),
             "uniform": torch.empty(total("uniform"), device=device).uniform_(-1.0, 1.0,
                                                                             generator=gen)}
    out, used = {}, {"normal": 0, "uniform": 0}
    for (name, shape), rule in zip(shapes, rules):
        n, dist = math.prod(shape), rule["dist"]
        if dist in draws:
            flat = draws[dist][used[dist]:used[dist] + n] * _scale(rule, shape)
            used[dist] += n
            out[name] = flat.view(shape)
        elif dist in ("zeros", "ones"):
            out[name] = torch.full(shape, 0.0 if dist == "zeros" else 1.0, device=device)
        else:
            raise ValueError(f"unknown init {dist!r}")
    return out
