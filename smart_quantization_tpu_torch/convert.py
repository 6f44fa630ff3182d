"""Carry flax parameter trees over to the port's ``state_dict`` layout.

The JAX package's trees arrive as nested dicts of numpy arrays:

- conv ``kernel`` HWIO -> ``weight`` OIHW;
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- BatchNorm ``bn/{scale, bias}`` -> ``{weight, bias}`` of the port's
  ``TappedBatchNorm`` (the flax ``bn`` submodule level folds away), and
  ``batch_stats`` ``bn/{mean, var}`` -> ``{running_mean, running_var}``.

Optimizer trees shaped like the params (SGD's trace, Adam's mu and nu) map
the same way with :func:`tree_from_jax`.
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF_NAMES = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(path: tuple[str, ...], value) -> tuple[str, torch.Tensor]:
    *mods, leaf = path
    if mods and mods[-1] == "bn":  # TappedBatchNorm's inner flax BatchNorm
        mods = mods[:-1]
    arr = np.asarray(value, np.float32)
    if leaf == "kernel" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and arr.ndim == 2:
        arr = arr.T
    name = ".".join([*mods, _LEAF_NAMES[leaf]])
    return name, torch.from_numpy(np.array(arr, copy=True))


def tree_from_jax(tree) -> dict[str, torch.Tensor]:
    """A flax-shaped tree (params, or an optimizer tree shaped like them)
    as a flat ``{state_dict name: tensor}`` dict."""
    return dict(_convert_leaf(p, v) for p, v in _flatten(tree))


def params_from_jax(params_np, batch_stats_np=None) -> dict[str, torch.Tensor]:
    """``params`` (+ ``batch_stats``) of a flax model as a ``state_dict``."""
    out = tree_from_jax(params_np)
    if batch_stats_np:
        out.update(tree_from_jax(batch_stats_np))
    return out
