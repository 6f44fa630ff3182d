"""Compressed checkpoints: every large float leaf of a tree stored as a
bit-packed SmaQ buffer (``ops/pack.py``).

The counterpart of ``smart_quantization_tpu/train/checkpoint.py``, with
``torch.save`` in place of orbax.  A tree is a nested dict of tensors and
Python values; float leaves of ``_MIN_PACK_ELEMS`` or more
elements are packed (b_main-bit codes, flag bits, the capped outlier
stream and two float32 stats) and unpacked on restore, with the same
round-trip error as the in-training fake quantization; the rest are kept
raw.  This is a lossy archive format; the trainer's own checkpoints
(``Trainer.save_checkpoint``) are exact.
"""

from __future__ import annotations

from typing import Any

import torch

from smart_quantization_tpu_torch.ops.pack import PackedSmaQ, PackSpec, smaq_pack, smaq_unpack

_MIN_PACK_ELEMS = 256  # smaller leaves stay raw


def _is_packable(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.numel() >= _MIN_PACK_ELEMS)


def _map(tree: Any, fn, is_leaf=lambda _: False) -> Any:
    """``fn`` over the leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: _map(v, fn, is_leaf) for k, v in tree.items()}
    return fn(tree)


def pack_tree(tree: Any, gen: torch.Generator | None, spec: PackSpec) -> Any:
    """Every large float leaf packed into a ``{"__packed__": ...}`` entry,
    every other leaf into ``{"__raw__": leaf}``; packed leaves draw from
    ``gen`` in leaf order."""

    def one(leaf):
        if not _is_packable(leaf):
            return {"__raw__": leaf}
        p = smaq_pack(leaf, gen, spec)
        return {"__packed__": True, "main": p.main, "flags": p.flags,
                "outliers": p.outliers, "mean": p.mean, "std": p.std,
                "shape": list(leaf.shape), "dtype": str(leaf.dtype).removeprefix("torch.")}

    return _map(tree, one)


def unpack_tree(packed_tree: Any, spec: PackSpec) -> Any:
    def is_entry(d):
        return isinstance(d, dict) and ("__packed__" in d or "__raw__" in d)

    def one(d):
        if "__raw__" in d:
            return d["__raw__"]
        shape = tuple(d["shape"])
        n = 1
        for s in shape:
            n *= s
        p = PackedSmaQ(d["main"], d["flags"], d["outliers"], d["mean"], d["std"],
                       torch.zeros(()))
        return smaq_unpack(p, n, spec).reshape(shape).to(getattr(torch, d["dtype"]))

    return _map(packed_tree, one, is_entry)


def save_compressed(path: str, state: Any, gen: torch.Generator | None,
                    spec: PackSpec = PackSpec()) -> None:
    torch.save(pack_tree(state, gen, spec), path)


def restore_compressed(path: str, spec: PackSpec = PackSpec()) -> Any:
    return unpack_tree(torch.load(path, weights_only=True), spec)


def tree_nbytes(tree: Any) -> int:
    """Bytes of the tensor leaves of a tree."""
    total = 0

    def add(leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        return leaf

    _map(tree, add)
    return total
