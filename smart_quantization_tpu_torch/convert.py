"""Carry parameter trees over to the port's ``state_dict`` layout.

The JAX package's flax trees (ResNet, Inception-v3, TinyCNN, BERT) arrive
as nested dicts of numpy arrays:

- conv ``kernel`` HWIO -> ``weight`` OIHW (Inception's 1x7, 7x1, 1x3 and
  3x1 kernels alike);
- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Embed ``embedding`` -> ``weight``, as it is;
- LayerNorm ``scale`` -> ``weight``;
- the flax submodule levels the port's tapped modules hold as their own
  parameters fold away: ``bn`` (``TappedBatchNorm``), ``dense``
  (``TappedDense``) and ``norm`` (``TappedLayerNorm``); Inception's
  ``BasicConv2d`` keeps its ``conv`` and ``bn`` levels, so its
  ``.../bn/bn/scale`` lands on ``....bn.weight``;
- ``batch_stats`` ``bn/{mean, var}`` -> ``{running_mean, running_var}``.

Optimizer trees shaped like the params (SGD's trace, Adam's mu and nu) map
the same way with :func:`tree_from_jax`.  :func:`jax_axes` is the way
back for one leaf: the permutation that lays a port leaf out as the JAX
package's (the optimizer's row-wise codecs take rows on JAX's leading
axis).

:func:`load_pretrained` maps a locally cached HF ``BertModel`` onto the
port's BERT (the counterpart of JAX ``models/bert.py::
load_pretrained_params`` and ``convert_torch_state_dict``).
"""

from __future__ import annotations

import numpy as np
import torch

_LEAF_NAMES = {
    "kernel": "weight",
    "scale": "weight",
    "embedding": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}
# flax submodules whose parameters the port's module holds itself
_FOLDED = ("bn", "dense", "norm")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(path: tuple[str, ...], value) -> tuple[str, torch.Tensor]:
    *mods, leaf = path
    if mods and mods[-1] in _FOLDED:
        mods = mods[:-1]
    arr = np.asarray(value, np.float32)
    if leaf == "kernel" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and arr.ndim == 2:
        arr = arr.T
    name = ".".join([*mods, _LEAF_NAMES[leaf]])
    return name, torch.from_numpy(np.array(arr, copy=True))


def jax_axes(name: str, ndim: int) -> tuple[int, ...]:
    """The permutation that lays the port's leaf ``name`` out as the JAX
    package's leaf (``leaf.permute(jax_axes(name, leaf.dim()))``), the
    inverse of :func:`_convert_leaf`'s transposes: a 4-D conv weight OIHW
    -> HWIO, a 2-D Dense weight (out, in) -> (in, out); an embedding table
    (a 2-D leaf of a module named ``*embeddings``) and every other leaf
    keep their axes."""
    if ndim == 4:
        return (2, 3, 1, 0)
    if ndim == 2 and not name.rsplit(".", 1)[0].endswith("embeddings"):
        return (1, 0)
    return tuple(range(ndim))


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


def bert_state_dict_from_hf(sd, num_layers: int, num_labels: int) -> dict[str, torch.Tensor]:
    """An HF ``BertModel.state_dict()`` (``embeddings.*``,
    ``encoder.layer.N.*``, ``pooler.dense.*``) as the port's BERT
    ``state_dict``.  torch Linear weights are (out, in) on both sides; the
    classifier is fresh zeros, as the JAX package's import leaves it."""

    def t(k):
        return torch.as_tensor(np.asarray(sd[k], np.float32)).clone()

    out = {
        "word_embeddings.weight": t("embeddings.word_embeddings.weight"),
        "position_embeddings.weight": t("embeddings.position_embeddings.weight"),
        "token_type_embeddings.weight": t("embeddings.token_type_embeddings.weight"),
        "embeddings_norm.weight": t("embeddings.LayerNorm.weight"),
        "embeddings_norm.bias": t("embeddings.LayerNorm.bias"),
        "pooler.weight": t("pooler.dense.weight"),
        "pooler.bias": t("pooler.dense.bias"),
    }
    hidden = out["pooler.weight"].shape[0]
    out["classifier.weight"] = torch.zeros(num_labels, hidden)
    out["classifier.bias"] = torch.zeros(num_labels)
    for i in range(num_layers):
        e = f"encoder.layer.{i}"
        for ours, theirs in (
            ("attention.query", "attention.self.query"),
            ("attention.key", "attention.self.key"),
            ("attention.value", "attention.self.value"),
            ("attention.output", "attention.output.dense"),
            ("attention.output_norm", "attention.output.LayerNorm"),
            ("intermediate", "intermediate.dense"),
            ("ffn_output", "output.dense"),
            ("ffn_norm", "output.LayerNorm"),
        ):
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{ours}.{leaf}"] = t(f"{e}.{theirs}.{leaf}")
    return out


def load_pretrained(model_name: str, num_layers: int, num_labels: int):
    """The port's BERT ``state_dict`` from a locally cached HF
    ``BertModel``, or None (fresh init) when ``transformers`` or the local
    copy is missing.  Nothing is downloaded."""
    from smart_quantization_tpu_torch.data.text import hub_cached

    try:
        if not hub_cached(model_name):
            raise FileNotFoundError(model_name)
        from transformers import BertModel

        hf = BertModel.from_pretrained(model_name, local_files_only=True)
    except (ImportError, OSError, ValueError) as e:
        print(f"pretrained {model_name!r} unavailable offline ({type(e).__name__}); "
              "using fresh init")
        return None
    return bert_state_dict_from_hf(hf.state_dict(), num_layers, num_labels)
