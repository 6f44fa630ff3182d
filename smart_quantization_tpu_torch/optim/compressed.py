"""Low-precision optimizer step: quantize gradients, weights and momentum
around the real (fp32) optimizer math.

Counterpart of the per-tensor core of
``smart_quantization_tpu/optim/compressed.py``:

- gradients are quantized (tag ``optimizer_grad``) before the update, after
  the optional ``grad_scaling``;
- the updated weights are quantized (tag ``optimizer_weight``) except the
  BatchNorm leaves (:func:`norm_param_mask`);
- the momentum buffers are quantized (tag ``optimizer_momentum``): SGD's
  trace, Adam's ``mu`` and, with ``all_positive``, ``nu``.

The optimizers are written with tensor ops in optax's order (SGD: coupled
weight decay -> ``trace(decay=momentum)`` -> ``-lr``; Adam: coupled decay
-> ``scale_by_adam`` -> ``-lr``; AdamW: ``scale_by_adam`` -> decoupled
decay -> ``-lr``), so the momentum buffers are plain tensors the step can
quantize.  Parameters, gradients and buffers are flat ``{name: tensor}``
dicts keyed by ``state_dict`` names.  Each compressor call draws its own
seed from the step's generator, in leaf order.

The packed, row-wise, log-nu and master-weight branches of the JAX package
are still to be ported (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from smart_quantization_tpu_torch.compress.base import CompressorBase

Tree = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerCompression:
    compressor: CompressorBase | None = None
    compress_weights: bool = True
    compress_gradients: bool = True
    compress_momentum: bool = True
    grad_scaling: float = 1.0

    @property
    def active(self) -> bool:
        return self.compressor is not None and (
            self.compress_weights or self.compress_gradients or self.compress_momentum
        )


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """SGD / Adam / AdamW; ``learning_rate`` is a float or a schedule of the
    optimizer's step count."""

    kind: str  # 'sgd' | 'adam' | 'adamw'
    learning_rate: float | Callable[[int], float] = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    @property
    def has_momentum(self) -> bool:
        return self.kind != "sgd" or self.momentum != 0.0

    @property
    def momentum_buffers(self) -> tuple[tuple[str, bool], ...]:
        """(buffer name, all_positive) of each momentum tree in the state."""
        return (("trace", False),) if self.kind == "sgd" else (("mu", False), ("nu", True))

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self, params: Tree) -> dict:
        state = {"count": 0}
        for name, _ in self.momentum_buffers:
            state[name] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    def update(self, grads: Tree, state: dict, params: Tree) -> tuple[Tree, dict]:
        count = state["count"]
        lr = self.lr(count)
        wd = self.weight_decay
        updates: Tree = {}
        new_state = {"count": count + 1}
        if self.kind == "sgd":
            trace = {}
            for k, g in grads.items():
                if wd:
                    g = g + wd * params[k]
                trace[k] = torch.add(g, state["trace"][k], alpha=self.momentum)
                updates[k] = trace[k] * -lr
            new_state["trace"] = trace
            return updates, new_state
        if self.kind not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {self.kind!r} (sgd|adam|adamw)")
        mu, nu = {}, {}
        c1 = 1.0 - self.b1 ** (count + 1)
        c2 = 1.0 - self.b2 ** (count + 1)
        for k, g in grads.items():
            if wd and self.kind == "adam":
                g = g + wd * params[k]
            mu[k] = (1.0 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            u = (mu[k] / c1) / ((nu[k] / c2).sqrt() + self.eps)
            if wd and self.kind == "adamw":
                u = u + wd * params[k]
            updates[k] = u * -lr
        new_state["mu"], new_state["nu"] = mu, nu
        return updates, new_state


def build_optimizer(
    name: str,
    learning_rate: float | Callable[[int], float] = 0.1,
    *,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    beta1: float | None = None,
    beta2: float | None = None,
    epsilon: float | None = None,
) -> OptimizerSpec:
    """SGD / Adam / AdamW with the JAX package's defaults (lr 0.1, momentum
    0.9, wd 0)."""
    if name not in ("sgd", "adam", "adamw"):
        raise ValueError(f"unknown optimizer {name!r} (sgd|adam|adamw)")
    return OptimizerSpec(
        kind=name,
        learning_rate=learning_rate,
        momentum=momentum,
        weight_decay=weight_decay,
        b1=0.9 if beta1 is None else beta1,
        b2=0.999 if beta2 is None else beta2,
        eps=1e-8 if epsilon is None else epsilon,
    )


def norm_param_mask(names) -> dict[str, bool]:
    """True for leaves of BATCH-norm layers (exempt from weight
    compression); the port's models name them ``bn*``."""
    return {n: any("bn" in part.lower() for part in n.split(".")) for n in names}


def _quantize_tree(tree: Tree, gen, compressor, *, skip=None, all_positive=False):
    """Quantize every non-skipped leaf; returns (tree, orig_bits, new_bits)
    with the bit totals as 0-d device tensors."""
    out, origs, news = {}, [], []
    for k, leaf in tree.items():
        if skip is not None and skip.get(k, False):
            out[k] = leaf
            continue
        out[k], stats = compressor(leaf, gen, all_positive=all_positive)
        origs.append(stats.orig_bits)
        news.append(stats.new_bits)
    if not origs:
        zero = torch.zeros((), device=next(iter(tree.values())).device)
        return out, zero, zero
    return out, torch.stack(origs).sum(), torch.stack(news).sum()


def compressed_optimizer_step(
    spec: OptimizerSpec,
    params: Tree,
    grads: Tree,
    opt_state: dict,
    gen: torch.Generator | None,
    compression: OptimizerCompression,
    *,
    weight_exempt: dict[str, bool] | None = None,
) -> tuple[Tree, dict, dict[str, torch.Tensor]]:
    """One optimizer step with compression; returns ``(params, opt_state,
    metrics)``, metrics mapping ``optimizer_{grad,weight,momentum}`` to
    (2,) ``[orig_bits, new_bits]`` device tensors."""
    metrics: dict[str, torch.Tensor] = {}
    comp = compression.compressor
    active = compression.active

    if active and compression.compress_gradients:
        if compression.grad_scaling != 1.0:
            grads = {k: g * compression.grad_scaling for k, g in grads.items()}
        grads, o, n = _quantize_tree(grads, gen, comp)
        metrics["optimizer_grad"] = torch.stack([o, n])

    updates, opt_state = spec.update(grads, opt_state, params)
    params = {k: p + updates[k] for k, p in params.items()}

    if active and compression.compress_weights:
        params, o, n = _quantize_tree(params, gen, comp, skip=weight_exempt)
        metrics["optimizer_weight"] = torch.stack([o, n])

    if active and compression.compress_momentum and spec.has_momentum:
        origs, news = [], []
        for name, all_positive in spec.momentum_buffers:
            opt_state[name], o, n = _quantize_tree(
                opt_state[name], gen, comp, all_positive=all_positive
            )
            origs.append(o)
            news.append(n)
        metrics["optimizer_momentum"] = torch.stack(
            [torch.stack(origs).sum(), torch.stack(news).sum()]
        )
    return params, opt_state, metrics
