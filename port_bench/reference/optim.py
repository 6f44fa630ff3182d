"""SGD with momentum and AdamW in optax's order, with SmaQ on the
gradients, the weights and the momentum buffers, in plain PyTorch.

One step, over a dict of float32 leaves in parameter order:

1. every gradient is quantized (stage ``grad``);
2. the update: SGD's ``trace = g + momentum * trace``, ``p - lr * trace``
   (no weight decay); AdamW's ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2)
   g^2 + b2 nu``, ``u = (mu / c1) / (sqrt(nu / c2) + eps) + wd * p``, ``p -
   lr * u`` with the bias corrections ``c = 1 - b^t``;
3. every weight but the BatchNorm leaves is quantized (stage ``weight``);
4. every momentum buffer is quantized (stages ``trace``, or ``mu`` then
   ``nu``, which is clamped at zero).

``-lr`` and the bias corrections are float32 scalars on the device, as a
step replayed from device memory reads them.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from port_bench.reference.smaq import quantize


@dataclasses.dataclass(frozen=True)
class Hyper:
    kind: str  # "sgd" | "adamw"
    lr: float
    momentum: float = 0.9
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def buffers(self) -> tuple[tuple[str, bool], ...]:
        """(buffer, all_positive) of each momentum buffer."""
        return (("trace", False),) if self.kind == "sgd" else (("mu", False), ("nu", True))

    def scalars(self, count: int, device) -> torch.Tensor:
        if self.kind == "sgd":
            vals = (-self.lr, 1.0, 1.0)
        else:
            vals = (-self.lr, 1.0 - self.b1 ** (count + 1), 1.0 - self.b2 ** (count + 1))
        return torch.tensor(vals, dtype=torch.float32, device=device)


def init_state(hp: Hyper, params: dict) -> dict:
    return {name: {k: torch.zeros_like(p) for k, p in params.items()}
            for name, _ in hp.buffers()}


def step(hp: Hyper, params: dict, grads: dict, state: dict, count: int, smaq, calls,
         noise, exempt: str) -> tuple[dict, dict]:
    """One optimizer step; ``calls(stage, leaf)`` is the draw number of a
    compressor call, ``noise(call)`` its rounding noise, ``exempt`` the
    pattern of the leaves kept out of weight quantization.  Returns the new
    parameters and state."""
    def q(stage, name, x, all_positive=False):
        if smaq is None:
            return x
        return quantize(x, noise(calls(stage, name)), smaq, all_positive)

    grads = {k: q("grad", k, g) for k, g in grads.items()}
    neg_lr, c1, c2 = hp.scalars(count, next(iter(params.values())).device)
    updates, new = {}, {}
    if hp.kind == "sgd":
        new["trace"] = {}
        for k, g in grads.items():
            t = torch.add(g, state["trace"][k], alpha=hp.momentum)
            new["trace"][k] = t
            updates[k] = t * neg_lr
    else:
        new["mu"], new["nu"] = {}, {}
        for k, g in grads.items():
            mu = (1.0 - hp.b1) * g + hp.b1 * state["mu"][k]
            nu = (1.0 - hp.b2) * (g * g) + hp.b2 * state["nu"][k]
            u = (mu / c1) / ((nu / c2).sqrt() + hp.eps)
            if hp.weight_decay:
                u = u + hp.weight_decay * params[k]
            new["mu"][k], new["nu"][k] = mu, nu
            updates[k] = u * neg_lr
    params = {k: p + updates[k] for k, p in params.items()}
    params = {k: p if re.search(exempt, k) else q("weight", k, p) for k, p in params.items()}
    for name, all_positive in hp.buffers():
        new[name] = {k: q(name, k, v, all_positive) for k, v in new[name].items()}
    return params, new
