"""The reference's first training steps of a cell, from the benchmark's
weights and batches.

``follow`` runs ``steps`` steps on one device and returns what the
comparison reads: each step's loss, the first step's raw gradient norms
by leaf, the first momentum buffer (SGD's trace, Adam's mu) after the
first step, which holds the first gradient as the optimizer got it, the
parameters after the last step and after each step count in ``keep_at``.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from port_bench.reference.keys import step_key
from port_bench.reference.optim import Hyper, init_state, step as optim_step
from port_bench.reference.smaq import SmaQ
from port_bench.reference.step import Step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_of(cfg: dict):
    """The reference module of a configuration: ``reference/<reference_model>.py``
    (``param_shapes``, ``forward``, ``loss``)."""
    return importlib.import_module(f"port_bench.reference.{cfg['reference_model']}")


@contextlib.contextmanager
def products(precision: str):
    """Float32 convolutions and matrix products in full float32, or on the
    TF32 path for the ``tf32`` control; bfloat16 products accumulate in
    float32; every kernel deterministic (cuDNN's and cuBLAS's
    deterministic algorithms, which ``CUBLAS_WORKSPACE_CONFIG`` set before
    the first cuBLAS call allows), so that a run gives the same bits
    again."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cuda.matmul.allow_bf16_reduced_precision_reduction, b.cudnn.deterministic,
             b.cudnn.benchmark, torch.are_deterministic_algorithms_enabled())
    tf32 = precision == "tf32"
    b.cuda.matmul.allow_tf32 = tf32
    b.cudnn.allow_tf32 = tf32
    b.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
         b.cuda.matmul.allow_bf16_reduced_precision_reduction, b.cudnn.deterministic,
         b.cudnn.benchmark) = saved[:5]
        torch.use_deterministic_algorithms(saved[5])


def loss_of(model, logits, labels, half_batch: bool = False):
    """The model's loss; ``half_batch`` (a planted fault) takes it over the
    first half of the rows."""
    if half_batch:
        half = labels.shape[0] // 2
        logits, labels = logits[:half], labels[:half]
    return model.loss(logits, labels)


def follow(cfg: dict, hp: Hyper, smaq: SmaQ | None, dtype: str, seed: int, params0: dict,
           batches: list, steps: int, precision: str, half_batch: bool = False,
           keep_at: tuple = ()) -> dict:
    """``steps`` reference steps from ``params0`` on the prepared
    ``batches`` (model inputs, labels); ``precision`` is ``dtype`` or the
    control's (``tf32``, ``fp8``); ``params_at`` holds the parameters after
    each step count of ``keep_at``."""
    model = model_of(cfg)
    device = next(iter(params0.values())).device
    params = {k: v.clone() for k, v in params0.items()}
    state = init_state(hp, params)
    losses, grad_norms, first, params_at = [], None, None, {}
    with products(precision):
        for s in range(steps):
            key = step_key(seed, s)
            ctx = Step(key, smaq, device, precision)
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            x, y = batches[s]
            loss = loss_of(model, model.forward(cfg, leaves, x, ctx, DTYPES[dtype]), y, half_batch)
            loss.backward()
            grads = {k: v.grad for k, v in leaves.items()}
            if grad_norms is None:
                grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
            losses.append(float(loss.detach()))
            with torch.no_grad():
                params, state = optim_step(
                    hp, {k: v.detach() for k, v in leaves.items()}, grads, state, s, smaq,
                    ctx.counter.leaf_calls(list(params)), ctx.noise, cfg["weight_exempt"])
            if first is None:
                first = state[hp.buffers()[0][0]]
            if s + 1 in keep_at:
                params_at[s + 1] = params
            del leaves, grads, loss
    return {"losses": losses, "grad_norms": grad_norms, "first_buffer": first, "params": params,
            "params_at": params_at}

