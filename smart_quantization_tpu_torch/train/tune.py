"""Auto-tuning: the learning-rate range test and the batch-size scaler.

Counterpart of ``smart_quantization_tpu/train/tune.py`` (the reference's
Lightning ``trainer.tune``, ``--auto_lr_find`` and
``--auto_scale_batch_size``):

- :func:`auto_lr_find` runs the trainer's own step for ``num_steps`` steps
  at an exponentially rising learning rate and suggests the one at the
  steepest descent of the smoothed loss curve (:func:`suggest_from_losses`,
  Lightning's heuristic, a numpy copy of JAX's).  The rate is a schedule of
  the optimizer's count, so each step's rate rides in its device row
  (``OptimizerSpec.step_scalars``) and the test runs under
  ``--steps_per_call`` as the training does;
- :func:`auto_scale_batch_size` doubles the batch size until a step runs
  out of memory (``torch.cuda.OutOfMemoryError`` on the card), then
  releases the failed trial's memory and returns the largest size that ran.

Both probe the trainer inside :func:`probing`, which puts back everything a
step changes: the model's parameters and buffers, the augmentation
generator, the optimizer spec, and every cached step function, the K-step
and eval CUDA graphs included.  As in the JAX package, the probe's
optimizer keeps only the optimizer's kind: ``--momentum``,
``--weight_decay`` and the betas fall back to their defaults
(``build_optimizer(kind, schedule)``, JAX ``tune.py:67``), and
:func:`tune_from_args` then trains at a constant learning rate, dropping
any ``--scheduler_type multi_step`` schedule (JAX ``train.py:124-131``).
Both are JAX-side faults the port reproduces (ROADMAP Queue 3).  The probe
starts from the model's own initial weights, where JAX's draws a fresh
initialization from the seed plus 999.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable

import numpy as np
import torch

from smart_quantization_tpu_torch.optim.compressed import build_optimizer
from smart_quantization_tpu_torch.train.graph import stack_outputs, tree_map


def lr_range_schedule(min_lr: float, max_lr: float, num_steps: int) -> Callable[[int], float]:
    """``min_lr`` at count 0 rising geometrically to ``max_lr`` at count
    ``num_steps - 1`` (and held there)."""
    ratio = max_lr / min_lr

    def sched(step: int) -> float:
        frac = min(step / max(num_steps - 1, 1), 1.0)
        return min_lr * ratio**frac

    return sched


def suggest_from_losses(lrs: np.ndarray, losses: np.ndarray) -> float:
    """Steepest-descent point of the smoothed loss curve (skip edges)."""
    losses = np.asarray(losses, np.float64)
    finite = np.isfinite(losses)
    if finite.sum() < 5:
        return float(lrs[0])
    # exponential smoothing
    smoothed = []
    acc, beta = 0.0, 0.8
    for i, v in enumerate(np.where(finite, losses, np.nanmax(losses[finite]))):
        acc = beta * acc + (1 - beta) * v
        smoothed.append(acc / (1 - beta ** (i + 1)))
    smoothed = np.array(smoothed)
    grads = np.gradient(smoothed)
    lo, hi = max(1, len(grads) // 10), len(grads) - max(1, len(grads) // 10)
    idx = lo + int(np.argmin(grads[lo:hi]))
    return float(lrs[idx])


@contextlib.contextmanager
def probing(trainer):
    """Run trial steps on ``trainer`` and put it back as it was: its
    parameters (their own tensors, so packed weights' released views come
    back too, with their values) and buffers, its augmentation generator,
    its optimizer spec and its cached K-step and eval graphs (a trial's
    graphs are let go, which frees their memory pools).  No tensor made
    during the trials outlives them, so a caching allocator emptied
    afterwards gives all of their memory back."""
    params = [(p, p.data, p.data.clone()) for p in trainer.model.parameters()]
    buffers = [(b, b.clone()) for b in trainer.model.buffers()]
    gen_state = trainer.data_gen.get_state()
    saved = {k: getattr(trainer, k) for k in (
        "spec", "_train_graph", "_train_graph_of", "_eval_graph", "_eval_graph_of")}
    try:
        yield trainer
    finally:
        with torch.no_grad():
            for p, data, v in params:
                p.data = data
                data.copy_(v)
            for b, v in buffers:
                b.copy_(v)
        trainer.data_gen.set_state(gen_state)
        for k, v in saved.items():
            setattr(trainer, k, v)


def auto_lr_find(trainer, *, min_lr: float = 1e-6, max_lr: float = 1.0,
                 num_steps: int = 50) -> float:
    """The learning-rate range test with the trainer's model, data,
    compression and ``--steps_per_call``; returns the suggested rate."""
    sched = lr_range_schedule(min_lr, max_lr, num_steps)
    k = trainer.cfg.steps_per_call
    epochs = 1 + num_steps // max(trainer.data.steps_per_epoch, 1)
    with probing(trainer):
        trainer.spec = build_optimizer(trainer.spec.kind, sched)
        trainer._train_graph = trainer._train_graph_of = None
        state = trainer.init_state()
        losses, group = [], []

        def run(group):
            # a whole group of K through the graph, a shorter one singly
            if k > 1 and len(group) == k:
                out = trainer.train_steps(state, group)
            else:
                out = stack_outputs([trainer.train_step(state, x, y) for x, y in group])
            losses.extend(out["train_loss"].tolist())

        for epoch in range(epochs):
            for inputs, labels in trainer.data.device_train_batches(
                    trainer.cfg.seed + epoch, trainer.device):
                if len(losses) + len(group) >= num_steps:
                    break
                group.append(trainer.prepare_batch(inputs, labels))
                if len(group) == k:
                    run(group)
                    group = []
        if group:
            run(group)
    lrs = np.array([sched(i) for i in range(len(losses))])
    return suggest_from_losses(lrs, np.array(losses))


def trial_batch(trainer, size: int):
    """A prepared training batch of ``size`` examples: the first batch of
    the data repeated (its content does not matter, its memory does)."""
    inputs, labels = next(iter(trainer.data.device_train_batches(0, trainer.device)))
    idx = torch.arange(size, device=labels.device) % labels.shape[0]
    inputs = tree_map(lambda t: t.index_select(0, idx), inputs)
    return trainer.prepare_batch(inputs, labels.index_select(0, idx))


def auto_scale_batch_size(try_batch: Callable[[int], None], *, init_size: int = 8,
                          max_trials: int = 8) -> int:
    """Double the batch size until ``try_batch`` runs out of memory; return
    the largest size that worked.  Afterwards the trials' tensors are let
    go (the failed one's frames and autograd graph with them) and the
    caching allocator gives their memory back, so what runs next has the
    whole card.  Any other error propagates."""
    best = None
    size = init_size
    for _ in range(max_trials):
        try:
            try_batch(size)
        except torch.cuda.OutOfMemoryError:
            break
        best = size
        size *= 2
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if best is None:
        raise RuntimeError(f"even batch size {init_size} does not fit")
    return best


def scale_batch_size(trainer, init_size: int, max_trials: int = 8) -> int:
    """:func:`auto_scale_batch_size` with one training step of the trainer
    (a fresh optimizer state, put back afterwards) as the trial."""

    def try_batch(size: int) -> None:
        with probing(trainer):
            trainer._train_graph = trainer._train_graph_of = None
            trainer.train_step(trainer.init_state(), *trial_batch(trainer, size))
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)

    return auto_scale_batch_size(try_batch, init_size=init_size, max_trials=max_trials)


def tune_from_args(trainer, args) -> None:
    """What ``--auto_scale_batch_size`` and ``--auto_lr_find`` do before
    training, in the JAX package's order: the batch size found becomes the
    data's; the learning rate found replaces the optimizer's, as a constant
    (JAX drops the schedule too)."""
    if args.auto_scale_batch_size:
        best = scale_batch_size(trainer, args.batch_size)
        print(f"auto_scale_batch_size: {best}", flush=True)
        trainer.data.batch_size = best
    if args.auto_lr_find:
        lr = auto_lr_find(trainer)
        print(f"auto_lr_find suggestion: {lr:.3e}", flush=True)
        trainer.spec = build_optimizer(
            args.optimizer_type, lr, momentum=args.momentum, weight_decay=args.weight_decay,
            beta1=args.beta1, beta2=args.beta2, epsilon=args.epsilon)
        trainer._train_graph = trainer._train_graph_of = None
