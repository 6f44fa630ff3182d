"""The XLA-managed float32 FSDP step: one device's step on the whole global
batch, with the parameters and optimizer state sharded over ``fsdp``.

Counterpart of ``smart_quantization_tpu/parallel/train_fsdp.py``
(``make_fsdp_train_step``, ``state_shardings``, and ``place_state`` as
``FloatFSDPStep.init_state``).  The JAX
step is one ``jax.jit`` over the global arrays, the batch laid out over
``data`` and the state over ``fsdp``, XLA inserting the collectives, so
it computes what one device computes on the whole batch: every statistic
covers the whole batch or the whole leaf, unlike the ``shard_map`` paths
(``train_dp.py``, ``train_fsdp_q.py``), whose ranks normalize and quantize
their own rows.  Here, on a (data, fsdp) mesh of W ranks:

- rows: the step takes the global batch; each rank augments it whole from
  the step's shared key (a row's crop and flip are the ones one device
  gives it) and keeps rows ``[r B/W, (r+1) B/W)``;
- statistics: every BatchNorm and every tap, forward and backward, takes
  the whole batch's, through a ``StatsGroup`` on the tap context
  (``parallel/whole_batch.py``); the loss is the sum of the rows' cross
  entropy over B, so that a gradient map's rows are the single device's;
- parameters: each rank stores its ``FSDPLayout`` block of every leaf
  (``mesh.shard_dim``; a leaf that does not divide is replicated), and the
  step gathers them whole into the model in float32; the BatchNorm
  buffers are replicated;
- optimizer: the float32 gradients summed over the world; at fsdp 1 one
  ``compressed_optimizer_step`` on every leaf, as the trainer's; above, one
  leaf at a time its momentum (or Adam's state, and the master weights)
  gathered whole, the step on the whole leaf with that leaf's key, the
  same on every rank, and this rank's block kept: every rank holds what one
  device would, with one leaf's state in flight;
- metrics: the global batch's loss and accuracy; the taps' sizes summed
  over the ranks (``_ratio/{tag}`` pairs), the optimizer's counted once.

One device is a (1, 1) mesh, as in JAX.  Stochastic rounding draws a
tap's noise by the element's place in its rank's rows (the taps' key
folded with the rank from W = 2), and at fsdp > 1 the optimizer draws a
key for each leaf where one device draws one for the step; so only a
truncation step is the single device's (``Trainer.train_step``'s)
element by element (ROADMAP, Queue 3).  Packed state and ``--use_sample_stats`` raise
``WholeBatchError``; the JAX step has no ``--compress_loss``,
``avg_grad_norm`` or ``--steps_per_call``, and neither has this one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from smart_quantization_tpu_torch.compress.base import SizeTotals
from smart_quantization_tpu_torch.inject.tap import TapContext, own_key
from smart_quantization_tpu_torch.ops.keys import DeviceKey, key_tensor
from smart_quantization_tpu_torch.optim.compressed import (
    CompressedOptState,
    OptimizerCompression,
    OptimizerSpec,
    compressed_optimizer_step,
    init_opt_state,
    norm_param_mask,
)
from smart_quantization_tpu_torch.parallel.train_fsdp_q import FSDPLayout
from smart_quantization_tpu_torch.parallel.whole_batch import StatsGroup, WholeBatchError
from smart_quantization_tpu_torch.train.loop import float32_on_card
from smart_quantization_tpu_torch.train.state import TrainState
from smart_quantization_tpu_torch.train.task import ImageClassificationTask


def state_shardings(mesh, model: torch.nn.Module) -> dict[str, int]:
    """The dim of each parameter (and of its optimizer state) that the
    ``fsdp`` ranks shard, -1 where it is replicated."""
    return FSDPLayout({n: tuple(p.shape) for n, p in model.named_parameters()},
                      mesh.shape["fsdp"]).dims


def step_words(key: int) -> tuple[int, int, int]:
    """The seeds of a step's augmentation, taps and optimizer, from its
    key."""
    aug, fwd, opt = np.random.SeedSequence([key]).generate_state(3, np.uint64)
    return int(aug), int(fwd), int(opt)


def global_inputs(images_u8: torch.Tensor, key: int) -> torch.Tensor:
    """The model's input for the whole global batch ``images_u8`` (NHWC
    uint8) at step key ``key``: CIFAR's crop and flip from the step's
    augmentation generator (on the batch's device), then the normalization
    to NCHW.  Each rank of :class:`FloatFSDPStep` takes its rows of it."""
    gen = torch.Generator(device=images_u8.device)
    gen.manual_seed(step_words(key)[0])
    return ImageClassificationTask().prepare_train(images_u8, gen)


class FloatFSDPStep:
    """The step of :func:`make_fsdp_train_step` on one rank of its mesh:
    ``init_state()``, then ``step(state, images_u8, labels, key)``."""

    def __init__(self, model: torch.nn.Module, spec: OptimizerSpec,
                 optim_comp: OptimizerCompression, mesh):
        if optim_comp.packed_momentum or optim_comp.packed_weights:
            raise WholeBatchError("packed state is not taken by the whole-batch FSDP step "
                                  "(its codes would need whole-leaf codebooks sharded): use "
                                  "parallel/train_fsdp_q.py")
        if mesh is None:
            raise ValueError("the whole-batch step takes a (data, fsdp) mesh; one device is "
                             "make_mesh(1, 1)")
        self.model, self.spec, self.optim_comp, self.mesh = model, spec, optim_comp, mesh
        self.size, self.rank, self.fsdp_index = mesh.size, mesh.rank, mesh.fsdp_index
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.layout = FSDPLayout(shapes, mesh.shape["fsdp"])
        self.world = mesh.group(("data", "fsdp"))
        self.fsdp_group = mesh.group("fsdp")
        self.stats = StatsGroup(self.world, self.size)
        self.exempt = norm_param_mask(shapes)
        self.device = next(model.parameters()).device
        if self.device.type == "cuda":
            float32_on_card()  # the trainer's: no TF32, deterministic kernels

    # ------------------------------------------------------------ state
    def init_state(self) -> TrainState:
        """Step 0, JAX's ``place_state``: this rank's blocks of the model's
        parameters and of the optimizer's initial state."""
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        opt_state = init_opt_state(self.spec, params, self.optim_comp)
        i = self.fsdp_index
        return TrainState(0, self.layout.local_opt_state(opt_state, i), None,
                          self.layout.local(params, i))

    def global_params(self, state: TrainState) -> dict:
        """Every parameter whole (an all-gather of the blocks)."""
        return self.layout.gather(state.shards, self.fsdp_group)

    def global_opt_state(self, state: TrainState):
        return self.layout.gather_opt_state(state.opt_state, self.fsdp_group)

    # ------------------------------------------------------------- keys
    def _keys(self, key: int):
        """The taps' key (folded with the rank from W = 2) and the
        optimizer's, from the step key ``key``: host generators on the CPU,
        step keys on the card (``ops/keys.py``)."""
        _, fwd, opt = step_words(key)
        if self.size > 1:
            fwd = int(np.random.SeedSequence([key, 1, self.rank]).generate_state(1, np.uint64)[0])
        if self.device.type == "cuda":
            return DeviceKey(key_tensor(fwd, self.device)), DeviceKey(key_tensor(opt, self.device))
        return tuple(torch.Generator().manual_seed(w) for w in (fwd, opt))

    # ------------------------------------------------------------- step
    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.world)
        return t

    def __call__(self, state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor,
                 key: int) -> dict:
        """One step on the global batch ``(images_u8, labels)`` (NHWC uint8,
        on this rank's device); updates the model's BatchNorm buffers and
        ``state`` in place and returns the step's metrics (device tensors;
        ``_ratio/{tag}`` entries hold ``[orig_bits, new_bits]``)."""
        model = self.model
        gen_fwd, gen_opt = self._keys(key)
        batch = labels.shape[0]
        if batch % self.size:
            raise ValueError(f"a global batch of {batch} rows does not split over "
                             f"{self.size} ranks")
        rows = slice(self.rank * batch // self.size, (self.rank + 1) * batch // self.size)
        named = list(model.named_parameters())
        with torch.no_grad():
            for name, full in self.global_params(state).items():
                model.get_parameter(name).copy_(full)
        x = global_inputs(images_u8, key)[rows]
        y = labels[rows].long()

        model.train()
        sizes = SizeTotals()
        logits = model(x, TapContext(gen_fwd, sizes, stats_group=self.stats)).float()
        loss = F.cross_entropy(logits, y, reduction="sum") / batch
        for _, p in named:
            p.grad = None
        loss.backward()

        grads = [torch.zeros_like(p) if p.grad is None else p.grad for _, p in named]
        flat = self._sum(torch.cat([g.reshape(-1).float() for g in grads]))
        opt_sizes = self._optimizer_step(state, named, flat, gen_opt)
        for _, p in named:
            p.grad = None

        correct = (logits.detach().argmax(-1) == y).float().sum()
        pairs = list(sizes.totals.items())
        flat = self._sum(torch.cat([loss.detach().reshape(1), correct.reshape(1),
                                    *(v.float() for _, v in pairs)]))
        metrics = {"train_loss": flat[0], "train_accuracy": flat[1] / batch}
        for i, (tag, _) in enumerate(pairs):
            metrics[f"_ratio/{tag}"] = flat[2 + 2 * i:4 + 2 * i]
        metrics.update({f"_ratio/{t}": v for t, v in opt_sizes.items()})
        state.step += 1
        return metrics

    def _optimizer_step(self, state: TrainState, named, flat_grads, gen) -> dict:
        """The compressed optimizer on the summed gradients and the
        parameters the step gathered: at fsdp 1 one call on every leaf, as
        the trainer's; above, one whole leaf at a time, its state gathered,
        and this rank's blocks written back into ``state``.  Returns the
        optimizer's size pairs."""
        wrapped = isinstance(state.opt_state, CompressedOptState)
        inner = state.opt_state.inner if wrapped else state.opt_state
        buffers = [b for b in inner if b != "count"]
        count, at, grads = inner["count"], 0, {}
        for name, p in named:
            grads[name] = flat_grads[at:at + p.numel()].view_as(p)
            at += p.numel()
        if self.layout.fsdp == 1:
            new_p, new_state, out = compressed_optimizer_step(
                self.spec, {n: p.detach() for n, p in named}, grads, state.opt_state, gen,
                self.optim_comp, weight_exempt=self.exempt)
            self._keep(state, new_p, new_state, buffers, [n for n, _ in named])
            inner["count"] = count + 1
            return out
        layout, group, out = self.layout, self.fsdp_group, {}
        for name, p in named:
            leaf = {"count": count,
                    **{b: {name: layout.gather_leaf(name, inner[b][name], group)}
                       for b in buffers}}
            if wrapped:
                leaf = CompressedOptState(
                    leaf, {name: layout.gather_leaf(name, state.opt_state.master[name], group)})
            new_p, new_state, metrics = compressed_optimizer_step(
                self.spec, {name: p.detach()}, {name: grads[name]}, leaf, own_key(gen),
                self.optim_comp, weight_exempt={name: self.exempt[name]})
            self._keep(state, new_p, new_state, buffers, [name])
            for tag, v in metrics.items():
                out[tag] = out[tag] + v if tag in out else v
        inner["count"] = count + 1
        return out

    def _keep(self, state: TrainState, new_p, new_state, buffers, names) -> None:
        """This rank's blocks of the leaves ``names`` of an optimizer
        step's parameters and state, written into ``state``."""
        wrapped = isinstance(state.opt_state, CompressedOptState)
        inner = state.opt_state.inner if wrapped else state.opt_state
        new_inner = new_state.inner if wrapped else new_state
        layout, index = self.layout, self.fsdp_index
        with torch.no_grad():
            for name in names:
                state.shards[name].copy_(layout.block(name, new_p[name], index))
                for b in buffers:
                    inner[b][name].copy_(layout.block(name, new_inner[b][name], index))
                if wrapped:
                    state.opt_state.master[name].copy_(
                        layout.block(name, new_state.master[name], index))


def make_fsdp_train_step(model: torch.nn.Module, spec: OptimizerSpec,
                         optim_comp: OptimizerCompression, mesh) -> FloatFSDPStep:
    """The whole-batch step of ``model`` (on its device) on ``mesh`` (one
    device: ``make_mesh(1, 1)``)."""
    return FloatFSDPStep(model, spec, optim_comp, mesh)
