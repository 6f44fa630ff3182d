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
  gathered whole, the step on the whole leaf, the same on every rank, and
  this rank's block kept: every rank holds what one device would, with one
  leaf's state in flight;
- packed state (``packed_momentum``, ``packed_weights``): a packed leaf is
  one codebook of the whole leaf, as one device encodes it; each rank
  stores its block of the uint8 codes and the leaf's (mean, std)
  replicated.  The forward decodes the gathered codes whole; above fsdp 1
  the optimizer gathers a leaf's codes whole (a quarter of its float32
  bytes), decodes them, steps, re-encodes the whole leaf with its own
  statistics and keeps this rank's block;
- random draws: every rank draws from the step's one key, as one device
  does.  A tap's call on this rank's rows counts its noise from their
  first element in the whole tensor (``StatsGroup.compress``, an element
  offset in the kernels' Philox counters), and the optimizer keys each
  (stage, leaf) of its calls (``optim/compressed.py::LeafKeys``), so one
  leaf's step draws what the whole tree's draws for it;
- metrics: the global batch's loss and accuracy; the taps' sizes summed
  over the ranks (``_ratio/{tag}`` pairs), the optimizer's counted once.

One device is a (1, 1) mesh, as in JAX; a step on any mesh is the (1, 1)
step with the same key, element by element but for the flips that the
statistics' other summation orders give (and ranks bitwise equal).  The
JAX step has no ``--compress_loss``, ``avg_grad_norm`` or
``--steps_per_call``, and neither has this one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from smart_quantization_tpu_torch.compress.base import SizeTotals
from smart_quantization_tpu_torch.inject.tap import TapContext
from smart_quantization_tpu_torch.ops.codebook import SmaQCodes
from smart_quantization_tpu_torch.ops.keys import DeviceKey, key_tensor
from smart_quantization_tpu_torch.optim.compressed import (
    CompressedOptState,
    LeafKeys,
    OptimizerCompression,
    OptimizerSpec,
    compressed_optimizer_step,
    decode_params,
    encode_params,
    init_opt_state,
    norm_param_mask,
)
from smart_quantization_tpu_torch.parallel.train_fsdp_q import FSDPLayout, _map_state
from smart_quantization_tpu_torch.parallel.whole_batch import StatsGroup
from smart_quantization_tpu_torch.train.loop import float32_on_card, init_generators
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
        if mesh is None:
            raise ValueError("the whole-batch step takes a (data, fsdp) mesh; one device is "
                             "make_mesh(1, 1)")
        self.model, self.spec, self.optim_comp, self.mesh = model, spec, optim_comp, mesh
        self.size, self.rank, self.fsdp_index = mesh.size, mesh.rank, mesh.fsdp_index
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.layout = FSDPLayout(shapes, mesh.shape["fsdp"])
        self.world = mesh.group(("data", "fsdp"))
        self.fsdp_group = mesh.group("fsdp")
        self.stats = StatsGroup(self.world, self.size, self.rank)
        self.exempt = norm_param_mask(shapes)
        self.device = next(model.parameters()).device
        if self.device.type == "cuda":
            float32_on_card()  # the trainer's: no TF32, deterministic kernels

    # ------------------------------------------------------------ state
    def init_state(self, seed: int = 0) -> TrainState:
        """Step 0, JAX's ``place_state``: this rank's blocks of the model's
        parameters and of the optimizer's initial state; packed state
        encoded whole as the trainer of a run seeded ``seed`` encodes it."""
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        gen_state, gen_weights = init_generators(seed)
        opt_state = init_opt_state(self.spec, params, self.optim_comp, gen_state)
        params = encode_params(params, self.optim_comp, gen_weights, exempt=self.exempt)
        return TrainState(0, _map_state(opt_state, self._local), None, self._local(params))

    def _block(self, name: str, leaf):
        """This rank's block of a whole leaf (a packed one's codes, its
        stats replicated)."""
        i = self.fsdp_index
        if isinstance(leaf, SmaQCodes):
            return SmaQCodes(self.layout.block(name, leaf.codes, i), leaf.mean.clone(),
                             leaf.std.clone())
        return self.layout.block(name, leaf, i)

    def _whole(self, name: str, leaf):
        """A leaf whole from every fsdp rank's block (a packed one's codes
        gathered as uint8)."""
        if isinstance(leaf, SmaQCodes):
            return SmaQCodes(self.layout.gather_leaf(name, leaf.codes, self.fsdp_group),
                             leaf.mean, leaf.std)
        return self.layout.gather_leaf(name, leaf, self.fsdp_group)

    def _local(self, tree: dict) -> dict:
        return {k: self._block(k, v) for k, v in tree.items()}

    def _global(self, tree: dict) -> dict:
        return {k: self._whole(k, v) for k, v in tree.items()}

    def global_params(self, state: TrainState) -> dict:
        """Every parameter whole (an all-gather of the blocks), packed
        leaves decoded: what the forward takes."""
        return decode_params(self._global(state.shards), self.optim_comp)

    def global_opt_state(self, state: TrainState):
        """The optimizer state whole, packed leaves as codes."""
        return _map_state(state.opt_state, self._global)

    # ------------------------------------------------------------- keys
    def _keys(self, key: int):
        """The taps' key and the optimizer's, every rank's, from the step
        key ``key``: host generators on the CPU, step keys on the card
        (``ops/keys.py``)."""
        _, fwd, opt = step_words(key)
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
        parameters the step gathered (decoded): at fsdp 1 one call on every
        leaf, as the trainer's; above, one whole leaf at a time, its state
        gathered (packed codes as uint8), its keys those of the whole
        tree's call, and this rank's blocks written back into ``state``.
        Returns the optimizer's size pairs."""
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
        keys, out = LeafKeys(gen, [n for n, _ in named]), {}
        for name, p in named:
            leaf = {"count": count,
                    **{b: {name: self._whole(name, inner[b][name])} for b in buffers}}
            if wrapped:
                leaf = CompressedOptState(
                    leaf, {name: self._whole(name, state.opt_state.master[name])})
            new_p, new_state, metrics = compressed_optimizer_step(
                self.spec, {name: p.detach()}, {name: grads[name]}, leaf, keys,
                self.optim_comp, weight_exempt={name: self.exempt[name]})
            self._keep(state, new_p, new_state, buffers, [name])
            for tag, v in metrics.items():
                out[tag] = out[tag] + v if tag in out else v
        inner["count"] = count + 1
        return out

    def _keep(self, state: TrainState, new_p, new_state, buffers, names) -> None:
        """This rank's blocks of the leaves ``names`` of an optimizer
        step's parameters and state, written into ``state``: a float32
        block into the tensor it replaces, a packed one's codes and stats
        in its place."""
        wrapped = isinstance(state.opt_state, CompressedOptState)
        inner = state.opt_state.inner if wrapped else state.opt_state
        new_inner = new_state.inner if wrapped else new_state
        trees = [(state.shards, new_p), *((inner[b], new_inner[b]) for b in buffers)]
        if wrapped:
            trees.append((state.opt_state.master, new_state.master))
        with torch.no_grad():
            for name in names:
                for tree, new in trees:
                    block = self._block(name, new[name])
                    if isinstance(block, SmaQCodes) or isinstance(tree[name], SmaQCodes):
                        tree[name] = block
                    else:
                        tree[name].copy_(block)


def make_fsdp_train_step(model: torch.nn.Module, spec: OptimizerSpec,
                         optim_comp: OptimizerCompression, mesh) -> FloatFSDPStep:
    """The whole-batch step of ``model`` (on its device) on ``mesh`` (one
    device: ``make_mesh(1, 1)``)."""
    return FloatFSDPStep(model, spec, optim_comp, mesh)
