"""The training loop, on one device or on a mesh of ranks.

Counterpart of ``smart_quantization_tpu/train/loop.py::Trainer``.  A task
(``train/task.py``) supplies what varies by model family: batch
preparation, the model's arguments, the loss and the eval reduction.

With a ``mesh`` (``parallel/mesh.py``; one process a rank, NCCL on the
card, gloo on the CPU) the step is the JAX package's ``shard_map`` body
with explicit collectives after ``backward()`` (``parallel/``): rank r
takes rows ``[r B/n, (r+1) B/n)`` of each global batch; under data
parallelism the gradients are averaged (float32, or the int8 gather or
psum exchange of ``--grad_allreduce_bits``) and the optimizer runs
replicated; with ``fsdp`` > 1 the state lives sharded, the forward
gathers the parameters (int8 under ``--param_gather_bits``), the
gradients are reduce-scattered and the optimizer steps the local shards.
The BatchNorm running statistics and the metrics are reduced over the
ranks.  The taps, augmentation and dropout draw from keys folded with the
rank, the optimizer and the loss compressor from the shared step key.
Logs and checkpoints come from rank 0; a checkpoint holds the global
layout (rank 0 gathers the shards), and one written at another fsdp size
is resharded on restore.  Evaluation splits a batch over the ranks when
they divide it, and otherwise runs it whole on every rank.

- ``init_state`` builds the optimizer state (master weights, packed
  momentum) and, under ``--packed_weights``, the packed parameter tree,
  drawing from two generators of the seed (state encode, weight encode;
  the model's initial weights come from the seed where the model is
  built);
- ``train_step`` runs one step on a batch already prepared on the device:
  packed weights decoded into the model, tapped forward and backward, the
  compressed optimizer step, and the step's metrics as device tensors;
  between steps a packed leaf keeps no float32 copy in the model.  The
  step updates every tensor it keeps in place (parameters, buffers,
  optimizer state, packed codes), so that a CUDA graph of it replays on
  fixed addresses;
- ``train_steps`` runs K prepared batches as one group
  (``--steps_per_call K``): on the card one replay of a CUDA graph of K
  steps (``train/graph.py``), on the CPU K eager steps;
- ``fit`` drives epochs of device-side batches, grouped K at a time with
  the leftover group run as single steps, with NaN termination (a NaN
  inside a group is caught at the next drain, after the rest of its group
  has run, as in the JAX package), ``limit_{train,val}_batches``,
  ``max_time``, ``log_every``, a checkpoint every
  ``checkpoint_every_epochs`` epochs, and a ``torch.profiler`` trace of the
  first ``profile_steps`` steps under ``--profile_dir``;
- ``evaluate`` reduces the validation split with one host read at the end,
  K batches to a graph under ``--steps_per_call``;
- ``save_checkpoint``/``load_checkpoint`` write and read the port's own
  format (``torch.save``); a resumed run steps as the straight run does,
  since every step's randomness derives from (seed, step);
- ``run`` is what the CLI does with a trainer: resume, fit, evaluate,
  report.

Randomness: on the CPU each step draws from host generators derived from
(seed, step); on the card from its step key in device memory
(``ops/keys.py``), with the learning rate and Adam's bias corrections in
the same row, so a graph replays each step with its own key and scalars.
Between logging points a training step makes no device-to-host sync: every
size stays on the device, and metrics are read only when ``_drain`` logs
them.  A parameter that gets no gradient (BERT's encoder under
``freeze_encoder``) steps with a zero gradient, as JAX's ``stop_gradient``
gives.

On CUDA the trainer turns TF32 off for cuDNN convolutions and matmuls
(``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.
allow_tf32``), so the card trains in full float32 like the reference, and
bfloat16 products keep float32 accumulation (``allow_bf16_reduced_
precision_reduction`` off, as XLA's) when the model computes in bfloat16
(``--compute_dtype``); ``compress_loss`` passes the loss through the run's
encoder (``inject/tap.py::compress_loss``) and ``measure_average_grad_norm``
logs ``avg_grad_norm``, both on the device.  It makes every kernel
deterministic (:func:`make_reproducible`), so a seeded
run gives the same losses and parameters bit for bit, as the JAX package's
does, and a K-step replay gives those of K eager steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from smart_quantization_tpu_torch import resolve_device
from smart_quantization_tpu_torch.compress.base import CompressorBase, SizeTotals
from smart_quantization_tpu_torch.inject.tap import TapContext, compress_loss
from smart_quantization_tpu_torch.ops.codebook import SmaQCodes
from smart_quantization_tpu_torch.ops.keys import (
    DeviceKey,
    as_int64,
    key_tensor,
    mesh_step_words,
    step_key,
)
from smart_quantization_tpu_torch.optim.compressed import (
    CompressedOptState,
    OptimizerCompression,
    OptimizerSpec,
    compressed_optimizer_step,
    decode_params,
    encode_params,
    init_opt_state,
    norm_param_mask,
    packed_smaq_params,
    reshard_packed_state,
)
from smart_quantization_tpu_torch.parallel.collectives import all_gather_single
from smart_quantization_tpu_torch.parallel.train_dp import (
    DataParallel,
    average_buffers,
    reduce_metrics,
)
from smart_quantization_tpu_torch.parallel.train_fsdp_q import FusedFSDP
from smart_quantization_tpu_torch.train.graph import StepGraph, stack_outputs, to_device
from smart_quantization_tpu_torch.train.metrics import (
    MetricLogger,
    RatioAccumulator,
    merge_compression_metrics,
)
from smart_quantization_tpu_torch.train.state import TrainState, from_saved, to_saved
from smart_quantization_tpu_torch.train.task import ImageClassificationTask
from smart_quantization_tpu_torch.utils import profiling

# A step's row on the card: its key, then its optimizer scalars (-lr and
# Adam's two bias corrections, OptimizerSpec.step_scalars) as float32 in
# the next two words; on a mesh then the rank's keys (ops/keys.py::
# mesh_step_words): taps and augmentation, dropout, the gradient payload
# and the FSDP parameter gather.
AUX_WORDS = 7
# the eval steps' constant key on the card (the JAX package's constant
# eval key; the CPU's is a generator seeded 0)
EVAL_KEY = 0


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 1
    log_every: int = 50
    terminate_on_nan: bool = True
    measure_compression_ratio: bool = False
    # int = batch count; 0 < float <= 1 = fraction of the epoch
    limit_train_batches: int | float | None = None
    limit_val_batches: int | float | None = None
    # wall-clock budget in seconds, checked at logging points and epoch ends
    max_time_s: float | None = None
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every_epochs: int = 1
    # K training (and eval) steps per dispatch: on the card one CUDA graph
    # of K captured steps, replayed once per group of K batches; on the CPU
    # the same grouping, eager.  As in the JAX package, a NaN inside a
    # group is caught at the next drain, after the rest of its group has
    # run (with K = 1 no step follows the NaN step).
    steps_per_call: int = 1
    # a torch.profiler trace of the first profile_steps steps, written here
    profile_dir: str | None = None
    profile_steps: int = 10
    # the loss through the run's encoder (tag "loss", not counted)
    compress_loss: bool = False
    # log avg_grad_norm: the mean of the per-leaf L2 norms of the raw gradients
    measure_average_grad_norm: bool = False

    @staticmethod
    def from_args(args) -> "TrainConfig":
        """The loop's settings from a parsed command line."""
        return TrainConfig(
            epochs=args.max_epochs,
            log_every=args.log_every,
            terminate_on_nan=args.terminate_on_nan,
            measure_compression_ratio=args.measure_compression_ratio,
            limit_train_batches=args.limit_train_batches,
            limit_val_batches=args.limit_val_batches,
            max_time_s=args.max_time,
            seed=args.seed,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every_epochs=args.checkpoint_every_epochs,
            steps_per_call=args.steps_per_call,
            profile_dir=args.profile_dir,
            profile_steps=args.profile_steps,
            compress_loss=args.compress_loss,
            measure_average_grad_norm=args.measure_average_grad_norm,
        )


def _generator(seed: int, device: torch.device | str = "cpu") -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def init_generators(seed: int) -> tuple[torch.Generator, torch.Generator]:
    """The host generators a run seeded ``seed`` encodes its initial packed
    state from: the optimizer state's and the weights'."""
    words = np.random.SeedSequence(seed, spawn_key=(1,)).generate_state(2, np.uint64)
    return _generator(int(words[0])), _generator(int(words[1]))


def make_reproducible() -> None:
    """Deterministic kernels on the card: the same seed gives the same run
    bit for bit.  cuBLAS reads ``CUBLAS_WORKSPACE_CONFIG`` at its first
    call, so the entry points set it before touching the card; it is set
    here too for a trainer built elsewhere.  ``torch.empty`` is left
    uninitialized (every kernel writes its whole output), so determinism
    adds no fill to each allocation."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def float32_on_card() -> None:
    """The card's settings of a training step: TF32 off for cuDNN
    convolutions and matmuls, bfloat16 products with float32 accumulation
    (as XLA's), and deterministic kernels (:func:`make_reproducible`)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    make_reproducible()


def _assign(dst, src) -> None:
    """Copy ``src``'s tensors into ``dst``'s, in place, over one tree shape
    (dicts, ``SmaQCodes``, ``CompressedOptState``); other leaves (Adam's
    count) are the host's to set."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (SmaQCodes, CompressedOptState)):
        for a, b in zip(dst, src):
            _assign(a, b)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            _assign(v, src[k])


class StepKeys(NamedTuple):
    """Where each of a step's draws comes from: host generators on the
    CPU, step keys on the card (``ops/keys.py``)."""

    fwd: object  # the taps (and, on a mesh, the augmentation's rank)
    opt: object  # the optimizer, shared by every rank
    drop: object  # dropout
    loss: object  # the loss compressor
    payload: object = None  # the gradient exchange's rounding (a mesh)
    gather: object = None  # the FSDP parameter gather's rounding


def _inner(opt_state) -> dict:
    return opt_state.inner if isinstance(opt_state, CompressedOptState) else opt_state


class Trainer:
    """Trainer of a task (image classification by default), on one device
    or, with ``mesh``, on one rank of a (data, fsdp) mesh."""

    def __init__(
        self,
        model: torch.nn.Module,
        data,
        spec: OptimizerSpec,
        *,
        optim_comp: OptimizerCompression | None = None,
        loss_compressor: CompressorBase | None = None,
        config: TrainConfig = TrainConfig(),
        logger: MetricLogger | None = None,
        device: str | torch.device | None = None,
        task=None,
        mesh=None,
        grad_allreduce_bits: int | None = 8,
        grad_allreduce_mode: str = "auto",
        param_gather_bits: int | None = None,
    ):
        if config.steps_per_call < 1:
            raise ValueError(f"--steps_per_call must be 1 or more, got {config.steps_per_call}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            float32_on_card()
            print("NOTE: TF32 is off for convolutions and matmuls; the card trains "
                  "in the model's compute dtype with float32 accumulation.")
        self.model = model.to(self.device)
        self.data = data
        self.spec = spec
        self.task = task or ImageClassificationTask()
        self.optim_comp = optim_comp or OptimizerCompression()
        self.loss_compressor = loss_compressor
        self.cfg = config
        self.logger = logger or MetricLogger(None)
        self.ratio_acc = RatioAccumulator()
        self.nan_terminated = False
        self.weight_exempt = norm_param_mask(n for n, _ in model.named_parameters())
        # the mesh's exchange: data parallelism, or the fused FSDP path
        self.mesh = mesh
        self._dp = self._fsdp = None
        if mesh is not None:
            if mesh.fsdp_active:
                shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
                self._fsdp = FusedFSDP(mesh, shapes, grad_allreduce_bits, param_gather_bits)
            else:
                self._dp = DataParallel(mesh, grad_allreduce_bits, grad_allreduce_mode)
        self.primary = mesh is None or mesh.rank == 0
        # augmentation draws on the device, from one generator per run (on
        # a mesh one per rank)
        seed = config.seed if mesh is None else int(
            np.random.SeedSequence([config.seed, 4, mesh.rank]).generate_state(1, np.uint64)[0])
        self.data_gen = _generator(seed, self.device)
        # what a packed leaf of the model holds between steps
        self._released = torch.empty(0, device=self.device)
        # the K-step graphs on the card (train/graph.py), built at first use
        self._train_graph: StepGraph | None = None
        self._train_graph_of: TrainState | None = None
        self._eval_graph: StepGraph | None = None
        self._eval_graph_of: tuple = ()
        self._eval_key = key_tensor(EVAL_KEY, self.device) if self._on_card else None
        self._profiler = None

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def init_state(self) -> TrainState:
        """Step 0: the optimizer state (with the master weights and packed
        momentum where asked for) and, under ``packed_weights``, the packed
        parameters, whose decoded view the model then holds.  Under FSDP
        the global layout is built (as the JAX package's ``fsdp_size``
        init) and this rank keeps its shards of it."""
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        gen_state, gen_weights = init_generators(self.cfg.seed)
        fsdp = self.mesh.shape["fsdp"] if self._fsdp is not None else None
        opt_state = init_opt_state(self.spec, params, self.optim_comp, gen_state, fsdp_size=fsdp)
        packed = None
        if self.optim_comp.packed_weights:
            packed = encode_params(params, self.optim_comp, gen_weights, exempt=self.weight_exempt,
                                   fsdp_size=fsdp)
        if self._fsdp is not None:
            return self._place(opt_state, packed if packed is not None else params)
        if packed is not None:
            self._load_params(packed)
        return TrainState(0, opt_state, packed)

    def _place(self, opt_state, params: dict, step: int = 0) -> TrainState:
        """This rank's shards of a global-layout state (FSDP)."""
        layout, i = self._fsdp.layout, self.mesh.fsdp_index
        shards = layout.local(params, i)
        return TrainState(step, layout.local_opt_state(opt_state, i), None, shards)

    def _sync_model(self, state: TrainState | None) -> None:
        """The model's parameters from ``state``: packed weights decoded;
        under FSDP the shards gathered in float32 (as the JAX package's
        evaluation sees the stored parameters)."""
        if state is None:
            return
        if state.shards is not None:
            self._fsdp.gather_params(decode_params(state.shards, self.optim_comp), None,
                                     dict(self.model.named_parameters()), quantized=False)
        elif state.packed_params is not None:
            self._load_params(state.packed_params)

    def _load_params(self, packed: dict) -> None:
        """Decode a packed parameter tree into the model."""
        decoded = decode_params(packed, self.optim_comp)
        for n, p in self.model.named_parameters():
            p.data = decoded[n]

    def _step_generators(self, step: int) -> tuple[torch.Generator, ...]:
        """The CPU step's host generators for the taps, the optimizer and
        the dropout masks, derived from (seed, step): the first word is the
        step key the card's step draws from (``ops/keys.py::step_key``)."""
        s_fwd, s_opt, s_drop = np.random.SeedSequence([self.cfg.seed, step]).generate_state(
            3, np.uint64)
        return _generator(int(s_fwd)), _generator(int(s_opt)), _generator(int(s_drop), self.device)

    def _mesh_words(self, step: int) -> tuple[int, int, int, int]:
        return mesh_step_words(self.cfg.seed, step, self.mesh.rank, self.mesh.fsdp_index,
                               self._fsdp is not None)

    def _step_keys(self, step: int) -> StepKeys:
        """The CPU step's generators; on a mesh the taps, dropout, payload
        and gather draw from the rank's words, the optimizer and the loss
        compressor from the shared one."""
        fwd, opt, drop = self._step_generators(step)
        if self.mesh is None:
            return StepKeys(fwd, opt, drop, fwd)
        w_fwd, w_drop, w_payload, w_gather = self._mesh_words(step)
        return StepKeys(_generator(w_fwd), opt, _generator(w_drop, self.device), opt,
                        _generator(w_payload), _generator(w_gather))

    def _aux_rows(self, state: TrainState, n: int) -> np.ndarray:
        """The next ``n`` steps' rows on the card: each step's key, then its
        optimizer scalars as float32 words, then on a mesh its rank's keys."""
        rows = np.zeros((n, AUX_WORDS), np.int64)
        count = _inner(state.opt_state)["count"]
        for j in range(n):
            rows[j, 0] = as_int64([step_key(self.cfg.seed, state.step + j)])[0]
            rows[j, 1:3].view(np.float32)[:3] = self.spec.step_scalars(count + j)
            if self.mesh is not None:
                rows[j, 3:7] = as_int64(self._mesh_words(state.step + j))
        return rows

    def _card_keys(self, aux: torch.Tensor) -> tuple[StepKeys, torch.Tensor]:
        key = DeviceKey(aux[0:1])
        scalars = aux[1:3].view(torch.float32)
        if self.mesh is None:
            return StepKeys(key, key, key, key), scalars
        fwd = DeviceKey(aux[3:4])
        return (StepKeys(fwd, key, DeviceKey(aux[4:5]), key, DeviceKey(aux[5:6]),
                         DeviceKey(aux[6:7])), scalars)

    def _advance(self, state: TrainState, n: int) -> None:
        """The host's count of ``n`` steps taken."""
        state.step += n
        _inner(state.opt_state)["count"] += n

    # ------------------------------------------------------------- steps
    def _step(self, state: TrainState, inputs, labels: torch.Tensor, aux) -> dict:
        """One step's computation: reads the model's and ``state``'s tensors
        and writes them in place, so that a graph of it replays on fixed
        addresses; the host's step count is the caller's.  ``aux`` is the
        step's row on the card (``_aux_rows``), or its :class:`StepKeys`.
        On a mesh ``inputs`` and ``labels`` are this rank's rows."""
        if self._on_card:
            keys, scalars = self._card_keys(aux)
        else:
            keys, scalars = aux, None
        sizes = SizeTotals() if self.cfg.measure_compression_ratio else None
        model = self.model
        named = list(model.named_parameters())
        if state.shards is not None:
            local = decode_params(state.shards, self.optim_comp)
            self._fsdp.gather_params(local, keys.gather, dict(named))
        elif state.packed_params is not None:
            self._load_params(state.packed_params)
            named = list(model.named_parameters())
        model.train()
        logits = model(*self.task.model_args(inputs), TapContext(keys.fwd, sizes, keys.drop))
        loss = self.task.loss(logits, labels)
        if self.cfg.compress_loss and self.loss_compressor is not None:
            loss = compress_loss(loss, self.loss_compressor, keys.loss)
        for _, p in named:
            p.grad = None
        loss.backward()

        params = {n: p.detach() for n, p in named}
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in named}
        grad_norm = None
        if self.cfg.measure_average_grad_norm:
            # the raw gradients' norms in one fused launch; no host sync
            grad_norm = torch.stack(torch._foreach_norm(list(grads.values()))).mean()
        if self._fsdp is not None:
            grads = self._fsdp.exchange_grads(grads, keys.payload)
            params = local
        elif self._dp is not None:
            grads = self._dp.exchange(grads, keys.payload)
        if self.mesh is not None:
            average_buffers(model, self.mesh.group(("data", "fsdp")), self.mesh.size)
        new_params, opt_state, opt_metrics = compressed_optimizer_step(
            self.spec, params, grads, state.opt_state, keys.opt, self.optim_comp,
            weight_exempt=self.weight_exempt, scalars=scalars,
            packed_stats_rank1=self._fsdp is not None,
        )
        with torch.no_grad():
            _assign(state.opt_state, opt_state)
            if state.shards is not None:
                # the shards are the stored weights; the model's full
                # tensors are the next step's gather target
                _assign(state.shards, new_params)
            elif state.packed_params is not None:
                # the codes are the stored weights; the model keeps no
                # float32 copy of a packed leaf until the next decode (the
                # exempt leaves are the packed tree's own tensors)
                _assign(state.packed_params, new_params)
                for n, p in named:
                    if isinstance(new_params[n], SmaQCodes):
                        p.data = self._released
            else:
                for n, p in named:
                    p.copy_(new_params[n])
        for _, p in named:
            p.grad = None

        metrics = {"train_loss": loss.detach()}
        metrics.update(self.task.train_metrics(logits.detach(), labels))
        if grad_norm is not None:
            metrics["avg_grad_norm"] = grad_norm
        taps = {f"_ratio/{t}": v for t, v in sizes.totals.items()} if sizes is not None else {}
        opt = {f"_ratio/{t}": v for t, v in opt_metrics.items()} if sizes is not None else {}
        if self.mesh is not None:
            return reduce_metrics(metrics, taps, self.mesh.group(("data", "fsdp")),
                                  self.mesh.size, opt,
                                  self.mesh.group("fsdp") if self._fsdp is not None else None)
        return {**metrics, **taps, **opt}

    def train_step(self, state: TrainState, inputs, labels: torch.Tensor) -> dict:
        """One step on a prepared batch (``task.prepare_train``'s output);
        updates the model and ``state`` in place and returns the step's
        metrics (device tensors; ``_ratio/{tag}`` entries hold
        ``[orig_bits, new_bits]``)."""
        if self._on_card:
            aux = to_device(self._aux_rows(state, 1)[0], self.device)
        else:
            aux = self._step_keys(state.step)
        metrics = self._step(state, inputs, labels, aux)
        self._advance(state, 1)
        return metrics

    def train_steps(self, state: TrainState, batches: list) -> dict:
        """K prepared ``(inputs, labels)`` batches as one group: on the card
        one replay of the K-step CUDA graph (the first group warms it up
        and captures it), on the CPU K eager steps.  Returns the metrics
        with a leading K axis."""
        k = len(batches)
        if not self._on_card:
            return stack_outputs([self.train_step(state, x, y) for x, y in batches])
        if self._train_graph is None or self._train_graph_of is not state:
            # a graph reads and writes the tensors of the state it captured;
            # it calls back through a weak reference, so that a trainer let
            # go frees its graphs' memory pools at once (no cycle to wait on)
            me = weakref.ref(self)
            self._train_graph = StepGraph(
                k, lambda x, y, aux: me()._step(state, x, y, aux), self.device)
            self._train_graph_of = state
        metrics = self._train_graph(batches, self._aux_rows(state, k))
        self._advance(state, k)
        return metrics

    def _eval_tap_context(self) -> TapContext:
        # a constant key per batch, as the JAX package's constant eval key:
        # the eval rounding noise is the same every epoch
        if self._on_card:
            return TapContext(DeviceKey(self._eval_key))
        return TapContext(_generator(0))

    @torch.no_grad()
    def eval_step(self, inputs, labels: torch.Tensor) -> dict:
        """The task's outputs of one eval batch.  On a mesh whose size
        divides the batch, each rank runs its rows and the logits are
        gathered; otherwise every rank runs the whole batch."""
        self.model.eval()
        split = self.mesh is not None and len(labels) % self.mesh.size == 0
        x = self._rows(inputs) if split else inputs
        logits = self.model(*self.task.model_args(x), self._eval_tap_context())
        if split:
            logits = self._gather_rows(logits)
        return self.task.eval_outputs(logits, labels)

    def prepare_batch(self, inputs, labels: torch.Tensor):
        """A global training batch as this step takes it: on a mesh this
        rank's rows, then the task's preparation (augmentation from the
        trainer's generator)."""
        if self.mesh is not None:
            inputs, labels = self._rows(inputs), self._rows(labels)
        return self.task.prepare_train(inputs, self.data_gen), labels

    def _rows(self, x):
        """This rank's rows ``[r B/n, (r+1) B/n)`` of a batch (a tensor or
        a dict of them)."""
        if isinstance(x, dict):
            return {k: self._rows(v) for k, v in x.items()}
        b = x.shape[0] // self.mesh.size
        return x[self.mesh.rank * b:(self.mesh.rank + 1) * b]

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.mesh.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        all_gather_single(out, t.contiguous(), group=self.mesh.group(("data", "fsdp")))
        return out

    def _agree(self, flag: bool) -> bool:
        """True on every rank if it is on rank 0 (a mesh's ranks stop
        together)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag and self.primary)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def _eval_group(self, batches: list) -> dict:
        """K eval batches: one replay of the eval graph on the card (captured
        anew when the model's tensors have moved: packed weights decode
        into new ones), K eager steps on the CPU."""
        if not self._on_card:
            return stack_outputs([self.eval_step(x, y) for x, y in batches])
        tensors = (*self.model.parameters(), *self.model.buffers())
        where = tuple(t.data_ptr() for t in tensors)
        if self._eval_graph is None or self._eval_graph_of != where:
            me = weakref.ref(self)
            self._eval_graph = StepGraph(
                len(batches), lambda x, y, _: me().eval_step(x, y), self.device)
            self._eval_graph_of = where
        return self._eval_graph(batches)

    @staticmethod
    def _resolve_limit(v, total):
        """None, an int batch count, or a float fraction 0 < f <= 1 of
        ``total`` batches (a whole float counts as a batch count)."""
        if v is None:
            return None
        if isinstance(v, float) and 0 < v <= 1.0:
            if v == 1.0:
                return None
            return max(1, int(v * total)) if total else None
        if isinstance(v, float) and v != int(v):
            raise ValueError(
                f"fractional batch limit {v} is outside (0, 1]; pass a "
                "fraction in (0, 1] or an integral batch count"
            )
        return int(v)

    # ---------------------------------------------------------- profiling
    def _start_profile(self) -> None:
        """A ``torch.profiler`` trace, with the named regions on."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self._on_card:
            activities.append(ProfilerActivity.CUDA)
        self._profiler = contextlib.ExitStack()
        self._trace = self._profiler.enter_context(profile(activities=activities))
        self._profiler.enter_context(profiling.regions())

    def _stop_profile(self, state: TrainState) -> None:
        """End the trace and write it under ``profile_dir``."""
        if self._profiler is None:
            return
        if self._on_card:
            torch.cuda.synchronize(self.device)
        self._profiler.close()
        self._profiler = None
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, f"steps_to_{state.step}.pt.trace.json")
        self._trace.export_chrome_trace(path)
        print(f"profile of the steps to {state.step} written to {path}", flush=True)

    # -------------------------------------------------------------- loop
    def fit(self, state: TrainState | None = None) -> TrainState:
        if state is None:
            state = self.init_state()
        fit_t0 = time.time()
        spc = self.cfg.steps_per_call
        profile_end = state.step + self.cfg.profile_steps
        if self.cfg.profile_dir:
            self._start_profile()

        def time_up() -> bool:
            return self.cfg.max_time_s is not None and self._agree(
                time.time() - fit_t0 >= self.cfg.max_time_s)

        lim_train = self._resolve_limit(
            self.cfg.limit_train_batches, self.data.steps_per_epoch
        )
        try:
            for epoch in range(self.cfg.epochs):
                t0 = time.time()
                pending = []  # (last step, steps, metrics) not yet read on the host
                group = []  # prepared batches awaiting a K-step dispatch
                batches = self.data.device_train_batches(self.cfg.seed + epoch, self.device)
                for bi, (inputs, labels) in enumerate(batches):
                    if lim_train is not None and bi >= lim_train:
                        break
                    # augmentation runs eagerly, in the order a K = 1 run takes it
                    x, labels = self.prepare_batch(inputs, labels)
                    if spc > 1:
                        group.append((x, labels))
                        if len(group) < spc:
                            continue
                        metrics = self.train_steps(state, group)
                        group = []
                        pending.append((state.step, spc, metrics))
                    else:
                        metrics = self.train_step(state, x, labels)
                        pending.append((state.step, 1, metrics))
                    if self._profiler is not None and state.step >= profile_end:
                        self._stop_profile(state)
                    if state.step % self.cfg.log_every < spc:
                        if self._drain(pending):
                            return state
                        pending = []
                        if time_up():
                            print(f"max_time reached at step {state.step}; stopping.",
                                  flush=True)
                            return state
                # a leftover group smaller than K runs as single steps
                for x, labels in group:
                    pending.append((state.step + 1, 1, self.train_step(state, x, labels)))
                if self._drain(pending):
                    return state
                if time_up():
                    print(f"max_time reached at step {state.step}; stopping.", flush=True)
                    return state
                self._stop_profile(state)
                val = self.evaluate(state)
                val["epoch"] = epoch
                val["epoch_time_s"] = time.time() - t0
                val.update(self.ratio_acc.summary())
                if self.primary:
                    self.logger.log(state.step, val)
                self._maybe_checkpoint(state, epoch)
            return state
        finally:
            self._stop_profile(state)

    def _maybe_checkpoint(self, state: TrainState, epoch: int) -> None:
        if not self.cfg.checkpoint_dir or (epoch + 1) % self.cfg.checkpoint_every_epochs:
            return
        if self.primary:
            os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        self.save_checkpoint(os.path.join(self.cfg.checkpoint_dir, f"epoch_{epoch:04d}.pt"), state)

    def save_checkpoint(self, path: str, state: TrainState) -> None:
        """Write the port's checkpoint (``torch.save``): the step, the
        parameters (packed leaves as their uint8 codes and stats), the
        model's buffers, the optimizer state with any master weights, and
        the augmentation generator's state.  On a mesh every rank calls it
        and rank 0 writes: under FSDP the global layout, gathered from the
        shards (packed stats as ``(fsdp,)`` rows), with its fsdp size."""
        if state.shards is not None:
            group = self.mesh.group("fsdp")
            params = self._fsdp.layout.gather(state.shards, group)
            opt_state = self._fsdp.layout.gather_opt_state(state.opt_state, group)
        else:
            params = state.packed_params
            if params is None:
                params = {n: p.detach() for n, p in self.model.named_parameters()}
            opt_state = state.opt_state
        ck = {
            "step": state.step,
            "params": to_saved(params),
            "buffers": dict(self.model.named_buffers()),
            "opt_state": to_saved(opt_state),
            "data_gen": self.data_gen.get_state(),
            "fsdp_size": self.mesh.shape["fsdp"] if self._fsdp is not None else 1,
        }
        if self.mesh is not None:
            # every rank's augmentation generator, for a restore on this mesh
            ck["data_gens"] = [None] * self.mesh.size
            dist.all_gather_object(ck["data_gens"], self.data_gen.get_state())
        if self.primary:
            torch.save(ck, path)
        if self.mesh is not None:
            dist.barrier()

    def load_checkpoint(self, path: str) -> TrainState:
        """Restore a checkpoint of :meth:`save_checkpoint` into the model
        and return its state: packed state written at another fsdp size is
        resharded (``optim/compressed.py::reshard_packed_state``), and
        under FSDP this rank keeps its shards."""
        ck = torch.load(path, map_location=self.device, weights_only=True)
        params = from_saved(ck["params"])
        opt_state = from_saved(ck["opt_state"])
        comp = self.optim_comp
        want = self.mesh.shape["fsdp"] if self._fsdp is not None else 1
        if ck.get("fsdp_size", 1) != want and (comp.packed_weights or comp.packed_momentum):
            packed_smaq_params(comp)
            moved, opt_state = reshard_packed_state(
                params if comp.packed_weights else None, opt_state,
                _generator(self.cfg.seed), comp, want)
            params = moved if comp.packed_weights else params
        for n, b in self.model.named_buffers():
            b.copy_(ck["buffers"][n])
        gens = ck.get("data_gens")
        mine = ck["data_gen"] if not gens or self.mesh is None or len(gens) != self.mesh.size \
            else gens[self.mesh.rank]
        self.data_gen.set_state(mine.cpu())
        if self._fsdp is not None:
            return self._place(opt_state, params, ck["step"])
        packed = params if comp.packed_weights else None
        if packed is not None:
            self._load_params(packed)
        else:
            for n, p in self.model.named_parameters():
                p.data = params[n]
        return TrainState(ck["step"], opt_state, packed)

    def _drain(self, pending) -> bool:
        """Read pending metrics on the host and log them, a K-step entry
        (metrics with a leading K axis) as K steps; True if training must
        stop (non-finite loss)."""
        expanded = []
        for last, n, m in pending:
            host = {k: v.cpu().numpy() for k, v in m.items()}
            if n == 1:
                expanded.append((last, host))
            else:
                expanded.extend((last - n + 1 + i, {k: v[i] for k, v in host.items()})
                                for i in range(n))
        for s, host in expanded:
            scalars = {k: float(v) for k, v in host.items() if not k.startswith("_ratio/")}
            merge_compression_metrics(
                self.ratio_acc,
                {k.split("/", 1)[1]: v for k, v in host.items() if k.startswith("_ratio/")},
            )
            if self.primary:
                self.logger.log(s, scalars, echo=(s % (self.cfg.log_every * 4) == 0))
            if self.cfg.terminate_on_nan and not np.isfinite(scalars.get("train_loss", 0.0)):
                print(f"NaN/inf loss at step {s}; terminating.", flush=True)
                self.nan_terminated = True
                return True
        return False

    def evaluate(self, state: TrainState | None = None) -> dict[str, float]:
        """The task's validation metrics; one host read at the end.  Packed
        weights in ``state`` are decoded into the model first, FSDP shards
        gathered.  Under
        ``steps_per_call`` K batches go to one graph (K eager steps on the
        CPU), the leftover ones singly."""
        self._sync_model(state)
        spc = self.cfg.steps_per_call
        outs, labels_dev, group = [], [], []
        lim_val = self._resolve_limit(
            self.cfg.limit_val_batches, self.data.val_steps_per_epoch
        )
        for bi, (inputs, labels) in enumerate(self.data.device_val_batches(self.device)):
            if lim_val is not None and bi >= lim_val:
                break
            x = self.task.prepare_eval(inputs)
            labels_dev.append(labels)
            if spc > 1:
                group.append((x, labels))
                if len(group) == spc:
                    outs.append(self._eval_group(group))
                    group = []
            else:
                outs.append(stack_outputs([self.eval_step(x, labels)]))
        outs.extend(stack_outputs([self.eval_step(x, y)]) for x, y in group)
        if not outs:
            return {}
        host = {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
        labels_host = torch.cat(labels_dev).cpu().numpy()
        return self.task.eval_summary(host, labels_host, len(labels_host))


def run(trainer: Trainer, resume_from: str | None = None) -> dict:
    """Resume from a checkpoint if one is given, fit, evaluate, and print
    the final metrics with the compression ratios as one ``final: {...}``
    JSON line."""
    state = None
    if resume_from:
        state = trainer.load_checkpoint(resume_from)
        print(f"resumed from {resume_from} at step {state.step}")
    state = trainer.fit(state)
    final = trainer.evaluate(state)
    final.update(trainer.ratio_acc.summary())
    trainer.logger.close()
    if trainer.primary:
        print("final:", json.dumps(final))
    return final
