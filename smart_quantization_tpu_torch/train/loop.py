"""The single-device training loop.

Counterpart of ``smart_quantization_tpu/train/loop.py::Trainer`` without
its mesh branches (still to be ported, ROADMAP Queue 1 item 15).  A task
(``train/task.py``) supplies what varies by model family: batch
preparation, the model's arguments, the loss and the eval reduction.

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

import numpy as np
import torch

from smart_quantization_tpu_torch import resolve_device
from smart_quantization_tpu_torch.compress.base import CompressorBase, SizeTotals
from smart_quantization_tpu_torch.inject.tap import TapContext, compress_loss
from smart_quantization_tpu_torch.ops.codebook import SmaQCodes
from smart_quantization_tpu_torch.ops.keys import DeviceKey, as_int64, key_tensor, step_key
from smart_quantization_tpu_torch.optim.compressed import (
    CompressedOptState,
    OptimizerCompression,
    OptimizerSpec,
    compressed_optimizer_step,
    decode_params,
    encode_params,
    init_opt_state,
    norm_param_mask,
)
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
# the next two words.
AUX_WORDS = 3
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


def _inner(opt_state) -> dict:
    return opt_state.inner if isinstance(opt_state, CompressedOptState) else opt_state


class Trainer:
    """Single-device trainer of a task (image classification by default)."""

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
    ):
        if config.steps_per_call < 1:
            raise ValueError(f"--steps_per_call must be 1 or more, got {config.steps_per_call}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            # bfloat16 products accumulate in float32 throughout, as XLA's do
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            print("NOTE: TF32 is off for convolutions and matmuls; the card trains "
                  "in the model's compute dtype with float32 accumulation.")
            make_reproducible()
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
        # augmentation draws on the device, from one generator per run
        self.data_gen = _generator(config.seed, self.device)
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
        parameters, whose decoded view the model then holds."""
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        words = np.random.SeedSequence(self.cfg.seed, spawn_key=(1,)).generate_state(2, np.uint64)
        gen_state, gen_weights = (_generator(int(w)) for w in words)
        opt_state = init_opt_state(self.spec, params, self.optim_comp, gen_state)
        packed = None
        if self.optim_comp.packed_weights:
            packed = encode_params(params, self.optim_comp, gen_weights, exempt=self.weight_exempt)
            self._load_params(packed)
        return TrainState(0, opt_state, packed)

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

    def _aux_rows(self, state: TrainState, n: int) -> np.ndarray:
        """The next ``n`` steps' rows on the card: each step's key, then its
        optimizer scalars as float32 words."""
        rows = np.zeros((n, AUX_WORDS), np.int64)
        count = _inner(state.opt_state)["count"]
        for j in range(n):
            rows[j, 0] = as_int64([step_key(self.cfg.seed, state.step + j)])[0]
            rows[j, 1:].view(np.float32)[:3] = self.spec.step_scalars(count + j)
        return rows

    def _advance(self, state: TrainState, n: int) -> None:
        """The host's count of ``n`` steps taken."""
        state.step += n
        _inner(state.opt_state)["count"] += n

    # ------------------------------------------------------------- steps
    def _step(self, state: TrainState, inputs, labels: torch.Tensor, aux) -> dict:
        """One step's computation: reads the model's and ``state``'s tensors
        and writes them in place, so that a graph of it replays on fixed
        addresses; the host's step count is the caller's.  ``aux`` is the
        step's row on the card (``_aux_rows``), or its host generators."""
        if self._on_card:
            key = DeviceKey(aux[0:1])
            gen_fwd = gen_opt = gen_drop = key
            scalars = aux[1:].view(torch.float32)
        else:
            (gen_fwd, gen_opt, gen_drop), scalars = aux, None
        sizes = SizeTotals() if self.cfg.measure_compression_ratio else None
        if state.packed_params is not None:
            self._load_params(state.packed_params)
        model = self.model
        model.train()
        logits = model(*self.task.model_args(inputs), TapContext(gen_fwd, sizes, gen_drop))
        loss = self.task.loss(logits, labels)
        if self.cfg.compress_loss and self.loss_compressor is not None:
            loss = compress_loss(loss, self.loss_compressor, gen_fwd)
        named = list(model.named_parameters())
        for _, p in named:
            p.grad = None
        loss.backward()

        params = {n: p.detach() for n, p in named}
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in named}
        grad_norm = None
        if self.cfg.measure_average_grad_norm:
            # the raw gradients' norms in one fused launch; no host sync
            grad_norm = torch.stack(torch._foreach_norm(list(grads.values()))).mean()
        new_params, opt_state, opt_metrics = compressed_optimizer_step(
            self.spec, params, grads, state.opt_state, gen_opt, self.optim_comp,
            weight_exempt=self.weight_exempt, scalars=scalars,
        )
        with torch.no_grad():
            _assign(state.opt_state, opt_state)
            if state.packed_params is not None:
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
        if sizes is not None:
            for tag, pair in {**sizes.totals, **opt_metrics}.items():
                metrics[f"_ratio/{tag}"] = pair
        return metrics

    def train_step(self, state: TrainState, inputs, labels: torch.Tensor) -> dict:
        """One step on a prepared batch (``task.prepare_train``'s output);
        updates the model and ``state`` in place and returns the step's
        metrics (device tensors; ``_ratio/{tag}`` entries hold
        ``[orig_bits, new_bits]``)."""
        if self._on_card:
            aux = to_device(self._aux_rows(state, 1)[0], self.device)
        else:
            aux = self._step_generators(state.step)
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
        self.model.eval()
        logits = self.model(*self.task.model_args(inputs), self._eval_tap_context())
        return self.task.eval_outputs(logits, labels)

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
            return (
                self.cfg.max_time_s is not None
                and time.time() - fit_t0 >= self.cfg.max_time_s
            )

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
                    x = self.task.prepare_train(inputs, self.data_gen)
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
                self.logger.log(state.step, val)
                self._maybe_checkpoint(state, epoch)
            return state
        finally:
            self._stop_profile(state)

    def _maybe_checkpoint(self, state: TrainState, epoch: int) -> None:
        if not self.cfg.checkpoint_dir or (epoch + 1) % self.cfg.checkpoint_every_epochs:
            return
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        self.save_checkpoint(os.path.join(self.cfg.checkpoint_dir, f"epoch_{epoch:04d}.pt"), state)

    def save_checkpoint(self, path: str, state: TrainState) -> None:
        """Write the port's checkpoint (``torch.save``): the step, the
        parameters (packed leaves as their uint8 codes and stats), the
        model's buffers, the optimizer state with any master weights, and
        the augmentation generator's state."""
        params = state.packed_params
        if params is None:
            params = {n: p.detach() for n, p in self.model.named_parameters()}
        torch.save({
            "step": state.step,
            "params": to_saved(params),
            "buffers": dict(self.model.named_buffers()),
            "opt_state": to_saved(state.opt_state),
            "data_gen": self.data_gen.get_state(),
        }, path)

    def load_checkpoint(self, path: str) -> TrainState:
        """Restore a checkpoint of :meth:`save_checkpoint` into the model
        and return its state."""
        ck = torch.load(path, map_location=self.device, weights_only=True)
        params = from_saved(ck["params"])
        packed = params if self.optim_comp.packed_weights else None
        if packed is not None:
            self._load_params(packed)
        else:
            for n, p in self.model.named_parameters():
                p.data = params[n]
        for n, b in self.model.named_buffers():
            b.copy_(ck["buffers"][n])
        self.data_gen.set_state(ck["data_gen"].cpu())
        return TrainState(ck["step"], from_saved(ck["opt_state"]), packed)

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
            self.logger.log(s, scalars, echo=(s % (self.cfg.log_every * 4) == 0))
            if self.cfg.terminate_on_nan and not np.isfinite(scalars.get("train_loss", 0.0)):
                print(f"NaN/inf loss at step {s}; terminating.", flush=True)
                self.nan_terminated = True
                return True
        return False

    def evaluate(self, state: TrainState | None = None) -> dict[str, float]:
        """The task's validation metrics; one host read at the end.  Packed
        weights in ``state`` are decoded into the model first.  Under
        ``steps_per_call`` K batches go to one graph (K eager steps on the
        CPU), the leftover ones singly."""
        if state is not None and state.packed_params is not None:
            self._load_params(state.packed_params)
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
    print("final:", json.dumps(final))
    return final
