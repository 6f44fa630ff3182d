"""The single-device training loop.

Counterpart of ``smart_quantization_tpu/train/loop.py::Trainer`` without
its mesh and K-step branches (still to be ported, ROADMAP Queue 1 items
12 and 15).  A task (``train/task.py``) supplies what varies by model
family: batch preparation, the model's arguments, the loss and the eval
reduction.

- ``init_state`` builds the optimizer state (master weights, packed
  momentum) and, under ``--packed_weights``, the packed parameter tree,
  drawing from two generators of the seed (state encode, weight encode;
  the model's initial weights come from the seed where the model is
  built);
- ``train_step`` runs one step on a batch already prepared on the device:
  packed weights decoded into the model, tapped forward and backward, the
  compressed optimizer step, and the step's metrics as device tensors;
  between steps a packed leaf keeps no float32 copy in the model;
- ``fit`` drives epochs of device-side batches with NaN termination,
  ``limit_{train,val}_batches``, ``max_time``, ``log_every`` and a
  checkpoint every ``checkpoint_every_epochs`` epochs;
- ``evaluate`` reduces the validation split with one host read at the end;
- ``save_checkpoint``/``load_checkpoint`` write and read the port's own
  format (``torch.save``); a resumed run steps as the straight run does,
  since every step's generators derive from (seed, step);
- ``run`` is what the CLI does with a trainer: resume, fit, evaluate,
  report.

Between logging points a training step makes no device-to-host sync: every
random seed comes from host generators (the dropout masks' from a
generator on the device seeded on the host), every size stays on the
device, and metrics are read only when ``_drain`` logs them.  A parameter
that gets no gradient (BERT's encoder under ``freeze_encoder``) steps with
a zero gradient, as JAX's ``stop_gradient`` gives.

On CUDA the trainer turns TF32 off for cuDNN convolutions and matmuls
(``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.
allow_tf32``), so the card trains in full float32 like the reference, and
makes every kernel deterministic (:func:`make_reproducible`), so a seeded
run gives the same losses and parameters bit for bit, as the JAX package's
does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from smart_quantization_tpu_torch import resolve_device
from smart_quantization_tpu_torch.compress.base import SizeTotals
from smart_quantization_tpu_torch.inject.tap import TapContext
from smart_quantization_tpu_torch.ops.codebook import SmaQCodes
from smart_quantization_tpu_torch.optim.compressed import (
    OptimizerCompression,
    OptimizerSpec,
    compressed_optimizer_step,
    decode_params,
    encode_params,
    init_opt_state,
    norm_param_mask,
)
from smart_quantization_tpu_torch.train.metrics import (
    MetricLogger,
    RatioAccumulator,
    merge_compression_metrics,
)
from smart_quantization_tpu_torch.train.state import TrainState, from_saved, to_saved
from smart_quantization_tpu_torch.train.task import ImageClassificationTask


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


class Trainer:
    """Single-device trainer of a task (image classification by default)."""

    def __init__(
        self,
        model: torch.nn.Module,
        data,
        spec: OptimizerSpec,
        *,
        optim_comp: OptimizerCompression | None = None,
        config: TrainConfig = TrainConfig(),
        logger: MetricLogger | None = None,
        device: str | torch.device | None = None,
        task=None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            print("NOTE: TF32 is off for convolutions and matmuls; the card trains "
                  "in float32.")
            make_reproducible()
        self.model = model.to(self.device)
        self.data = data
        self.spec = spec
        self.task = task or ImageClassificationTask()
        self.optim_comp = optim_comp or OptimizerCompression()
        self.cfg = config
        self.logger = logger or MetricLogger(None)
        self.ratio_acc = RatioAccumulator()
        self.nan_terminated = False
        self.weight_exempt = norm_param_mask(n for n, _ in model.named_parameters())
        # augmentation draws on the device, from one generator per run
        self.data_gen = _generator(config.seed, self.device)
        # what a packed leaf of the model holds between steps
        self._released = torch.empty(0, device=self.device)

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
        """Host generators for the taps and the optimizer, and a generator
        on the device for the dropout masks, derived from (seed, step): the
        host never waits on the card for them."""
        s_fwd, s_opt, s_drop = np.random.SeedSequence([self.cfg.seed, step]).generate_state(
            3, np.uint64)
        return _generator(int(s_fwd)), _generator(int(s_opt)), _generator(int(s_drop), self.device)

    # ------------------------------------------------------------- steps
    def train_step(self, state: TrainState, inputs, labels: torch.Tensor) -> dict:
        """One step on a prepared batch (``task.prepare_train``'s output);
        updates the model and ``state`` in place and returns the step's
        metrics (device tensors; ``_ratio/{tag}`` entries hold
        ``[orig_bits, new_bits]``)."""
        gen_fwd, gen_opt, gen_drop = self._step_generators(state.step)
        sizes = SizeTotals() if self.cfg.measure_compression_ratio else None
        if state.packed_params is not None:
            self._load_params(state.packed_params)
        model = self.model
        model.train()
        logits = model(*self.task.model_args(inputs), TapContext(gen_fwd, sizes, gen_drop))
        loss = self.task.loss(logits, labels)
        named = list(model.named_parameters())
        for _, p in named:
            p.grad = None
        loss.backward()

        params = {n: p.detach() for n, p in named}
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in named}
        new_params, state.opt_state, opt_metrics = compressed_optimizer_step(
            self.spec, params, grads, state.opt_state, gen_opt, self.optim_comp,
            weight_exempt=self.weight_exempt,
        )
        if state.packed_params is not None:
            # the codes are the stored weights; the model keeps no float32
            # copy of a packed leaf until the next decode
            state.packed_params = new_params
            new_params = {n: self._released if isinstance(v, SmaQCodes) else v
                          for n, v in new_params.items()}
        for n, p in named:
            p.data = new_params[n]
            p.grad = None
        state.step += 1

        metrics = {"train_loss": loss.detach()}
        metrics.update(self.task.train_metrics(logits.detach(), labels))
        if sizes is not None:
            for tag, pair in {**sizes.totals, **opt_metrics}.items():
                metrics[f"_ratio/{tag}"] = pair
        return metrics

    @torch.no_grad()
    def eval_step(self, inputs, labels: torch.Tensor) -> dict:
        self.model.eval()
        # a constant generator per batch, as the JAX package's constant
        # eval key: the eval rounding noise is the same every epoch
        logits = self.model(*self.task.model_args(inputs), TapContext(_generator(0)))
        return self.task.eval_outputs(logits, labels)

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

    # -------------------------------------------------------------- loop
    def fit(self, state: TrainState | None = None) -> TrainState:
        if state is None:
            state = self.init_state()
        fit_t0 = time.time()

        def time_up() -> bool:
            return (
                self.cfg.max_time_s is not None
                and time.time() - fit_t0 >= self.cfg.max_time_s
            )

        lim_train = self._resolve_limit(
            self.cfg.limit_train_batches, self.data.steps_per_epoch
        )
        for epoch in range(self.cfg.epochs):
            t0 = time.time()
            pending = []  # (step, metrics) not yet read on the host
            batches = self.data.device_train_batches(self.cfg.seed + epoch, self.device)
            for bi, (inputs, labels) in enumerate(batches):
                if lim_train is not None and bi >= lim_train:
                    break
                x = self.task.prepare_train(inputs, self.data_gen)
                pending.append((state.step + 1, self.train_step(state, x, labels)))
                if state.step % self.cfg.log_every == 0:
                    if self._drain(pending):
                        return state
                    pending = []
                    if time_up():
                        print(f"max_time reached at step {state.step}; stopping.", flush=True)
                        return state
            if self._drain(pending):
                return state
            if time_up():
                print(f"max_time reached at step {state.step}; stopping.", flush=True)
                return state
            val = self.evaluate(state)
            val["epoch"] = epoch
            val["epoch_time_s"] = time.time() - t0
            val.update(self.ratio_acc.summary())
            self.logger.log(state.step, val)
            self._maybe_checkpoint(state, epoch)
        return state

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
        """Read pending metrics on the host and log them; True if training
        must stop (non-finite loss)."""
        for s, m in pending:
            host = {k: v.cpu().numpy() for k, v in m.items()}
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
        weights in ``state`` are decoded into the model first."""
        if state is not None and state.packed_params is not None:
            self._load_params(state.packed_params)
        outs, labels_dev = [], []
        lim_val = self._resolve_limit(
            self.cfg.limit_val_batches, self.data.val_steps_per_epoch
        )
        for bi, (inputs, labels) in enumerate(self.data.device_val_batches(self.device)):
            if lim_val is not None and bi >= lim_val:
                break
            outs.append(self.eval_step(self.task.prepare_eval(inputs), labels))
            labels_dev.append(labels)
        if not outs:
            return {}
        host = {k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
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
