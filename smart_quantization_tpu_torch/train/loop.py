"""The single-device training loop.

Counterpart of ``smart_quantization_tpu/train/loop.py::Trainer`` without
its mesh, K-step and checkpoint branches (still to be ported, ROADMAP
Queue 1 items 11, 12 and 15).  A task (``train/task.py``) supplies what
varies by model family: batch preparation, the model's arguments, the loss
and the eval reduction.

- ``train_step`` runs one step on a batch already prepared on the device:
  tapped forward and backward, the compressed optimizer step, and the
  step's metrics as device tensors;
- ``fit`` drives epochs of device-side batches with NaN termination,
  ``limit_{train,val}_batches``, ``max_time`` and ``log_every``;
- ``evaluate`` reduces the validation split with one host read at the end;
- ``run`` is what the CLI does with a trainer: fit, evaluate, report.

Between logging points a training step makes no device-to-host sync: every
random seed comes from host generators (the dropout masks' from a
generator on the device seeded on the host), every size stays on the
device, and metrics are read only when ``_drain`` logs them.  A parameter
that gets no gradient (BERT's encoder under ``freeze_encoder``) steps with
a zero gradient, as JAX's ``stop_gradient`` gives.

On CUDA the trainer turns TF32 off for cuDNN convolutions and matmuls
(``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.
allow_tf32``), so the card trains in full float32 like the reference.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from smart_quantization_tpu_torch import resolve_device
from smart_quantization_tpu_torch.compress.base import SizeTotals
from smart_quantization_tpu_torch.inject.tap import TapContext
from smart_quantization_tpu_torch.optim.compressed import (
    OptimizerCompression,
    OptimizerSpec,
    compressed_optimizer_step,
    norm_param_mask,
)
from smart_quantization_tpu_torch.train.metrics import (
    MetricLogger,
    RatioAccumulator,
    merge_compression_metrics,
)
from smart_quantization_tpu_torch.train.state import TrainState
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
        )


def _generator(seed: int, device: torch.device | str = "cpu") -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


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

    def init_state(self) -> TrainState:
        params = {n: p.detach() for n, p in self.model.named_parameters()}
        return TrainState(0, self.spec.init(params))

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
            val = self.evaluate()
            val["epoch"] = epoch
            val["epoch_time_s"] = time.time() - t0
            val.update(self.ratio_acc.summary())
            self.logger.log(state.step, val)
        return state

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

    def evaluate(self) -> dict[str, float]:
        """The task's validation metrics; one host read at the end."""
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


def run(trainer: Trainer) -> dict:
    """Fit, evaluate, and print the final metrics with the compression
    ratios as one ``final: {...}`` JSON line."""
    trainer.fit()
    final = trainer.evaluate()
    final.update(trainer.ratio_acc.summary())
    trainer.logger.close()
    print("final:", json.dumps(final))
    return final
