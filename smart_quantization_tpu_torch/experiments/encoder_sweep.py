"""Encoder sweep on the port: train one model under each encoder and compare.

The counterpart of ``experiments/encoder_sweep.py`` (the reference's
Table-I shape: full-coverage compression of feature maps, gradient maps,
weights, gradients and momentum under smart/fp8/s2fp8/fp16/bf16/fp32),
with the same flags and defaults, the same JSON keys, and ``--device``
(default ``cuda``).  Real CIFAR is used only where it lies under
``$SMAQ_DATA_DIR``; the synthetic stand-in is made hard enough to separate
encoders with ``SMAQ_SYNTH_*`` (``data/cifar.py``), e.g. the settings of
the committed TPU run (``experiments/results/encoder_sweep_resnet18_synthetic.json``):

  SMAQ_SYNTH_TRAIN_N=8192 SMAQ_SYNTH_TEST_N=1024 SMAQ_SYNTH_SHIFT=6 \\
    python -m smart_quantization_tpu_torch.experiments.encoder_sweep \\
      --model resnet18 --epochs 40 --batch_size 128 --steps_per_call 16 \\
      --out smart_quantization_tpu_torch/experiments/results/encoder_sweep_resnet18_synthetic_h100.json

``--encoders`` runs a subset; ``--out`` is written after every encoder.
"""

from __future__ import annotations

import argparse
import json
import os
import time


class HistoryLogger:
    """A ``MetricLogger`` wrapper that keeps the per-epoch validation curve."""

    def __init__(self, inner):
        self.inner = inner
        self.history = []

    def log(self, step, scalars, echo=True):
        if "val_accuracy" in scalars and "epoch" in scalars:
            self.history.append({
                "epoch": int(scalars["epoch"]),
                "val_accuracy": round(float(scalars["val_accuracy"]), 4),
                "val_loss": round(float(scalars["val_loss"]), 4),
            })
        self.inner.log(step, scalars, echo=echo)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoders", nargs="+",
                    default=["fp32", "smart", "bf16", "fp8", "s2fp8", "fp16"])
    ap.add_argument("--model", default="tiny", choices=("tiny", "resnet18", "resnet34"))
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--val_batch_size", type=int)
    ap.add_argument("--learning_rate", type=float, default=0.1)
    ap.add_argument("--limit_train_batches", type=int)
    ap.add_argument("--steps_per_call", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="encoder_sweep_results.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run_encoder(args, enc: str) -> dict:
    """One encoder's run: its result entry."""
    import torch

    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.data.cifar import CIFAR10Data
    from smart_quantization_tpu_torch.experiments import tail
    from smart_quantization_tpu_torch.inject.tap import TapConfig
    from smart_quantization_tpu_torch.models.resnet import resnet18, resnet34
    from smart_quantization_tpu_torch.models.tiny import TinyCNN
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )
    from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer
    from smart_quantization_tpu_torch.train.metrics import MetricLogger

    model_fn = {"tiny": TinyCNN, "resnet18": resnet18, "resnet34": resnet34}[args.model]
    t0 = time.time()
    torch.manual_seed(args.seed)  # the model's initial weights
    comp = build_compressor(enc)
    tap = TapConfig(compressor=comp)
    data = CIFAR10Data(batch_size=args.batch_size, val_batch_size=args.val_batch_size)
    logger = HistoryLogger(MetricLogger(None))
    trainer = Trainer(
        model_fn(num_classes=10, tap=tap), data,
        build_optimizer("sgd", args.learning_rate, momentum=0.9),
        optim_comp=OptimizerCompression(compressor=comp),
        loss_compressor=comp,
        config=TrainConfig(
            epochs=args.epochs, log_every=50, measure_compression_ratio=True,
            limit_train_batches=args.limit_train_batches,
            steps_per_call=args.steps_per_call, seed=args.seed,
        ),
        logger=logger, device=args.device,
    )
    state = trainer.fit()
    val = trainer.evaluate(state)
    ratios = trainer.ratio_acc.summary()
    last = tail([h["val_accuracy"] for h in logger.history])
    return {
        "val_accuracy": val.get("val_accuracy"),
        "val_loss": val.get("val_loss"),
        "tail_mean_accuracy": round(sum(last) / len(last), 4) if last else None,
        "tail_min_accuracy": round(min(last), 4) if last else None,
        "tail_frac_below_half": round(sum(a < 0.5 for a in last) / len(last), 4) if last else None,
        "nan_terminated": trainer.nan_terminated,
        "compression_ratio": round(ratios.get("compression_ratio", 1.0), 3),
        "wall_s": round(time.time() - t0, 1),
        "history": logger.history,
    }


def main(argv=None) -> dict:
    # cuBLAS reads this at its first call: before torch touches the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from smart_quantization_tpu_torch import resolve_device
    from smart_quantization_tpu_torch.experiments import device_meta

    args = parse_args(argv)
    resolve_device(args.device)
    results = {"_meta": {
        "model": args.model,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "learning_rate": args.learning_rate,
        "seed": args.seed,
        **device_meta(args.device),
        "steps_per_call": args.steps_per_call,
        "synth_train_n": os.environ.get("SMAQ_SYNTH_TRAIN_N", "2048"),
        "synth_shift": os.environ.get("SMAQ_SYNTH_SHIFT", "default"),
        "coverage": "forward+backward+weights+gradients+momentum (full)",
    }}
    for enc in args.encoders:
        results[enc] = run_encoder(args, enc)
        r = results[enc]
        print(f"[{enc}] acc={r['val_accuracy']} ratio={r['compression_ratio']} "
              f"nan={r['nan_terminated']} wall={r['wall_s']} s", flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)  # written after every encoder

    print("\nencoder            val_acc  tail_mean   ratio   diverged")
    for enc, r in results.items():
        if enc.startswith("_"):
            continue
        acc = r["val_accuracy"]
        print(f"{enc:10s} {acc if acc is None else round(acc, 4)!s:>12} "
              f"{r['tail_mean_accuracy']!s:>10} "
              f"{r['compression_ratio']:>7} {r['nan_terminated']!s:>10}")
    return results


if __name__ == "__main__":
    main()
