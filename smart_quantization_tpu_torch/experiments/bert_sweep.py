"""BERT/STSB encoder sweep on the port: the second axis of the reference's
Table I (full-coverage compression of a BERT regression fine-tune under
each encoder: mean(Pearson, Spearman), compression ratio, NaN divergence).

The counterpart of ``experiments/bert_sweep.py``, with its flags, defaults,
encoder specs (``smart@nomom,lognu`` and the other ablation tokens of
``parse_encoder_spec``) and JSON keys, plus ``--device`` (default
``cuda``).  Pretrained bert-base and real GLUE are not available offline,
so it trains the tiny BERT config from scratch on synthetic STSB
(``data/glue.py``), or fine-tunes from ``--fp32_warmup_epochs`` of shared
FP32 training:

  python -m smart_quantization_tpu_torch.experiments.bert_sweep --epochs 30 \\
      --batch_size 64 --out bert_sweep_results.json
"""

from __future__ import annotations

import argparse
import json
import os
import time


class HistoryLogger:
    """Keeps the per-epoch validation correlation and loss."""

    def __init__(self):
        self.history = []

    def log(self, step, scalars, echo=True):
        if "val_pearson_spearman_mean" in scalars and "epoch" in scalars:
            self.history.append({
                "epoch": int(scalars["epoch"]),
                "val_corr": round(float(scalars["val_pearson_spearman_mean"]), 4),
                "val_loss": round(float(scalars["val_loss"]), 4),
            })

    def close(self):
        pass


# ablation token -> the coverage toggles it sets (see parse_encoder_spec)
_TOKENS = {
    "nofwd": {"compress_forward": False},
    "nobwd": {"compress_backward": False},
    "noweights": {"compress_weights": False},
    "nograds": {"compress_gradients": False},
    "nomom": {"compress_momentum": False},
    "nonu": {"skip_nu": True},
    "rowmom": {"rowwise": True},
    "lognu": {"log_nu": True},
    "rowlognu": {"log_nu": True, "log_nu_rowwise": True},
    "optonly": {"compress_forward": False, "compress_backward": False},
    "fwdonly": {"compress_backward": False, "compress_weights": False,
                "compress_gradients": False, "compress_momentum": False},
}


def parse_encoder_spec(spec: str):
    """``smart`` or ``smart@nomom,nofwd``: the base encoder and its coverage
    toggles.  Tokens: ``nofwd`` / ``nobwd`` (the forward / backward taps
    off), ``noweights`` / ``nograds`` / ``nomom`` (that optimizer structure
    off), ``nonu`` (Adam's nu, the only ``all_positive`` call, passes
    through), ``rowmom`` (``--momentum_rowwise``), ``lognu``
    (``--momentum_log_nu``), ``rowlognu`` (``--momentum_log_nu_rowwise``,
    implies ``lognu``), ``optonly`` (taps off), ``fwdonly`` (forward taps
    only)."""
    base, _, abl = spec.partition("@")
    toggles = {
        "compress_forward": True, "compress_backward": True,
        "compress_weights": True, "compress_gradients": True,
        "compress_momentum": True, "skip_nu": False, "rowwise": False,
        "log_nu": False, "log_nu_rowwise": False,
    }
    for tok in filter(None, abl.split(",")):
        if tok not in _TOKENS:
            raise ValueError(f"unknown ablation token {tok!r} in {spec!r}")
        toggles.update(_TOKENS[tok])
    return base, toggles


class SkipNu:
    """A compressor whose ``all_positive`` calls (exactly Adam's nu) pass
    through unquantized; every other call and attribute is the inner
    compressor's."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, x, gen, *, all_positive=False, **kw):
        from smart_quantization_tpu_torch.compress.base import SizeStats

        if all_positive:
            return x, SizeStats.of(x.numel(), 32, 32, x.device)
        return self.inner(x, gen, all_positive=all_positive, **kw)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoders", nargs="+",
                    default=["fp32", "smart", "bf16", "fp8", "s2fp8", "fp16"])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--val_batch_size", type=int, default=256)
    # AdamW as the reference fine-tunes (wd 0.01, eps 1e-8); its lr 2e-5 is
    # for pretrained bert-base, the from-scratch tiny config takes 2e-4
    ap.add_argument("--learning_rate", type=float, default=2e-4)
    ap.add_argument("--weight_decay", type=float, default=0.01)
    ap.add_argument("--epsilon", type=float, default=1e-8)
    ap.add_argument("--max_input_length", type=int, default=32)
    ap.add_argument("--train_n", type=int, default=4096)
    ap.add_argument("--val_n", type=int, default=1024)
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    # the stand-in for pretrained weights: W epochs of FP32 training (one
    # shared trajectory), then each encoder from those weights with a fresh
    # optimizer; 0 = from scratch
    ap.add_argument("--fp32_warmup_epochs", type=int, default=0)
    ap.add_argument("--warmup_learning_rate", type=float, default=None,
                    help="lr for the warmup phase (default: --learning_rate)")
    ap.add_argument("--warmup_ramp_epochs", type=int, default=0,
                    help="linear LR ramp 0 -> warmup_lr over the first N warmup epochs")
    # model dims (default: the tiny config); --hidden 768 --heads 12
    # --intermediate 3072 is bert-base's width
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--intermediate", type=int, default=128)
    ap.add_argument("--out", default="bert_sweep_results.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _data(args):
    from smart_quantization_tpu_torch.data.glue import GLUEData

    return GLUEData(task="stsb", batch_size=args.batch_size, val_batch_size=args.val_batch_size,
                    max_input_length=args.max_input_length, synthetic_train=args.train_n,
                    synthetic_val=args.val_n)


def _trainer(args, model_cfg, comp, cov, lr, epochs, logger, compress):
    """A BERT STSB trainer: the model from ``--seed``, AdamW at ``lr``, and
    with ``compress`` the encoder ``comp`` on the structures ``cov`` keeps."""
    from smart_quantization_tpu_torch.inject.tap import TapConfig
    from smart_quantization_tpu_torch.models.bert import BertForSequenceClassification
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )
    from smart_quantization_tpu_torch.train.bert_loop import BertTrainer
    from smart_quantization_tpu_torch.train.loop import TrainConfig

    data = _data(args)
    tap = optim = None
    if compress:
        tap = TapConfig(compressor=comp, compress_forward=cov["compress_forward"],
                        compress_backward=cov["compress_backward"])
        optim = OptimizerCompression(
            compressor=SkipNu(comp) if cov["skip_nu"] else comp,
            compress_weights=cov["compress_weights"],
            compress_gradients=cov["compress_gradients"],
            compress_momentum=cov["compress_momentum"],
            momentum_rowwise=cov["rowwise"], momentum_log_nu=cov["log_nu"],
            momentum_log_nu_rowwise=cov["log_nu_rowwise"],
        )
    model = BertForSequenceClassification(model_cfg, num_labels=data.num_labels, tap=tap,
                                          seed=args.seed)
    return BertTrainer(
        model, data,
        build_optimizer("adamw", lr, weight_decay=args.weight_decay, epsilon=args.epsilon),
        task="stsb", optim_comp=optim, loss_compressor=comp if compress else None,
        config=TrainConfig(epochs=epochs, log_every=200, measure_compression_ratio=compress,
                           steps_per_call=args.steps_per_call, seed=args.seed),
        logger=logger, device=args.device,
    )


def main(argv=None) -> dict:
    # cuBLAS reads this at its first call: before torch touches the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from smart_quantization_tpu_torch import resolve_device
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.experiments import device_meta, tail
    from smart_quantization_tpu_torch.models.bert import BertConfig

    args = parse_args(argv)
    resolve_device(args.device)
    results = {"_meta": {
        "model": "bert-tiny (from scratch; pretrained weights are offline-unavailable)",
        "task": "stsb-synthetic",
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "learning_rate": args.learning_rate,
        "weight_decay": args.weight_decay,
        "epsilon": args.epsilon,
        "seed": args.seed,
        **device_meta(args.device),
        "coverage": "forward+backward+weights+gradients+momentum (full) "
                    "unless the encoder spec carries @ablations",
        "model_dims": f"L{args.layers} H{args.hidden} A{args.heads} I{args.intermediate}",
    }}
    model_cfg = BertConfig(vocab_size=30522, hidden_size=args.hidden, num_layers=args.layers,
                           num_heads=args.heads, intermediate_size=args.intermediate,
                           max_position_embeddings=512)

    warm = None
    if args.fp32_warmup_epochs > 0:
        wlr = args.warmup_learning_rate or args.learning_rate
        if args.warmup_ramp_epochs > 0:
            ramp = args.warmup_ramp_epochs * max(args.train_n // args.batch_size, 1)
            peak = wlr
            wlr = lambda count: peak * min(count / ramp, 1.0)  # noqa: E731
        wlogger = HistoryLogger()
        wtrainer = _trainer(args, model_cfg, None, None, wlr, args.fp32_warmup_epochs,
                            wlogger, compress=False)
        wval = wtrainer.evaluate(wtrainer.fit())
        warm = {k: v.detach().clone() for k, v in wtrainer.model.state_dict().items()}
        results["_meta"].update({
            "fp32_warmup_epochs": args.fp32_warmup_epochs,
            "warmup_ramp_epochs": args.warmup_ramp_epochs,
            "warmup_final_correlation": round(
                wval.get("val_pearson_spearman_mean", float("nan")), 4),
            "warmup_history": wlogger.history,
        })
        print(f"[warmup] {args.fp32_warmup_epochs} fp32 epochs -> "
              f"corr={results['_meta']['warmup_final_correlation']}", flush=True)

    for enc in args.encoders:
        t0 = time.time()
        base, cov = parse_encoder_spec(enc)
        logger = HistoryLogger()
        trainer = _trainer(args, model_cfg, build_compressor(base), cov, args.learning_rate,
                           args.epochs, logger, compress=True)
        if warm is not None:
            trainer.model.load_state_dict(warm)
        val = trainer.evaluate(trainer.fit())
        ratios = trainer.ratio_acc.summary()
        mean_corr = (round(val["val_pearson_spearman_mean"], 4)
                     if "val_pearson_spearman_mean" in val else None)
        last = tail([h["val_corr"] for h in logger.history])
        results[enc] = {
            # the reference's Table-I metric: mean(Pearson, Spearman)
            "mean_correlation": mean_corr,
            "val_pearson": val.get("val_pearson"),
            "val_spearman": val.get("val_spearmanr"),
            "val_loss": val.get("val_loss"),
            "tail_mean_correlation": round(sum(last) / len(last), 4) if last else None,
            "nan_terminated": trainer.nan_terminated,
            "compression_ratio": round(ratios.get("compression_ratio", 1.0), 3),
            "wall_s": round(time.time() - t0, 1),
            "history": logger.history,
        }
        print(f"[{enc}] corr={mean_corr} ratio={results[enc]['compression_ratio']} "
              f"nan={results[enc]['nan_terminated']}", flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)

    print("\nencoder      mean_corr  tail_corr   ratio   diverged")
    for enc, r in results.items():
        if enc.startswith("_"):
            continue
        print(f"{enc:10s} {r['mean_correlation']!s:>10} {r['tail_mean_correlation']!s:>10} "
              f"{r['compression_ratio']:>7} {r['nan_terminated']!s:>10}")
    return results


if __name__ == "__main__":
    main()
