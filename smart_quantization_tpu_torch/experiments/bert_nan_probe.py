"""Where full-coverage SmaQ damages a BERT fine-tune: which parameter
leaves drift, and the extrema of Adam's state, on the port's BERT trainer.

The counterpart of ``experiments/bert_nan_probe.py``, with its flags plus
``--device`` (default ``cuda``) and the synthetic sizes: ``W =
--fp32_warmup_epochs`` epochs without compression (the stand-in for
pretrained weights; 0 probes a from-scratch run for its NaN), then
``--epochs`` of fine-tuning with SmaQ on every structure (AdamW; with
``--skip_nu``/``--skip_mu`` Adam's nu or mu passes the optimizer's
compressor unquantized), the validation correlation after every epoch,
and at the end the ``--top_k`` leaves by their largest drift from the
warm weights (absolute and against the leaf's largest warm value), the
leaves by their share of exact-zero nu, and the largest |mu|.  Prints the
report and one JSON line of it:

  python -m smart_quantization_tpu_torch.experiments.bert_nan_probe \\
      --fp32_warmup_epochs 60 --learning_rate 2e-5 --epochs 10
"""

from __future__ import annotations

import argparse
import json
import os


class _Selective:
    """The optimizer's compressor with its ``all_positive`` calls (Adam's
    nu) or its other calls (mu, and the gradients and weights) passed
    through unquantized."""

    def __init__(self, inner, skip_ap: bool, skip_not_ap: bool):
        self.inner, self.skip_ap, self.skip_not_ap = inner, skip_ap, skip_not_ap

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, x, gen, *, all_positive=False, **kw):
        from smart_quantization_tpu_torch.compress.base import SizeStats

        if (all_positive and self.skip_ap) or (not all_positive and self.skip_not_ap):
            return x, SizeStats.of(x.numel(), 32, 32, x.device)
        return self.inner(x, gen, all_positive=all_positive, **kw)


class _Curve:
    """The validation correlation of each epoch."""

    def __init__(self, label: str):
        self.label, self.history = label, []

    def log(self, step, scalars, echo=True):
        if "epoch" in scalars and "val_pearson_spearman_mean" in scalars:
            corr = float(scalars["val_pearson_spearman_mean"])
            self.history.append({"epoch": int(scalars["epoch"]), "val_corr": corr,
                                 "val_loss": float(scalars["val_loss"])})
            print(f"[{self.label}] epoch {int(scalars['epoch'])} corr={corr:.4f} "
                  f"val_loss={float(scalars['val_loss']):.4f}", flush=True)

    def close(self):
        pass


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--learning_rate", type=float, default=2e-5)
    ap.add_argument("--warmup_learning_rate", type=float, default=2e-4)
    ap.add_argument("--weight_decay", type=float, default=0.01)
    ap.add_argument("--epsilon", type=float, default=1e-8)
    ap.add_argument("--fp32_warmup_epochs", type=int, default=60)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--max_input_length", type=int, default=32)
    ap.add_argument("--train_n", type=int, default=4096)
    ap.add_argument("--val_n", type=int, default=512)
    ap.add_argument("--steps_per_call", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top_k", type=int, default=8)
    ap.add_argument("--skip_nu", action="store_true", help="pass Adam's nu through unquantized")
    ap.add_argument("--skip_mu", action="store_true", help="pass Adam's mu through unquantized")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the report here as well")
    return ap.parse_args(argv)


def _trainer(args, compress: bool, lr: float, epochs: int, logger):
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.data.glue import GLUEData
    from smart_quantization_tpu_torch.inject.tap import TapConfig
    from smart_quantization_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )
    from smart_quantization_tpu_torch.train.bert_loop import BertTrainer
    from smart_quantization_tpu_torch.train.loop import TrainConfig

    data = GLUEData(task="stsb", batch_size=args.batch_size, max_input_length=args.max_input_length,
                    synthetic_train=args.train_n, synthetic_val=args.val_n)
    comp = build_compressor("smart") if compress else None
    optim = None
    if compress:
        mom = (_Selective(comp, args.skip_nu, args.skip_mu) if args.skip_nu or args.skip_mu
               else comp)
        optim = OptimizerCompression(compressor=mom)
    model = BertForSequenceClassification(BertConfig.tiny(), num_labels=data.num_labels,
                                          tap=TapConfig(compressor=comp) if compress else None,
                                          seed=args.seed)
    return BertTrainer(
        model, data,
        build_optimizer("adamw", lr, weight_decay=args.weight_decay, epsilon=args.epsilon),
        task="stsb", optim_comp=optim,
        config=TrainConfig(epochs=epochs, log_every=10**9, seed=args.seed,
                           steps_per_call=args.steps_per_call),
        logger=logger, device=args.device)


def report(warm: dict, trainer, state, top_k: int) -> dict:
    """The leaves' drift from ``warm``, nu's exact zeros by leaf, and the
    largest |mu| (Adam's state of ``state``)."""
    import torch

    drifts = []
    for name, p in trainer.model.named_parameters():
        d = (p.detach() - warm[name]).abs().max().item()
        scale = warm[name].abs().max().item() + 1e-12
        drifts.append((d, d / scale, name))
    drifts.sort(reverse=True)
    inner = getattr(state.opt_state, "inner", state.opt_state)
    zero_nu = sorted(((float((v == 0).float().mean()), k) for k, v in inner["nu"].items()),
                     reverse=True)
    mu_max = max(float(v.abs().max()) for v in inner["mu"].values())
    nu_max = max(float(v.max()) for v in inner["nu"].values())
    finite = all(bool(torch.isfinite(p).all()) for p in trainer.model.parameters())
    return {"top_drift": [{"leaf": n, "abs": a, "rel_to_warm_max": r}
                          for a, r, n in drifts[:top_k]],
            "zero_nu_share": [{"leaf": n, "share": s} for s, n in zero_nu[:top_k]],
            "max_abs_mu": mu_max, "max_nu": nu_max, "params_finite": finite}


def main(argv=None) -> dict:
    # cuBLAS reads this at its first call: before torch touches the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from smart_quantization_tpu_torch import resolve_device
    from smart_quantization_tpu_torch.experiments import device_meta

    args = parse_args(argv)
    resolve_device(args.device)
    out = {"experiment": "bert_nan_probe", "fp32_warmup_epochs": args.fp32_warmup_epochs,
           "epochs": args.epochs, "learning_rate": args.learning_rate,
           **device_meta(args.device)}
    warm_trainer = _trainer(args, False, args.warmup_learning_rate, args.fp32_warmup_epochs,
                            _Curve("warmup"))
    if args.fp32_warmup_epochs:
        warm_trainer.fit()
    warm = {k: v.detach().clone() for k, v in warm_trainer.model.named_parameters()}

    curve = _Curve("finetune")
    trainer = _trainer(args, True, args.learning_rate, args.epochs, curve)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            p.copy_(warm[name])
    state = trainer.fit()
    out["nan_terminated"] = trainer.nan_terminated
    out["finetune_history"] = curve.history
    out.update(report(warm, trainer, state, args.top_k))
    print("--- top leaf drift (abs, rel-to-warm-max, leaf):")
    for d in out["top_drift"]:
        print(f"  {d['abs']:9.4f}  {d['rel_to_warm_max']:8.2f}x  {d['leaf']}")
    print("--- leaves by share of exact-zero nu:")
    for z in out["zero_nu_share"]:
        print(f"  {z['share']:6.3f}  {z['leaf']}")
    print(f"max|mu| = {out['max_abs_mu']:.3e}, max nu = {out['max_nu']:.3e}")
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
