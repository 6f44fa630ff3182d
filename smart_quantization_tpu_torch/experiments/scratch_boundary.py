"""Where the from-scratch full-coverage boundary sits: how many epochs of
float32 warm-up rescue a full-coverage run under the stable momentum
codecs, on the port's BERT sweep.

The counterpart of ``experiments/scratch_boundary.py``, with its flags and
JSON keys, plus ``--device`` (default ``cuda``): for each warm-up length W
the budget stays ``--total_epochs`` (W float32 epochs, then the rest under
each encoder), through ``experiments/bert_sweep.py``'s ``main`` in this
process.  Arguments it does not know go to the sweep as they are (sizes:
``--train_n 256 --batch_size 32``):

  python -m smart_quantization_tpu_torch.experiments.scratch_boundary --out FILE
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def parse_args(argv=None) -> tuple[argparse.Namespace, list[str]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmups", nargs="+", type=int, default=[0, 5, 20, 40, 60])
    ap.add_argument("--total_epochs", type=int, default=100)
    ap.add_argument("--learning_rate", default="2e-4")
    ap.add_argument("--encoders", nargs="+", default=["fp32", "smart@rowmom,lognu"])
    ap.add_argument("--out", default="bert_scratch_boundary.json")
    ap.add_argument("--device", default="cuda")
    return ap.parse_known_args(argv)


def main(argv=None) -> dict:
    from smart_quantization_tpu_torch.experiments import bert_sweep, device_meta

    args, sweep_argv = parse_args(argv)
    merged = {"_meta": {
        "design": "total budget fixed at --total_epochs; W fp32 warmup epochs then "
                  "(total - W) under each encoder; the scratch regime's lr",
        "total_epochs": args.total_epochs,
        "learning_rate": args.learning_rate,
        "sweep_args": sweep_argv,
        **device_meta(args.device),
    }}
    for w in args.warmups:
        with tempfile.TemporaryDirectory(prefix="smaq_boundary_") as d:
            res = bert_sweep.main([
                "--fp32_warmup_epochs", str(w), "--epochs", str(args.total_epochs - w),
                "--learning_rate", args.learning_rate, "--encoders", *args.encoders,
                "--device", args.device, "--out", os.path.join(d, "sweep.json"), *sweep_argv])
        entry = {"warmup_epochs": w}
        if "warmup_final_correlation" in res["_meta"]:
            entry["warmup_final_corr"] = res["_meta"]["warmup_final_correlation"]
        for enc, r in res.items():
            if not enc.startswith("_"):
                entry[enc] = {k: r[k] for k in ("mean_correlation", "tail_mean_correlation",
                                                "compression_ratio", "nan_terminated")}
        merged[f"warmup{w}"] = entry
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=2)
        print(f"[boundary] warmup={w} done: "
              f"{json.dumps({k: v for k, v in entry.items() if k != 'warmup_epochs'})}",
              flush=True)
    print("\nwarmup  fp32_corr  smart_full_corr")
    for w in args.warmups:
        e = merged[f"warmup{w}"]
        fp = e.get("fp32", {}).get("mean_correlation")
        sm = e.get("smart@rowmom,lognu", {}).get("mean_correlation")
        print(f"{w:6d} {fp!s:>10} {sm!s:>16}")
    return merged


if __name__ == "__main__":
    main()
