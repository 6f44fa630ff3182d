"""The encoder sweeps' results side by side, labelled by where they ran.

The counterpart of ``experiments/summarize_sweeps.py``: for each
``encoder_sweep_*.json`` / ``bert_sweep_*.json`` it prints, per encoder,
the final metric, the tail mean and minimum (the last third of the
epochs), divergence and the compression ratio.  It reads both the JAX
package's TPU results (``experiments/results/``) and the port's
(``smart_quantization_tpu_torch/experiments/results/``), and heads each
file with its source: the package that wrote it and the backend (the
card and its power limit for the port's), so that no number of one
stands for the other:

  python -m smart_quantization_tpu_torch.experiments.summarize_sweeps [FILE ...]
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {
    "JAX package": os.path.join(os.path.dirname(os.path.dirname(HERE)), "experiments", "results"),
    "PyTorch port": os.path.join(HERE, "results"),
}


def source_of(path: str, meta: dict) -> str:
    """Which package wrote ``path`` and on what."""
    path = os.path.abspath(path)
    who = next((k for k, d in SOURCES.items() if path.startswith(d + os.sep)),
               "port" if "card" in meta else "JAX package")
    where = meta.get("backend")
    if meta.get("card"):
        where = f"{meta['card']}, {meta.get('power_limit')}"
    return f"{who}, {where}"


def tail_stats(history, key):
    vals = [h[key] for h in history if key in h]
    if not vals:
        return None, None
    tail = vals[-(max(len(vals) // 3, 1)):]
    return sum(tail) / len(tail), min(tail)


def sweep_files() -> list[str]:
    return [os.path.join(d, f) for d in SOURCES.values() if os.path.isdir(d)
            for f in sorted(os.listdir(d))
            if f.startswith(("encoder_sweep", "bert_sweep")) and f.endswith(".json")]


def summarize(path: str) -> dict:
    """One file's header and rows: (encoder, final, tail mean, tail min,
    ratio, diverged)."""
    with open(path) as f:
        r = json.load(f)
    meta = r.get("_meta", {})
    is_bert = "bert" in os.path.basename(path)
    key = "val_corr" if is_bert else "val_accuracy"
    rows = []
    for enc, v in r.items():
        if enc.startswith("_"):
            continue
        tm, tmin = tail_stats(v.get("history", []), key)
        rows.append((enc, v.get("mean_correlation" if is_bert else "val_accuracy"), tm, tmin,
                     v.get("compression_ratio"), v.get("nan_terminated")))
    return {"file": os.path.basename(path), "source": source_of(path, meta),
            "model": meta.get("model"), "epochs": meta.get("epochs"), "rows": rows}


def main(argv=None) -> list[dict]:
    files = (sys.argv[1:] if argv is None else argv) or sweep_files()
    out = []
    for path in files:
        s = summarize(path)
        out.append(s)
        print(f"\n== {s['file']} [{s['source']}] (model={s['model']}, epochs={s['epochs']})")
        print(f"{'encoder':20s} {'final':>8s} {'tail_mean':>10s} {'tail_min':>9s} "
              f"{'ratio':>6s} {'diverged':>9s}")
        for enc, final, tm, tmin, ratio, nan in s["rows"]:
            print(f"{enc:20s} {final!s:>8s} {'-' if tm is None else format(tm, '.4f'):>10s} "
                  f"{'-' if tmin is None else format(tmin, '.4f'):>9s} {ratio!s:>6} {nan!s:>9s}")
    return out


if __name__ == "__main__":
    main()
