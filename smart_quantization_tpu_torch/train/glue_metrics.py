"""GLUE metrics in plain numpy: a copy of
``smart_quantization_tpu/train/glue_metrics.py`` (the reference pulls
``datasets.load_metric('glue', task)``, models/bert.py:47-51)."""

from __future__ import annotations

import numpy as np


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a**2).sum() * (b**2).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def _ranks(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(len(x), dtype=np.float64)
    # average ties
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    return pearson(_ranks(np.asarray(a, np.float64)), _ranks(np.asarray(b, np.float64)))


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    return float((preds == labels).mean())


def f1(preds: np.ndarray, labels: np.ndarray) -> float:
    tp = float(((preds == 1) & (labels == 1)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def matthews(preds: np.ndarray, labels: np.ndarray) -> float:
    tp = float(((preds == 1) & (labels == 1)).sum())
    tn = float(((preds == 0) & (labels == 0)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0


def glue_metrics(task: str, preds: np.ndarray, labels: np.ndarray) -> dict[str, float]:
    if task == "stsb":
        p = pearson(preds, labels)
        s = spearman(preds, labels)
        # the headline number is mean(Pearson, Spearman) (BASELINE.md)
        return {"pearson": p, "spearmanr": s, "pearson_spearman_mean": (p + s) / 2}
    if task == "cola":
        return {"matthews_correlation": matthews(preds, labels)}
    if task in ("mrpc", "qqp"):
        return {"accuracy": accuracy(preds, labels), "f1": f1(preds, labels)}
    return {"accuracy": accuracy(preds, labels)}
