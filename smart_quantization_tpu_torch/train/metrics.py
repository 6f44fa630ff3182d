"""Metrics: the compression-ratio accounting and the run logger.

Counterpart of ``smart_quantization_tpu/train/metrics.py``: per-tag
``compression_ratio_{tag}``, ``new_size_{tag}``, ``orig_size_{tag}`` summed
over steps, plus the global ``compression_ratio``.  Sizes arrive as device
tensors in each step's metrics and are read on the host only at the
trainer's logging points.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Mapping

import numpy as np


class RatioAccumulator:
    """Host-side per-tag size accumulator."""

    def __init__(self):
        self.orig = collections.defaultdict(float)
        self.new = collections.defaultdict(float)

    def add(self, tag: str, orig_bits: float, new_bits: float) -> None:
        self.orig[tag] += float(orig_bits)
        self.new[tag] += float(new_bits)

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {}
        tot_o = tot_n = 0.0
        for tag in self.orig:
            o, n = self.orig[tag], self.new[tag]
            tot_o += o
            tot_n += n
            out[f"orig_size_{tag}"] = o
            out[f"new_size_{tag}"] = n
            if n > 0:
                out[f"compression_ratio_{tag}"] = o / n
        if tot_n > 0:
            out["compression_ratio"] = tot_o / tot_n
            out["orig_size"] = tot_o
            out["new_size"] = tot_n
        return out


def merge_compression_metrics(
    acc: RatioAccumulator, step_metrics: Mapping[str, np.ndarray]
) -> None:
    """Fold host copies of the per-step (orig, new) pairs into ``acc``."""
    for tag, pair in step_metrics.items():
        pair = np.asarray(pair)
        acc.add(tag, float(pair[0]), float(pair[1]))


class MetricLogger:
    """JSONL + stdout logger, plus TensorBoard event files when
    ``torch.utils.tensorboard`` imports (opt out with ``tensorboard=False``
    or ``SMAQ_DISABLE_TB=1``)."""

    def __init__(self, logdir: str | None, name: str = "run", tensorboard: bool = True):
        self.logdir = logdir
        self._fh = None
        self._tb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._fh = open(os.path.join(logdir, f"{name}.metrics.jsonl"), "a")
            if tensorboard and not os.environ.get("SMAQ_DISABLE_TB"):
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None  # JSONL only
                if SummaryWriter is not None:
                    self._tb = SummaryWriter(log_dir=os.path.join(logdir, name))
        self._t0 = time.time()

    def header(self, info: Mapping[str, str]) -> None:
        """Write a one-off run-metadata line ``{"header": {...}}`` (the git
        commit ``--git`` records), and the same as TensorBoard text."""
        if self._fh:
            self._fh.write(json.dumps({"header": dict(info)}) + "\n")
            self._fh.flush()
        if self._tb is not None:
            self._tb.add_text("run_info", "\n".join(f"{k}: {v}" for k, v in info.items()), 0)

    def log(self, step: int, scalars: Mapping[str, float], echo: bool = True) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        rec.update(
            {k: (float(v) if np.isfinite(v) else str(v)) for k, v in scalars.items()}
        )
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                if np.isfinite(v):
                    self._tb.add_scalar(k, float(v), int(step))
            self._tb.flush()
        if echo:
            print(
                " ".join(
                    f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in rec.items()
                    if k != "time"
                ),
                flush=True,
            )

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()


def rank_logger(args, mesh=None) -> MetricLogger:
    """:func:`run_logger` on rank 0 of a mesh (or without one); a logger
    that writes nothing on the other ranks."""
    if mesh is not None and mesh.rank != 0:
        return MetricLogger(None)
    return run_logger(args)


def run_logger(args) -> MetricLogger:
    """The logger of a parsed command line, with the header line of the
    commit ``--git`` recorded (``args.git_commit``)."""
    logger = MetricLogger(args.logdir, args.name)
    commit = getattr(args, "git_commit", None)
    if commit:
        logger.header({"git_commit": commit, "name": args.name})
    return logger
