"""K calls of a step, captured once into one CUDA graph and replayed.

The counterpart of the JAX package's ``lax.scan`` over K batches
(``smart_quantization_tpu/train/loop.py``, ``--steps_per_call``): one host
dispatch runs K steps.  A graph reads and writes fixed addresses, so:

- the K batches go into static slots (``inputs``/``labels`` with a leading
  K axis), each copied in on the device before a replay;
- each step's ``aux`` row (its key and scalars, ``ops/keys.py``) goes into
  a static ``[K, words]`` int64 buffer by one host-to-device copy from
  pinned memory;
- every tensor the step keeps (the model's parameters and buffers, the
  optimizer state) is updated in place by the step itself;
- the K steps' outputs go into static ``[K, ...]`` buffers, copied out
  after each replay, before the next one can overwrite them.

The first group warms up: its K steps run eagerly on the capture stream
(cuBLAS and cuDNN handles, the kernels' per-stream workspaces and their
build all come into being outside the capture), then the same K steps are
captured, which runs nothing; every later group is one replay.  A step that
synchronizes with the host (``.item()``, ``nonzero``, a pageable copy)
makes the capture raise: there is no eager fallback.
"""

from __future__ import annotations

import gc
from typing import Callable

import numpy as np
import torch


def tree_map(fn, tree):
    """``fn`` on a tensor, or on each value of a dict of tensors."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def stack_outputs(outs: list[dict]) -> dict:
    """Per-step output dicts as one dict with a leading step axis."""
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def to_device(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows on ``device`` without a sync: through pinned memory on the
    card (the pinned block is not reused before the copy has run)."""
    host = torch.from_numpy(np.ascontiguousarray(rows))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


class StepGraph:
    """``step(inputs, labels, aux)`` K times as one CUDA graph.

    ``step`` takes one batch's slots and its ``aux`` row (a 1-D int64
    device tensor, or None) and returns a dict of device tensors."""

    def __init__(self, k: int, step: Callable, device: torch.device):
        self.k = k
        self.step = step
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.inputs = self.labels = self.aux = self.out = None

    def _fill(self, batches, aux_rows) -> None:
        if self.inputs is None:
            x0, y0 = batches[0]
            self.inputs = tree_map(lambda t: torch.empty((self.k, *t.shape), dtype=t.dtype,
                                                         device=self.device), x0)
            self.labels = torch.empty((self.k, *y0.shape), dtype=y0.dtype, device=self.device)
            if aux_rows is not None:
                self.aux = torch.empty(aux_rows.shape, dtype=torch.int64, device=self.device)
        for j, (x, y) in enumerate(batches):
            if isinstance(x, dict):
                for name, t in x.items():
                    self.inputs[name][j].copy_(t)
            else:
                self.inputs[j].copy_(x)
            self.labels[j].copy_(y)
        if aux_rows is not None:
            self.aux.copy_(to_device(aux_rows, self.device), non_blocking=True)

    def _call(self, j: int) -> dict:
        x = tree_map(lambda t: t[j], self.inputs)
        return self.step(x, self.labels[j], None if self.aux is None else self.aux[j])

    def __call__(self, batches: list, aux_rows: np.ndarray | None = None) -> dict:
        """Run the K steps on ``batches`` (K ``(inputs, labels)`` pairs on
        the device) with ``aux_rows`` (``[K, words]`` int64 on the host);
        returns their outputs with a leading K axis."""
        if len(batches) != self.k:
            raise ValueError(f"a graph of {self.k} steps got {len(batches)} batches")
        self._fill(batches, aux_rows)
        if self.graph is None:
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                self.out = stack_outputs([self._call(j) for j in range(self.k)])
            cur.wait_stream(self.stream)
            graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a collected graph of
            # an earlier trainer would free its memory pool (cudaFree), which
            # a capture does not allow
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=self.stream):
                    for j in range(self.k):
                        for name, v in self._call(j).items():
                            self.out[name][j].copy_(v)
            finally:
                if collecting:
                    gc.enable()
            self.graph = graph
        else:
            self.graph.replay()
        return {name: v.clone() for name, v in self.out.items()}
