"""Data parallelism: the gradient exchange and what the step reduces over
the ranks.

Counterpart of ``smart_quantization_tpu/parallel/train_dp.py``'s
``make_dp_train_step``, whose ``shard_map`` body the trainer's step
(``train/loop.py``) follows with explicit collectives after ``backward()``:
each rank runs the forward and backward on its rows of the global batch,
then

- the gradients go through the exchange (:class:`DataParallel`): a
  float32 mean with ``grad_allreduce_bits=None``, else the int8 gather or
  psum collective of ``parallel/collectives.py``, with a key shared by
  every rank;
- the BatchNorm running statistics are averaged over the ranks
  (:func:`average_buffers`; ``num_batches_tracked`` is not);
- the loss and the task's metrics are averaged, the taps' size pairs
  summed, the optimizer's counted once (it runs replicated:
  :func:`reduce_metrics`);
- the compressed optimizer step runs on every rank with the shared key, so
  the replicas stay bitwise equal.

Gradient-exchange traffic (bytes sent per gradient element per rank, ring
algorithms; the scales, 4 B per 1024 elements, are left out):

    mode                      payload     B/elem(n)        n=4    n=8    n=32
    fp32 mean                 fp32        8(n-1)/n         6.0    7.0    7.75
    gather (allreduce_mean)   int8 x n    (n-1)            3.0    7.0    31.0
    psum  (headroom grid)     int8        2(n-1)/n         1.5    1.75   1.94

``auto`` takes gather below 8 ``data`` ranks and psum from 8 up, so the
exchange never moves more than float32 would.  Payload bits below 8 keep
the one-byte payload: precision only, not traffic.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from smart_quantization_tpu_torch.parallel.collectives import (
    _check_bits,
    _recip,
    compressed_allreduce_mean,
    compressed_psum_mean_chunked,
)

MODES = ("auto", "gather", "psum")


def resolve_mode(mode: str, data_size: int) -> str:
    """``auto`` as gather below 8 ``data`` ranks and psum from 8 up."""
    if mode not in MODES:
        raise ValueError(f"grad_allreduce_mode {mode!r} (expected auto|gather|psum)")
    if mode == "auto":
        return "psum" if data_size >= 8 else "gather"
    return mode


def exchange_bytes(n_elems: int, n: int, bits: int | None, mode: str) -> float:
    """Bytes one rank sends a step to exchange ``n_elems`` gradient
    elements over ``n`` ranks (the traffic table above)."""
    if bits is None:
        return n_elems * 8.0 * (n - 1) / n
    if resolve_mode(mode, n) == "psum":
        return n_elems * 2.0 * (n - 1) / n
    return n_elems * float(n - 1)


def flat_mean(tree: dict, group, n: int) -> dict:
    """The float32 mean of every leaf over ``group`` (``jax.lax.pmean``),
    in one all-reduce."""
    flat = torch.cat([g.reshape(-1).float() for g in tree.values()])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat * _recip(n)
    out, at = {}, 0
    for k, g in tree.items():
        out[k] = flat[at:at + g.numel()].reshape(g.shape).to(g.dtype)
        at += g.numel()
    return out


def average_buffers(model: torch.nn.Module, group, n: int) -> None:
    """Average the BatchNorm running statistics over ``group``, in place
    (JAX averages ``batch_stats``; the batch counter is left alone)."""
    bufs = [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]
    if not bufs:
        return
    flat = torch.cat([b.reshape(-1) for b in bufs])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat * _recip(n)
    at = 0
    with torch.no_grad():
        for b in bufs:
            b.copy_(flat[at:at + b.numel()].view_as(b))
            at += b.numel()


def reduce_metrics(metrics: dict, summed: dict, world, n: int, once: dict,
                   once_group=None) -> dict:
    """A step's metrics over the ranks, in one all-reduce over ``world``:
    ``metrics`` (0-d) averaged, ``summed`` (the taps' size pairs) summed;
    ``once`` (the optimizer's size pairs) summed over ``once_group``, or
    kept (replicated state counts once)."""
    names, pairs = list(metrics), list(summed)
    flat = torch.cat([torch.stack([metrics[k].float().reshape(()) for k in names]),
                      *[summed[k].float().reshape(-1) for k in pairs]])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=world)
    out = {k: flat[i] * _recip(n) for i, k in enumerate(names)}
    at = len(names)
    for k in pairs:
        out[k] = flat[at:at + summed[k].numel()].view_as(summed[k])
        at += summed[k].numel()
    if once and once_group is not None:
        stacked = torch.stack([v.float() for v in once.values()])
        dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=once_group)
        once = dict(zip(once, stacked))
    out.update(once)
    return out


class DataParallel:
    """The gradient exchange over a mesh's ``data`` group: float32 mean
    (``bits=None``), or int8 in ``gather``/``psum``/``auto`` mode."""

    def __init__(self, mesh, bits: int | None = 8, mode: str = "auto"):
        self.bits = None if bits is None else _check_bits(bits)
        self.n = mesh.shape["data"]
        self.mode = resolve_mode(mode, self.n)
        self.group = mesh.group("data")

    def exchange(self, grads: dict, gen) -> dict:
        """The mean of ``grads`` over the ``data`` ranks; ``gen`` is the
        payload's rounding key, the same on every rank."""
        if self.bits is None:
            return flat_mean(grads, self.group, self.n)
        if self.mode == "psum":
            return compressed_psum_mean_chunked(grads, self.group, gen, bits=self.bits)
        return compressed_allreduce_mean(grads, self.group, gen, bits=self.bits)
