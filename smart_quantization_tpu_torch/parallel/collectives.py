"""Quantized-gradient collectives on ``torch.distributed``.

Counterpart of ``smart_quantization_tpu/parallel/collectives.py``, function
for function.  A process group (or a tuple of them, reduced over in turn)
takes the place of the JAX axis name; ``Mesh.group`` gives them.  Each
rank quantizes its local tensor to an int8 payload with float32 scales,
the payload crosses the wire, and the dequantize and sum run after it:
4x less traffic than float32 at 8 bits.

- ``gen=None`` rounds half to even (``torch.round``, as ``jnp.round``);
  a ``torch.Generator`` or a step key (``ops/keys.py::DeviceKey``) gives
  stochastic rounding, ``floor(t) + (frac(t) > u)``, from the port's own
  noise (``ops/rounding.py``; on the card the Philox fill), so its draws
  differ from JAX's stream;
- the gather forms all-gather the int8 codes and the scales and sum the
  ranks' dequantized payloads in rank order in float32, as JAX's sum over
  the gathered axis does;
- the psum forms agree on the scale with an ``all_reduce(MAX)`` and sum
  the int8 headroom grid ``floor(qmax / n)`` with ``all_reduce(SUM)``:
  n ranks' codes can never overflow int8;
- ``bits`` must lie in 2..8.  The JAX package wraps the int8 payload above
  8 bits; here that raises.  Below 8 bits the payload is still one byte an
  element: fewer bits cut the precision only, not the traffic.

The tree forms (``compressed_allreduce_mean``, ``compressed_psum_mean``,
``compressed_psum_mean_chunked``) take a dict of tensors and quantize each
leaf on its own, exactly as JAX's ``tree.map`` does (every leaf padded to
whole 1024-element chunks), but move the whole tree in one collective of
each kind: the leaves' chunks are concatenated, which changes no value.
Each draws its rounding noise for the tree at once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from smart_quantization_tpu_torch.ops.rounding import uniform

_CHUNK = 1024  # elements per quantization group (per-chunk scales)

# the tensor forms of all-gather and reduce-scatter (named *_single from
# torch 2.13 on, *_tensor before)
all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

Tree = dict[str, torch.Tensor]


def _recip(*consts: int) -> float:
    """The float32 reciprocal of a constant, or the float32 product of the
    reciprocals of several: XLA computes ``x / c`` as ``x * (1/c)`` and
    folds ``(x * (1/a)) * (1/b)`` into one constant, and the port follows
    its arithmetic, so that the int8 paths agree with JAX bitwise."""
    out = np.float32(1.0)
    for c in consts:
        out = np.float32(out * (np.float32(1.0) / np.float32(c)))
    return float(out)


def _check_bits(bits: int) -> int:
    if not 2 <= int(bits) <= 8:
        raise ValueError(f"collective payloads are int8: bits must lie in 2..8, got {bits}")
    return int(bits)


def _groups(group) -> tuple:
    return tuple(group) if isinstance(group, (tuple, list)) else (group,)


def _axis_prod(group) -> int:
    """Ranks across one group or a tuple of groups."""
    n = 1
    for g in _groups(group):
        n *= dist.get_world_size(g)
    return n


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    for g in _groups(group):
        dist.all_reduce(t, op=op, group=g)
    return t


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` in group-rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    all_gather_single(out, t.contiguous(), group=group)
    return out.view(n, *t.shape)


def _round(t: torch.Tensor, gen) -> torch.Tensor:
    if gen is None:
        return torch.round(t)
    floored = torch.floor(t)
    return floored + ((t - floored) > uniform(t.shape, gen, t.device)).to(torch.float32)


def _chunks(flat: torch.Tensor) -> torch.Tensor:
    """A flat float32 buffer zero-padded to whole chunks, ``[chunks, CHUNK]``."""
    pad = (-flat.numel()) % _CHUNK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, _CHUNK)


def _quantize_groups(groups: torch.Tensor, gen, bits: int):
    """``_quantize_leaf`` on chunks: per-chunk scale ``max|g| / qmax``, the
    int8 codes and the float32 scales ``[chunks, 1]``."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = groups.abs().amax(dim=1, keepdim=True) * _recip(qmax)
    safe = torch.where(scale == 0.0, 1.0, scale)
    q = _round(groups / safe, gen)
    return q.clamp(-qmax - 1, qmax).to(torch.int8), scale.to(torch.float32)


def _quantize_leaf(x: torch.Tensor, gen, bits: int):
    """One leaf to int8 codes ``[chunks, CHUNK]`` and float32 per-chunk
    scales ``[chunks, 1]`` (zero-padded to whole chunks)."""
    return _quantize_groups(_chunks(x.reshape(-1).float()), gen, _check_bits(bits))


def _headroom(x: torch.Tensor, scale, per_int: int, gen) -> torch.Tensor:
    """The int8 code of ``x / scale`` on the headroom grid: clipped before
    and after the rounding, so that it stays on ``[-per_int, per_int]``."""
    t = (x / scale).clamp(-per_int, per_int)
    return _round(t, gen).clamp(-per_int, per_int).to(torch.int8)


def _leaf_chunks(tree: Tree) -> tuple[torch.Tensor, list[tuple[str, int, int]]]:
    """Every leaf zero-padded to whole chunks, concatenated; with each
    leaf's (name, first chunk, chunk count)."""
    parts, spans, at = [], [], 0
    for name, x in tree.items():
        c = _chunks(x.reshape(-1).float())
        parts.append(c)
        spans.append((name, at, c.shape[0]))
        at += c.shape[0]
    return torch.cat(parts), spans


def _split_chunks(total: torch.Tensor, spans, tree: Tree) -> Tree:
    return {name: total[a:a + n].reshape(-1)[:tree[name].numel()]
            .reshape(tree[name].shape).to(tree[name].dtype) for name, a, n in spans}


def _sum_in_rank_order(q_all: torch.Tensor, s_all: torch.Tensor) -> torch.Tensor:
    """``sum_i q_i * s_i`` in rank order, each term added with one rounding
    to float32 (a fused multiply-add, as XLA contracts JAX's sum): the
    int8-by-float32 product is exact in float64."""
    total = q_all[0].float() * s_all[0]
    for i in range(1, q_all.shape[0]):
        term = q_all[i].double() * s_all[i].double()
        total = (total.double() + term).float()
    return total


def compressed_allreduce_mean(tree: Tree, group, gen=None, *, bits: int = 8) -> Tree:
    """All-reduce-mean of every leaf over ``group`` on int8 payloads with
    per-chunk scales: codes and scales all-gathered, the dequantized sum
    in rank order, over n (full per-rank precision; (n-1) B an element)."""
    bits = _check_bits(bits)
    n = dist.get_world_size(group)
    groups, spans = _leaf_chunks(tree)
    q, scale = _quantize_groups(groups, gen, bits)
    total = _sum_in_rank_order(_all_gather(q, group), _all_gather(scale, group)) * _recip(n)
    return _split_chunks(total, spans, tree)


def compressed_psum_mean(tree: Tree, group, gen=None, *, bits: int = 8) -> Tree:
    """All-reduce-mean with one scale a leaf, agreed by ``all_reduce(MAX)``,
    and the int8 headroom grid summed by ``all_reduce(SUM)``: about
    ``bits - log2(n)`` bits a rank, 2(n-1)/n B an element."""
    bits = _check_bits(bits)
    n = _axis_prod(group)
    per_int = max((2 ** (bits - 1) - 1) // n, 1)
    flats = {k: x.reshape(-1).float() for k, x in tree.items()}
    local_max = torch.stack([f.abs().amax() for f in flats.values()])
    safe = _safe(_all_reduce(local_max, group, dist.ReduceOp.MAX))
    scales, dequant = safe * _recip(per_int), safe * _recip(per_int, n)
    t = torch.cat([(f / scales[i]).clamp(-per_int, per_int) for i, f in enumerate(flats.values())])
    q = _round(t, gen).clamp(-per_int, per_int).to(torch.int8)
    total = _all_reduce(q, group, dist.ReduceOp.SUM)
    out, at = {}, 0
    for i, (k, f) in enumerate(flats.items()):
        part = total[at:at + f.numel()].float() * dequant[i]
        out[k] = part.reshape(tree[k].shape).to(tree[k].dtype)
        at += f.numel()
    return out


def compressed_psum_mean_chunked(tree: Tree, group, gen=None, *, bits: int = 8) -> Tree:
    """Tree all-reduce-mean on int8 ``psum`` payloads with per-chunk scales
    agreed by an elementwise ``all_reduce(MAX)``: each leaf as
    :func:`compressed_psum_mean_flat` of its flat float32 view."""
    bits = _check_bits(bits)
    n = _axis_prod(group)
    per_int = max((2 ** (bits - 1) - 1) // n, 1)
    groups, spans = _leaf_chunks(tree)
    total, safe = _psum_chunks(groups, group, gen, per_int)
    return _split_chunks(total.float() * (safe * _recip(per_int, n)), spans, tree)


def _safe(global_max: torch.Tensor) -> torch.Tensor:
    return torch.where(global_max == 0.0, 1.0, global_max)


def _psum_chunks(g: torch.Tensor, group, gen, per_int: int):
    """int8 sums of chunks ``[..., CHUNK]`` on the headroom grid, and their
    agreed maxima (1 where 0): a chunk's scale is ``max / per_int``."""
    local_max = g.abs().amax(dim=-1, keepdim=True)
    safe = _safe(_all_reduce(local_max, group, dist.ReduceOp.MAX))
    q = _headroom(g, safe * _recip(per_int), per_int, gen)
    return _all_reduce(q, group, dist.ReduceOp.SUM), safe


def compressed_reduce_scatter_mean(x: torch.Tensor, scatter_group, gen=None, *, bits: int = 8,
                                   scatter_dimension: int = 0, sum_group=None) -> torch.Tensor:
    """Reduce-scatter-mean of one tensor on an int8 payload: one scale
    over all ranks (``all_reduce(MAX)``), the headroom grid for the total
    rank count, int8 sums over ``sum_group`` (if any), then an int8
    ``reduce_scatter`` over ``scatter_group`` along ``scatter_dimension``;
    the dequantize runs on this rank's block."""
    bits = _check_bits(bits)
    axes = (sum_group, scatter_group) if sum_group is not None else scatter_group
    n_total = _axis_prod(axes)
    per_int = max((2 ** (bits - 1) - 1) // n_total, 1)
    xf = x.float()
    safe = _safe(_all_reduce(xf.abs().amax().reshape(1), axes, dist.ReduceOp.MAX))
    q = _headroom(xf, safe * _recip(per_int), per_int, gen)
    if sum_group is not None:
        q = _all_reduce(q, sum_group, dist.ReduceOp.SUM)
    n = dist.get_world_size(scatter_group)
    front = q.movedim(scatter_dimension, 0).contiguous()
    part = torch.empty((front.shape[0] // n, *front.shape[1:]), dtype=torch.int8,
                       device=x.device)
    reduce_scatter_single(part, front, op=dist.ReduceOp.SUM, group=scatter_group)
    out = part.movedim(0, scatter_dimension).float() * (safe * _recip(per_int, n_total))
    return out.to(x.dtype)


def compressed_all_gather_flat(flat: torch.Tensor, group, gen=None, *,
                               bits: int = 8) -> torch.Tensor:
    """All-gather a flat local buffer on an int8 payload; the ``[n, L]``
    stack of every rank's dequantized buffer (the bucketed parameter
    gather of the fused FSDP step)."""
    q, scale = _quantize_leaf(flat, gen, bits)
    n = dist.get_world_size(group)
    deq = _all_gather(q, group).float() * _all_gather(scale, group)
    return deq.reshape(n, -1)[:, :flat.numel()]


def compressed_reduce_scatter_rows(buf: torch.Tensor, scatter_group, gen=None, *, bits: int = 8,
                                   sum_group=None) -> torch.Tensor:
    """Reduce-scatter-mean of an ``[n, L]`` buffer: row i goes to rank i of
    ``scatter_group``, which gets back its ``(L,)`` row.  Per-chunk scales
    agreed over all ranks, int8 sums over ``sum_group`` (if any), then one
    int8 ``reduce_scatter`` (the bucketed gradient exchange of the fused
    FSDP step)."""
    bits = _check_bits(bits)
    axes = (sum_group, scatter_group) if sum_group is not None else scatter_group
    n_rows, length = buf.shape
    n_total = _axis_prod(axes)
    per_int = max((2 ** (bits - 1) - 1) // n_total, 1)
    pad = (-length) % _CHUNK
    g = torch.nn.functional.pad(buf.float(), (0, pad))
    chunks = g.shape[1] // _CHUNK
    g = g.reshape(n_rows, chunks, _CHUNK)
    local_max = g.abs().amax(dim=2, keepdim=True)
    safe = _safe(_all_reduce(local_max, axes, dist.ReduceOp.MAX))
    q = _headroom(g, safe * _recip(per_int), per_int, gen).reshape(n_rows, chunks * _CHUNK)
    if sum_group is not None:
        q = _all_reduce(q, sum_group, dist.ReduceOp.SUM)
    part = torch.empty(chunks * _CHUNK, dtype=torch.int8, device=buf.device)
    reduce_scatter_single(part, q.reshape(-1), op=dist.ReduceOp.SUM, group=scatter_group)
    i = dist.get_rank(scatter_group)
    out = part.float().reshape(chunks, _CHUNK) * (safe[i] * _recip(per_int, n_total))
    return out.reshape(-1)[:length]


def compressed_psum_mean_flat(flat: torch.Tensor, group, gen=None, *,
                              bits: int = 8) -> torch.Tensor:
    """All-reduce-mean of one flat buffer on an int8 payload with
    per-chunk scales agreed by an elementwise ``all_reduce(MAX)``."""
    bits = _check_bits(bits)
    n = _axis_prod(group)
    per_int = max((2 ** (bits - 1) - 1) // n, 1)
    total, safe = _psum_chunks(_chunks(flat.reshape(-1).float()), group, gen, per_int)
    return (total.float() * (safe * _recip(per_int, n))).reshape(-1)[:flat.numel()]


def compressed_all_gather(x: torch.Tensor, group, gen=None, *, bits: int = 8,
                          gather_axis: int = 0) -> torch.Tensor:
    """All-gather of one tensor on an int8 payload, concatenated along
    ``gather_axis``: every rank dequantizes the same payloads, so every
    rank sees the same values."""
    q, scale = _quantize_leaf(x, gen, bits)
    n = dist.get_world_size(group)
    deq = (_all_gather(q, group).float() * _all_gather(scale, group)).reshape(n, -1)
    full = deq[:, :x.numel()].reshape((n, *x.shape)).movedim(0, gather_axis)
    shape = list(x.shape)
    shape[gather_axis] *= n
    return full.reshape(shape).to(x.dtype)
