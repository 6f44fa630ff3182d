"""The fused FSDP path: sharded state, a bucketed parameter gather and a
bucketed gradient reduce-scatter, on int8 payloads if asked.

Counterpart of ``smart_quantization_tpu/parallel/train_fsdp_q.py``.  On a
(data, fsdp) mesh:

- every leaf that ``mesh.shard_dim`` shards is stored as this rank's
  contiguous block along that dim (:class:`FSDPLayout`): the parameters,
  the momentum, the master weights and packed codes, whose ``(1,)`` stats
  rows stack to ``(fsdp,)`` in the global layout; the other leaves are
  replicated.  A block along a dim other than 0 is copied out once, at
  placement, never per step;
- the forward gathers one flat buffer of every sharded leaf
  (:meth:`FusedFSDP.gather_params`): a float32 ``all_gather`` over
  ``fsdp``, or ``compressed_all_gather_flat`` under ``param_gather_bits``,
  whose key is folded by the fsdp index only (every data replica of a
  block sends the same payload), into the model's full parameters;
- the batch is split over all ranks; the gradients go out as one
  ``(fsdp, L)`` row buffer, block i of every sharded leaf in row i,
  through ``compressed_reduce_scatter_rows`` (int8 sums over ``data``,
  then an int8 reduce-scatter over ``fsdp``), or a float32 sum over
  ``data`` and reduce-scatter over ``fsdp``; replicated leaves through
  ``compressed_psum_mean_flat`` (or a float32 mean) over the world, with a
  key folded by the rank (:meth:`FusedFSDP.exchange_grads`);
- the optimizer then runs on this rank's shards with
  ``packed_stats_rank1``; its size pairs are summed over ``fsdp`` only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from smart_quantization_tpu_torch.ops.codebook import SmaQCodes
from smart_quantization_tpu_torch.optim.compressed import CompressedOptState
from smart_quantization_tpu_torch.parallel.collectives import (
    _check_bits,
    _recip,
    all_gather_single,
    compressed_all_gather_flat,
    compressed_psum_mean_flat,
    compressed_reduce_scatter_rows,
    reduce_scatter_single,
)
from smart_quantization_tpu_torch.parallel.mesh import shard_dim
from smart_quantization_tpu_torch.parallel.train_dp import flat_mean


class FSDPLayout:
    """Which dim of each named leaf is sharded over ``fsdp`` ranks (-1:
    replicated), and the moves between the global layout and a rank's."""

    def __init__(self, shapes: dict[str, tuple[int, ...]], fsdp: int):
        self.fsdp = fsdp
        self.shapes = {k: tuple(s) for k, s in shapes.items()}
        self.dims = {k: shard_dim(k, s, fsdp) for k, s in self.shapes.items()}

    def local_shape(self, name: str) -> tuple[int, ...]:
        shape, d = list(self.shapes[name]), self.dims[name]
        if d >= 0:
            shape[d] //= self.fsdp
        return tuple(shape)

    def block(self, name: str, leaf, index: int):
        """Block ``index`` of leaf ``name`` (contiguous), or the leaf whole
        (a copy) where it is replicated."""
        d = self.dims.get(name, -1)
        if isinstance(leaf, SmaQCodes):
            if leaf.mean.numel() > 1:  # one codebook a block
                return SmaQCodes(leaf.codes.chunk(self.fsdp, d)[index].contiguous(),
                                 leaf.mean[index:index + 1].clone(),
                                 leaf.std[index:index + 1].clone())
            return SmaQCodes(leaf.codes.clone(), leaf.mean.reshape(1).clone(),
                             leaf.std.reshape(1).clone())
        if d < 0 or leaf.dim() == 0:
            return leaf.clone()
        return leaf.chunk(self.fsdp, d)[index].contiguous()

    def local(self, tree: dict, index: int) -> dict:
        """A global tree's block ``index`` of every sharded leaf (each leaf
        contiguous), the replicated leaves whole."""
        return {k: self.block(k, v, index) for k, v in tree.items()}

    def local_opt_state(self, opt_state, index: int):
        """:meth:`local` on every per-parameter tree of an optimizer state
        (momentum buffers, master weights)."""
        return _map_state(opt_state, lambda tree: self.local(tree, index))

    def gather_leaf(self, name: str, leaf, group):
        """The whole of leaf ``name`` from every fsdp rank's block (an
        all-gather over ``group``); a replicated leaf as it is."""
        d = self.dims.get(name, -1)
        if isinstance(leaf, SmaQCodes):
            if d < 0 or leaf.codes.numel() == 0:
                return leaf
            return SmaQCodes(_gather_dim(leaf.codes, d, group, self.fsdp),
                             _gather_dim(leaf.mean.reshape(1), 0, group, self.fsdp),
                             _gather_dim(leaf.std.reshape(1), 0, group, self.fsdp))
        if d < 0 or leaf.dim() == 0:
            return leaf
        return _gather_dim(leaf, d, group, self.fsdp)

    def gather(self, tree: dict, group) -> dict:
        """The global layout of a rank's tree, by an all-gather over
        ``fsdp`` of every sharded leaf (packed stats to ``(fsdp,)``)."""
        return {k: self.gather_leaf(k, v, group) for k, v in tree.items()}

    def gather_opt_state(self, opt_state, group):
        return _map_state(opt_state, lambda tree: self.gather(tree, group))


def _map_state(opt_state, fn):
    wrapped = isinstance(opt_state, CompressedOptState)
    inner = opt_state.inner if wrapped else opt_state
    inner = {k: fn(v) if isinstance(v, dict) else v for k, v in inner.items()}
    if wrapped:
        return CompressedOptState(inner, fn(opt_state.master))
    return inner


def _gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Every rank's block of ``t`` concatenated along ``dim``."""
    front = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0], *front.shape[1:]), dtype=t.dtype, device=t.device)
    all_gather_single(out, front, group=group)
    return out.movedim(0, dim).contiguous()


class FusedFSDP:
    """The fused step's collectives on a mesh with ``fsdp`` > 1, for the
    named parameter shapes of a model."""

    def __init__(self, mesh, shapes: dict[str, tuple[int, ...]], grad_bits: int | None = 8,
                 param_gather_bits: int | None = None):
        self.mesh = mesh
        self.fsdp = mesh.shape["fsdp"]
        self.n_total = mesh.size
        self.layout = FSDPLayout(shapes, self.fsdp)
        self.grad_bits = None if grad_bits is None else _check_bits(grad_bits)
        self.gather_bits = None if param_gather_bits is None else _check_bits(param_gather_bits)
        self.sharded = [k for k, d in self.layout.dims.items() if d >= 0]
        self.replicated = [k for k, d in self.layout.dims.items() if d < 0]

    def gather_params(self, local: dict, gen, into: dict[str, torch.Tensor],
                      quantized: bool = True) -> None:
        """Write the full parameters into ``into`` (the model's tensors)
        from this rank's float32 shards: one bucketed gather over
        ``fsdp`` (int8 under ``param_gather_bits`` if ``quantized``, else
        float32, as evaluation reads the stored parameters), the replicated
        leaves copied."""
        bits = self.gather_bits if quantized else None
        group = self.mesh.group("fsdp")
        with torch.no_grad():
            if self.sharded:
                flat = torch.cat([local[k].reshape(-1).float() for k in self.sharded])
                if bits is None:
                    rows = torch.empty(self.fsdp * flat.numel(), dtype=flat.dtype,
                                       device=flat.device)
                    all_gather_single(rows, flat, group=group)
                    rows = rows.view(self.fsdp, -1)
                else:
                    rows = compressed_all_gather_flat(flat, group, gen, bits=bits)
                at = 0
                for k in self.sharded:
                    shape = self.layout.local_shape(k)
                    size = local[k].numel()
                    piece = rows[:, at:at + size].reshape(self.fsdp, *shape)
                    into[k].copy_(piece.movedim(0, self.layout.dims[k]).reshape(into[k].shape))
                    at += size
            for k in self.replicated:
                into[k].copy_(local[k])

    def exchange_grads(self, grads: dict, gen) -> dict:
        """This rank's shard of the gradients' mean over all ranks: the
        sharded leaves by one reduce-scatter of the row buffer, the
        replicated ones by one all-reduce over the world; ``gen`` is the
        rank-folded payload key."""
        out = {}
        data, fsdp_group = self.mesh.group("data"), self.mesh.group("fsdp")
        if self.sharded:
            rows = []
            for k in self.sharded:
                d, g = self.layout.dims[k], grads[k].float()
                blocks = g.reshape(*g.shape[:d], self.fsdp, g.shape[d] // self.fsdp,
                                   *g.shape[d + 1:]).movedim(d, 0)
                rows.append(blocks.reshape(self.fsdp, -1))
            buf = torch.cat(rows, dim=1)
            if self.grad_bits is None:
                dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=data)
                mine = torch.empty(buf.shape[1], dtype=buf.dtype, device=buf.device)
                reduce_scatter_single(mine, buf.reshape(-1), op=dist.ReduceOp.SUM,
                                           group=fsdp_group)
                mine = mine * _recip(self.n_total)
            else:
                mine = compressed_reduce_scatter_rows(buf, fsdp_group, gen, bits=self.grad_bits,
                                                      sum_group=data)
            at = 0
            for k in self.sharded:
                shape = self.layout.local_shape(k)
                size = grads[k].numel() // self.fsdp
                out[k] = mine[at:at + size].reshape(shape).to(grads[k].dtype)
                at += size
        if self.replicated:
            world = self.mesh.group(("data", "fsdp"))
            rep = {k: grads[k] for k in self.replicated}
            if self.grad_bits is None:
                out.update(flat_mean(rep, world, self.n_total))
            else:
                flat = torch.cat([g.reshape(-1).float() for g in rep.values()])
                red = compressed_psum_mean_flat(flat, world, gen, bits=self.grad_bits)
                at = 0
                for k, g in rep.items():
                    out[k] = red[at:at + g.numel()].reshape(g.shape).to(g.dtype)
                    at += g.numel()
        return {k: out[k] for k in grads}
