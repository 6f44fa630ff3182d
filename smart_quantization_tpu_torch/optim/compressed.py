"""Low-precision optimizer step: quantize gradients, weights and momentum
around the real (fp32) optimizer math.

Counterpart of ``smart_quantization_tpu/optim/compressed.py``:

- gradients are quantized (tag ``optimizer_grad``) before the update, after
  the optional ``grad_scaling``;
- the updated weights are quantized (tag ``optimizer_weight``) except the
  BatchNorm leaves (:func:`norm_param_mask`);
- the momentum buffers are quantized (tag ``optimizer_momentum``): SGD's
  trace, Adam's ``mu`` and, with ``all_positive``, ``nu``;
- ``use_weight_accumulator`` keeps a float32 master copy of the weights in
  the state (:class:`CompressedOptState`): the optimizer steps the master
  and the exposed parameters are its quantized view;
- ``momentum_rowwise`` quantizes each momentum leaf by rows (64 bits of
  stats a row, counted), ``momentum_log_nu`` quantizes Adam's ``nu`` as
  ``log2`` of its positive entries (``momentum_log_nu_rowwise`` by rows):
  both run on plain tensor ops, as the JAX package runs them on its jnp
  path; rows are the JAX leaf's leading axis (``convert.jax_axes``), not
  torch's dim 0;
- ``packed_momentum`` and ``packed_weights`` keep the momentum buffers and
  the non-exempt weights as uint8 codebook codes (``ops/codebook.py``)
  between steps, with their real sizes (``8 n + 64`` bits a leaf);
- under FSDP (``parallel/train_fsdp_q.py``) the step runs on each rank's
  shards with ``packed_stats_rank1``: a packed leaf's stats are ``(1,)``
  rows, which stack to ``(fsdp,)`` in the global layout.  That layout
  (``init_opt_state``/``encode_params`` with ``fsdp_size``) is built from
  the global tree bit for bit as the shards build it: each block of a
  sharded leaf (``parallel/mesh.py::shard_dim``) is encoded from the same
  generator state, and ``min_size`` applies to a shard's element count.
  ``reshard_packed_state`` moves packed state to another fsdp size (or to
  one device) by a decode and a re-encode.

The optimizers are written with tensor ops in optax's order (SGD: coupled
weight decay -> ``trace(decay=momentum)`` -> ``-lr``; Adam: coupled decay
-> ``scale_by_adam`` -> ``-lr``; AdamW: ``scale_by_adam`` -> decoupled
decay -> ``-lr``), so the momentum buffers are plain tensors the step can
quantize.  Parameters, gradients and buffers are flat ``{name: tensor}``
dicts keyed by ``state_dict`` names.  Each compressor call draws from a key
of its own for its (stage, leaf), derived from the step's key (a host
generator, or the step key on the card) by :class:`LeafKeys`: a leaf draws
the same bits whether the step runs on the whole tree or on that leaf
alone (``parallel/train_fsdp.py``, one leaf at a time).

On the card the trainer hands the step its learning rate and Adam's bias
corrections as a float32 device tensor (:meth:`OptimizerSpec.
step_scalars`), so that a CUDA graph of the step reads each replay's values
instead of baking the capture's.  Under a profiler the three compressions
are the regions ``compress/optimizer_grad``, ``compress/optimizer_weight``
and ``compress/optimizer_momentum`` (``utils/profiling.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from smart_quantization_tpu_torch.compress.base import CompressorBase
from smart_quantization_tpu_torch.convert import jax_axes
from smart_quantization_tpu_torch.inject.tap import DRAWS_PER_COMPRESS
from smart_quantization_tpu_torch.ops.codebook import (
    SmaQCodes,
    smaq_decode,
    smaq_encode,
    supports_codebook,
)
from smart_quantization_tpu_torch.ops.keys import DeviceKey, draw_seed, mix
from smart_quantization_tpu_torch.ops.smaq import SmaQParams
from smart_quantization_tpu_torch.parallel.mesh import shard_dim
from smart_quantization_tpu_torch.utils.profiling import scope

Tree = dict[str, torch.Tensor]

# the stages of an optimizer step's compressor calls: the gradients, the
# weights, then each momentum buffer (SGD's trace, Adam's mu and nu)
KEY_STAGES = ("grad", "weight", "trace", "mu", "nu")


class LeafKeys:
    """The keys of one optimizer step's compressor calls, one for each
    (stage, leaf) of the tree ``names``, from the step's key ``gen``: on
    the card one reservation of ``DRAWS_PER_COMPRESS`` call indices for
    each (stage, leaf) of the step key; from a host generator one seed
    drawn from it, each (stage, leaf) a generator seeded by ``keys.mix`` of
    that seed and its index; None (truncation) for every call of a None."""

    def __init__(self, gen, names):
        self.index = {n: i for i, n in enumerate(names)}
        self._gen = gen
        count = len(KEY_STAGES) * len(self.index)
        if isinstance(gen, DeviceKey):
            self._base = gen.reserve(count * DRAWS_PER_COMPRESS)._next
        elif gen is not None:
            self._base = draw_seed(gen)

    def of(self, stage: str, name: str):
        """The key of stage ``stage``'s call on leaf ``name``."""
        if self._gen is None:
            return None
        i = KEY_STAGES.index(stage) * len(self.index) + self.index[name]
        if isinstance(self._gen, DeviceKey):
            start = self._base + i * DRAWS_PER_COMPRESS
            return DeviceKey(self._gen.key, start, start + DRAWS_PER_COMPRESS)
        gen = torch.Generator()
        gen.manual_seed(mix(self._base, i))
        return gen


def _leaf_key(gen, stage: str | None, name: str):
    """Leaf ``name``'s key at ``stage`` of a :class:`LeafKeys`, or ``gen``
    itself (one key for every leaf in turn)."""
    return gen.of(stage, name) if isinstance(gen, LeafKeys) else gen


@dataclasses.dataclass(frozen=True)
class OptimizerCompression:
    compressor: CompressorBase | None = None
    compress_weights: bool = True
    compress_gradients: bool = True
    compress_momentum: bool = True
    grad_scaling: float = 1.0
    # a float32 master copy of the weights; the params are its quantized view
    use_weight_accumulator: bool = False
    # momentum buffers / non-exempt weights stored as uint8 codebook codes
    packed_momentum: bool = False
    packed_weights: bool = False
    # momentum quantized with one (mean, std) per row of the JAX leaf
    momentum_rowwise: bool = False
    # Adam's nu quantized as log2 of its positive entries (zeros stay zero),
    # per tensor or, with momentum_log_nu_rowwise, per row
    momentum_log_nu: bool = False
    momentum_log_nu_rowwise: bool = False

    @property
    def active(self) -> bool:
        return self.compressor is not None and (
            self.compress_weights or self.compress_gradients or self.compress_momentum
        )

    def packs_momentum(self, spec: "OptimizerSpec") -> bool:
        return (self.packed_momentum and self.active and self.compress_momentum
                and spec.has_momentum)


class CompressedOptState(NamedTuple):
    """The optimizer state and the float32 master weights."""

    inner: dict
    master: dict


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """SGD / Adam / AdamW; ``learning_rate`` is a float or a schedule of the
    optimizer's step count."""

    kind: str  # 'sgd' | 'adam' | 'adamw'
    learning_rate: float | Callable[[int], float] = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    @property
    def has_momentum(self) -> bool:
        return self.kind != "sgd" or self.momentum != 0.0

    @property
    def momentum_buffers(self) -> tuple[tuple[str, bool], ...]:
        """(buffer name, all_positive) of each momentum tree in the state."""
        return (("trace", False),) if self.kind == "sgd" else (("mu", False), ("nu", True))

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def init(self, params: Tree) -> dict:
        state = {"count": 0}
        for name, _ in self.momentum_buffers:
            state[name] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    def step_scalars(self, count: int) -> tuple[float, float, float]:
        """What the update at optimizer count ``count`` takes from the
        count: ``-lr`` and Adam's bias corrections ``1 - b1^(count + 1)``
        and ``1 - b2^(count + 1)`` (1 and 1 for SGD)."""
        if self.kind == "sgd":
            return -self.lr(count), 1.0, 1.0
        return (-self.lr(count), 1.0 - self.b1 ** (count + 1),
                1.0 - self.b2 ** (count + 1))

    def update(self, grads: Tree, state: dict, params: Tree,
               scalars: torch.Tensor | None = None) -> tuple[Tree, dict]:
        """One update; ``scalars`` (a float32 tensor of
        :meth:`step_scalars` on the parameters' device) replaces the values
        the host derives from the count."""
        count = state["count"]
        if scalars is None:
            neg_lr, c1, c2 = self.step_scalars(count)
        else:
            neg_lr, c1, c2 = scalars[0], scalars[1], scalars[2]
        wd = self.weight_decay
        updates: Tree = {}
        new_state = {"count": count + 1}
        if self.kind == "sgd":
            trace = {}
            for k, g in grads.items():
                if wd:
                    g = g + wd * params[k]
                trace[k] = torch.add(g, state["trace"][k], alpha=self.momentum)
                updates[k] = trace[k] * neg_lr
            new_state["trace"] = trace
            return updates, new_state
        if self.kind not in ("adam", "adamw"):
            raise ValueError(f"unknown optimizer {self.kind!r} (sgd|adam|adamw)")
        mu, nu = {}, {}
        for k, g in grads.items():
            if wd and self.kind == "adam":
                g = g + wd * params[k]
            mu[k] = (1.0 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            u = (mu[k] / c1) / ((nu[k] / c2).sqrt() + self.eps)
            if wd and self.kind == "adamw":
                u = u + wd * params[k]
            updates[k] = u * neg_lr
        new_state["mu"], new_state["nu"] = mu, nu
        return updates, new_state


def build_optimizer(
    name: str,
    learning_rate: float | Callable[[int], float] = 0.1,
    *,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    beta1: float | None = None,
    beta2: float | None = None,
    epsilon: float | None = None,
) -> OptimizerSpec:
    """SGD / Adam / AdamW with the JAX package's defaults (lr 0.1, momentum
    0.9, wd 0)."""
    if name not in ("sgd", "adam", "adamw"):
        raise ValueError(f"unknown optimizer {name!r} (sgd|adam|adamw)")
    return OptimizerSpec(
        kind=name,
        learning_rate=learning_rate,
        momentum=momentum,
        weight_decay=weight_decay,
        b1=0.9 if beta1 is None else beta1,
        b2=0.999 if beta2 is None else beta2,
        eps=1e-8 if epsilon is None else epsilon,
    )


def init_opt_state(spec: OptimizerSpec, params: Tree, compression: OptimizerCompression,
                   gen: torch.Generator | None = None, fsdp_size: int | None = None):
    """The initial optimizer state under ``compression``: with
    ``packed_momentum`` the (zero) momentum buffers encoded from step zero
    (they decode exactly), drawing from ``gen``, in the FSDP layout of
    ``fsdp_size`` > 1 (:func:`_encode_tree_fsdp`); a ``CompressedOptState``
    with the master weights under ``use_weight_accumulator``, else the
    plain state."""
    inner = spec.init(params)
    if compression.packs_momentum(spec):
        p = packed_smaq_params(compression)
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        for name, _ in spec.momentum_buffers:
            if fsdp_size and fsdp_size > 1:
                inner[name] = _encode_tree_fsdp(inner[name], gen, p, fsdp_size)
            else:
                inner[name] = _encode_tree(inner[name], gen, p)[0]
    if compression.use_weight_accumulator:
        # a copy: the trainer updates the master and the model in place
        return CompressedOptState(inner, {k: p.clone() for k, p in params.items()})
    return inner


def norm_param_mask(names) -> dict[str, bool]:
    """True for leaves of BATCH-norm layers (exempt from weight
    compression); the port's models name them ``bn*``."""
    return {n: any("bn" in part.lower() for part in n.split(".")) for n in names}


def _log_stats(x: torch.Tensor, dim: int | None):
    """(positive mask, log2 input, mean, std) of ``_log_domain``: the mean
    and the n-1 std of ``log2`` of the positive entries, over the whole
    tensor or along ``dim`` (kept); the other entries take the mean."""
    nz = x > 0.0
    kw = {} if dim is None else {"dim": dim, "keepdim": True}
    npos = nz.float().sum(**kw).clamp_min(1.0)
    lx_raw = torch.log2(torch.where(nz, x, 1.0))
    mean = torch.where(nz, lx_raw, 0.0).sum(**kw) / npos
    dev = torch.where(nz, lx_raw - mean, 0.0)
    std = ((dev * dev).sum(**kw) / (npos - 1.0).clamp_min(1.0)).sqrt()
    return nz, torch.where(nz, lx_raw, mean), mean, std


def _quantize_leaf(comp, name: str, leaf: torch.Tensor, gen, *, rows: bool,
                   log_domain: bool, all_positive: bool):
    """One momentum or weight leaf through ``comp``: per tensor, or by rows
    of the JAX layout (``comp.rowwise``, 64 bits of stats a row); in the
    log2 domain (positive entries quantized as ``log2(x)`` with the mean and
    std of the positive logs passed to ``comp``, exact zeros kept) or as
    is.  Returns (y, orig_bits, new_bits)."""
    x, call = leaf, comp
    if rows:
        axes = jax_axes(name, leaf.dim())
        jax_leaf = leaf.permute(axes)
        x, call = jax_leaf.reshape(jax_leaf.shape[0], -1), comp.rowwise
    if log_domain:
        nz, lx, mean, std = _log_stats(x.float(), 1 if rows else None)
        y_l, stats = call(lx, gen, all_positive=False, mean=mean, std=std)
        y = torch.where(nz, torch.exp2(y_l), 0.0)
    else:
        y, stats = call(x, gen, all_positive=all_positive)
    new = stats.new_bits
    if rows:
        inverse = tuple(axes.index(i) for i in range(len(axes)))
        y = y.reshape(jax_leaf.shape).permute(inverse).contiguous()
        new = new + float(x.shape[0] * 64)
    return y.to(leaf.dtype), stats.orig_bits, new


def by_rows(name: str, leaf: torch.Tensor) -> bool:
    """The JAX package's row test, on the JAX leaf's shape: rank >= 2 and
    a leading axis of 2 or more."""
    return leaf.dim() >= 2 and leaf.shape[jax_axes(name, leaf.dim())[0]] >= 2


def _quantize_tree(tree: Tree, gen, compressor, *, skip=None, all_positive=False,
                   rowwise=False, log_domain=False, stage=None):
    """Quantize every non-skipped leaf; returns (tree, orig_bits, new_bits)
    with the bit totals as 0-d device tensors.  ``rowwise`` takes the
    leaves that pass :func:`by_rows` by rows, ``log_domain`` quantizes in
    the log2 domain (no ``all_positive`` clamp is needed there).  A
    :class:`LeafKeys` ``gen`` gives each leaf its key at ``stage``."""
    out, origs, news = {}, [], []
    for k, leaf in tree.items():
        if skip is not None and skip.get(k, False):
            out[k] = leaf
            continue
        out[k], o, n = _quantize_leaf(
            compressor, k, leaf, _leaf_key(gen, stage, k), rows=rowwise and by_rows(k, leaf),
            log_domain=log_domain, all_positive=all_positive)
        origs.append(o)
        news.append(n)
    if not origs:
        zero = torch.zeros((), device=next(iter(tree.values())).device)
        return out, zero, zero
    return out, torch.stack(origs).sum(), torch.stack(news).sum()


def packed_smaq_params(compression: OptimizerCompression) -> SmaQParams:
    """The SmaQ parameters behind packed storage, checked."""
    params = getattr(compression.compressor, "params", None)
    if not isinstance(params, SmaQParams):
        raise ValueError(
            "packed_momentum requires the SmaQ compressor (--compress smart); "
            f"got {type(compression.compressor).__name__}"
        )
    if not supports_codebook(params):
        raise ValueError(
            "packed_momentum needs 2^(bm-1) + 2^(bo-1) <= 256 codebook entries; "
            f"{params.num_bits_main}/{params.num_bits_outlier} bits do not fit uint8"
        )
    return params


def _encode_tree(tree: Tree, gen, params: SmaQParams, *, skip=None, stats_rank1=False,
                 stage=None):
    """Encode every non-skipped leaf of ``min_size`` elements or more to
    ``SmaQCodes`` (smaller ones stay float32, as the fake path passes them
    through); returns (tree, orig_bits, new_bits) with the real sizes:
    ``8 n + 64`` bits a code leaf, ``32 n`` a float32 one, skipped leaves
    not counted.  Draws from ``gen`` in leaf order (a :class:`LeafKeys`:
    each leaf's key at ``stage``), as :func:`_quantize_tree` does.
    ``stats_rank1`` stores the stats as ``(1,)`` rows (a shard's slice of
    the FSDP layout)."""
    out, orig, new = {}, 0, 0
    for k, leaf in tree.items():
        if skip is not None and skip.get(k, False):
            out[k] = leaf
            continue
        n = leaf.numel()
        orig += 32 * n
        if n < params.min_size:
            out[k] = leaf
            new += 32 * n
        else:
            out[k] = smaq_encode(leaf, _leaf_key(gen, stage, k), params)
            if stats_rank1:
                out[k] = _rank1(out[k])
            new += 8 * n + 64
    device = next(iter(tree.values())).device
    return (out, torch.full((), float(orig), device=device),
            torch.full((), float(new), device=device))


def _rank1(codes: SmaQCodes) -> SmaQCodes:
    return SmaQCodes(codes.codes, codes.mean.reshape(1), codes.std.reshape(1))


def _rewinder(gen):
    """A function that puts ``gen`` back in its present state (a host
    generator's state, a step key's next call index)."""
    if isinstance(gen, torch.Generator):
        state = gen.get_state()
        return lambda: gen.set_state(state)
    if isinstance(gen, DeviceKey):
        at = gen._next
        return lambda: setattr(gen, "_next", at)
    return lambda: None


def _blocks(leaf: torch.Tensor, fsdp_size: int, dim: int) -> list[torch.Tensor]:
    """The ``fsdp_size`` contiguous blocks of ``leaf`` along ``dim``, each
    contiguous (a shard as its rank stores it)."""
    return [b.contiguous() for b in leaf.chunk(fsdp_size, dim)]


def _encode_leaf_blocked(leaf: torch.Tensor, gen, params: SmaQParams, fsdp_size: int,
                         dim: int) -> SmaQCodes:
    """The global layout of a sharded leaf, bit for bit what its
    ``fsdp_size`` shards encode: each block along ``dim`` encoded from the
    same generator state (every rank draws from the shared optimizer key),
    the codes in the global shape, the stats stacked ``(fsdp_size,)``."""
    rewind, encs = _rewinder(gen), []
    for i, block in enumerate(_blocks(leaf, fsdp_size, dim)):
        if i:
            rewind()
        encs.append(smaq_encode(block, gen, params))
    return SmaQCodes(torch.cat([e.codes for e in encs], dim),
                     torch.stack([e.mean for e in encs]), torch.stack([e.std for e in encs]))


def _encode_tree_fsdp(tree: Tree, gen, params: SmaQParams, fsdp_size: int, *,
                      skip=None) -> Tree:
    """The FSDP layout of a global tree: a leaf that ``shard_dim`` shards
    holds one codebook a block (codes in the global shape, ``(fsdp,)``
    stats), a replicated one ``(1,)`` stats; ``min_size`` applies to the
    shard's element count.  The layout is specific to ``fsdp_size``:
    :func:`reshard_packed_state` moves it."""
    out = {}
    for k, leaf in tree.items():
        if skip is not None and skip.get(k, False):
            out[k] = leaf
            continue
        dim = shard_dim(k, tuple(leaf.shape), fsdp_size)
        local_n = leaf.numel() // fsdp_size if dim >= 0 else leaf.numel()
        if local_n < params.min_size:
            out[k] = leaf
        elif dim < 0:
            out[k] = _rank1(smaq_encode(leaf, gen, params))
        else:
            out[k] = _encode_leaf_blocked(leaf, gen, params, fsdp_size, dim)
    return out


def decode_leaf(name: str, leaf: SmaQCodes, params: SmaQParams,
                all_positive: bool = False) -> torch.Tensor:
    """A packed leaf's values; in the global FSDP layout (``(k,)`` stats,
    k > 1) block by block along the dim ``shard_dim`` gives for k."""
    k = leaf.mean.numel()
    if leaf.mean.dim() == 1 and k > 1:
        dim = shard_dim(name, tuple(leaf.codes.shape), k)
        return torch.cat([
            smaq_decode(SmaQCodes(c, leaf.mean[i], leaf.std[i]), params,
                        all_positive=all_positive)
            for i, c in enumerate(leaf.codes.chunk(k, dim))], dim)
    return smaq_decode(leaf, params, all_positive=all_positive)


def _decode_tree(tree: Tree, params: SmaQParams, all_positive: bool) -> Tree:
    """``SmaQCodes`` leaves decoded to float32; the others as they are."""
    return {k: decode_leaf(k, v, params, all_positive)
            if isinstance(v, SmaQCodes) else v for k, v in tree.items()}


def _compress_momentum(spec, opt_state, gen, compression, p_params, stats_rank1=False):
    """Quantize (or, with ``p_params``, encode) every momentum buffer;
    returns the state and the (2,) ``[orig_bits, new_bits]`` total."""
    origs, news = [], []
    for name, all_positive in spec.momentum_buffers:
        if p_params is not None:
            opt_state[name], o, n = _encode_tree(opt_state[name], gen, p_params,
                                                 stats_rank1=stats_rank1, stage=name)
        else:
            # nu (the all_positive buffer) may take the log2 codec, by rows
            # with momentum_log_nu_rowwise; mu and SGD's trace may take rows
            log_nu = all_positive and compression.momentum_log_nu
            opt_state[name], o, n = _quantize_tree(
                opt_state[name], gen, compression.compressor, all_positive=all_positive,
                rowwise=(compression.momentum_log_nu_rowwise if log_nu
                         else compression.momentum_rowwise),
                log_domain=log_nu, stage=name,
            )
        origs.append(o)
        news.append(n)
    return opt_state, torch.stack([torch.stack(origs).sum(), torch.stack(news).sum()])


def compressed_optimizer_step(
    spec: OptimizerSpec,
    params: Tree,
    grads: Tree,
    opt_state,
    gen: torch.Generator | None,
    compression: OptimizerCompression,
    *,
    weight_exempt: dict[str, bool] | None = None,
    scalars: torch.Tensor | None = None,
    packed_stats_rank1: bool = False,
) -> tuple[Tree, object, dict[str, torch.Tensor]]:
    """One optimizer step with compression; returns ``(params, opt_state,
    metrics)``, metrics mapping ``optimizer_{grad,weight,momentum}`` to
    (2,) ``[orig_bits, new_bits]`` device tensors.  ``params`` are float32
    (decode packed weights first, :func:`decode_params`); under
    ``packed_weights`` the returned ones hold ``SmaQCodes``.  ``scalars``
    goes to :meth:`OptimizerSpec.update`.  ``packed_stats_rank1``: the
    FSDP step on a rank's shards, whose packed stats are ``(1,)`` rows.
    ``gen`` is the step's key, or the :class:`LeafKeys` of a larger tree
    (a step on some of its leaves draws what the whole tree's draws for
    them)."""
    metrics: dict[str, torch.Tensor] = {}
    keys = gen if isinstance(gen, LeafKeys) else LeafKeys(gen, params)
    comp = compression.compressor
    active = compression.active

    master = None
    wrapped = isinstance(opt_state, CompressedOptState)
    if wrapped:
        opt_state, master = opt_state.inner, opt_state.master

    # packed momentum arrives as codes: decode for the optimizer math
    packed = compression.packs_momentum(spec)
    if packed:
        p_params = packed_smaq_params(compression)
        opt_state = dict(opt_state)
        for name, all_positive in spec.momentum_buffers:
            opt_state[name] = _decode_tree(opt_state[name], p_params, all_positive)

    if active and compression.compress_gradients:
        with scope("compress/optimizer_grad"):
            if compression.grad_scaling != 1.0:
                grads = {k: g * compression.grad_scaling for k, g in grads.items()}
            grads, o, n = _quantize_tree(grads, keys, comp, stage="grad")
        metrics["optimizer_grad"] = torch.stack([o, n])

    # with the accumulator the optimizer steps the float32 master
    step_params = master if master is not None else params
    updates, opt_state = spec.update(grads, opt_state, step_params, scalars)
    params = {k: p + updates[k] for k, p in step_params.items()}
    if master is not None:
        master = params

    if active and compression.compress_weights:
        with scope("compress/optimizer_weight"):
            if compression.packed_weights:
                params, o, n = _encode_tree(params, keys, packed_smaq_params(compression),
                                            skip=weight_exempt, stats_rank1=packed_stats_rank1,
                                            stage="weight")
            else:
                params, o, n = _quantize_tree(params, keys, comp, skip=weight_exempt,
                                              stage="weight")
        metrics["optimizer_weight"] = torch.stack([o, n])

    if active and compression.compress_momentum and spec.has_momentum:
        with scope("compress/optimizer_momentum"):
            opt_state, metrics["optimizer_momentum"] = _compress_momentum(
                spec, opt_state, keys, compression, p_params if packed else None,
                packed_stats_rank1)

    if wrapped:
        opt_state = CompressedOptState(opt_state, master)
    return params, opt_state, metrics


def decode_params(params: Tree, compression: OptimizerCompression) -> Tree:
    """Packed weights decoded to float32 for the forward pass (identity
    without ``packed_weights``)."""
    if not compression.packed_weights:
        return params
    return _decode_tree(params, packed_smaq_params(compression), False)


def encode_params(params: Tree, compression: OptimizerCompression,
                  gen: torch.Generator | None = None, *, exempt=None,
                  fsdp_size: int | None = None) -> Tree:
    """Fresh float32 params in packed storage (init and restore); the
    exempt leaves (by default :func:`norm_param_mask`'s) stay float32.
    The initial params are thereby quantized at init rather than after the
    first step, as in the JAX package.  ``fsdp_size`` > 1 gives the FSDP
    layout (:func:`_encode_tree_fsdp`)."""
    if not compression.packed_weights:
        return params
    if exempt is None:
        exempt = norm_param_mask(params)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    p = packed_smaq_params(compression)
    if fsdp_size and fsdp_size > 1:
        return _encode_tree_fsdp(params, gen, p, fsdp_size, skip=exempt)
    return _encode_tree(params, gen, p, skip=exempt)[0]


def reshard_packed_tree(tree: Tree, gen, params: SmaQParams, new_fsdp_size: int | None, *,
                        all_positive: bool = False) -> Tree:
    """Every ``SmaQCodes`` leaf of a global tree re-laid out for another
    fsdp size: decoded (block by block in an FSDP layout) and encoded in
    the target layout (``new_fsdp_size`` <= 1: one device's, 0-d stats).
    A leaf whose shard falls below ``min_size`` in the new layout comes
    back float32, as the target's own encode decides; other leaves pass
    through.  Each decode and re-encode is one more stochastic rounding."""
    out = {}
    for k, leaf in tree.items():
        if not isinstance(leaf, SmaQCodes):
            out[k] = leaf
            continue
        x = decode_leaf(k, leaf, params, all_positive)
        if new_fsdp_size and new_fsdp_size > 1:
            out[k] = _encode_tree_fsdp({k: x}, gen, params, new_fsdp_size)[k]
        elif x.numel() < params.min_size:
            out[k] = x
        else:
            out[k] = smaq_encode(x, gen, params)
    return out


def reshard_packed_state(params: Tree | None, opt_state, gen, compression: OptimizerCompression,
                         new_fsdp_size: int | None):
    """A restored state's packed leaves (parameters, then each momentum
    buffer) in the layout of ``new_fsdp_size``: ``(params, opt_state)``,
    by :func:`reshard_packed_tree`."""
    p = packed_smaq_params(compression)
    if params is not None:
        params = reshard_packed_tree(params, gen, p, new_fsdp_size)
    wrapped = isinstance(opt_state, CompressedOptState)
    inner = dict(opt_state.inner if wrapped else opt_state)
    for name, all_positive in (("trace", False), ("mu", False), ("nu", True)):
        if name in inner:
            inner[name] = reshard_packed_tree(inner[name], gen, p, new_fsdp_size,
                                              all_positive=all_positive)
    return params, (CompressedOptState(inner, opt_state.master) if wrapped else inner)
