"""The compression tap: an identity that fake-quantizes the feature map on
the way forward (tag ``forward_autograd``) and the gradient map on the way
backward (tag ``backward_autograd``).

Counterpart of ``smart_quantization_tpu/inject/tap.py``, as a
``torch.autograd.Function``: the gradient is straight-through, d(tap)/dx ==
the quantized incoming gradient.  The two directions get keys of their own,
fixed when the forward runs, so the backward draws do not depend on the
order autograd visits the taps in: two seeds drawn from the step's host
generator, or, from a step key on the card (``ops/keys.py``), two blocks of
``DRAWS_PER_COMPRESS`` call indices.

Under a profiler (``utils/profiling.py``) the two directions' compress
calls are the regions ``compress/forward`` and ``compress/backward``, the
JAX tap's named scopes.

Sizes go to the step's :class:`SizeTotals` as device tensors; no tap reads a
value back to the host, so PyTorch needs none of the JAX package's
telemetry-token plumbing.

Under ``--use_batch_norm`` a BatchNorm tap hands its (detached) gamma and
beta to the forward compress only, as the JAX tap does (``tap.py:95-117``).
The tap stays straight-through: gamma and beta get their gradient from the
BatchNorm alone, which is what the JAX tap's VJP specifies.

A context with a ``stats_group`` (``parallel/whole_batch.py``) runs each
call, both directions, through the group: the statistics of the whole
tensor over the ranks' rows, as one device sees the global batch
(``parallel/train_fsdp.py``); its BatchNorms take the whole batch's too.
"""

from __future__ import annotations

import dataclasses

import torch

from smart_quantization_tpu_torch.compress.base import CompressorBase, SizeStats, SizeTotals
from smart_quantization_tpu_torch.inject.policy import DEFAULT_POLICY, LayerKind, TapPolicy
from smart_quantization_tpu_torch.ops.keys import DeviceKey
from smart_quantization_tpu_torch.utils.profiling import scope

# call indices a compressor call may draw (SmaQ's sampled-stats offset and
# its rounding noise at most)
DRAWS_PER_COMPRESS = 4


@dataclasses.dataclass
class TapContext:
    """What one forward pass of a tapped model needs: the key the taps draw
    from (a host generator, or the step's ``DeviceKey`` on the card), where
    sizes go (None: not recorded), and, for a model with dropout in
    training mode, the key its masks are drawn from (a generator on the
    model's device, or the step's ``DeviceKey``)."""

    gen: torch.Generator | DeviceKey
    sizes: SizeTotals | None = None
    dropout_gen: torch.Generator | DeviceKey | None = None
    # statistics over the whole batch of the ranks' rows (a
    # parallel/whole_batch.py StatsGroup), or None: this tensor's own
    stats_group: object = None


def _key(k: int | DeviceKey) -> torch.Generator | DeviceKey:
    """A direction's key: a generator of its seed, or its block of call
    indices."""
    if isinstance(k, DeviceKey):
        return k
    gen = torch.Generator()
    gen.manual_seed(k)
    return gen


def _compress(compressor, x, key, group, gamma=None, beta=None):
    """One compressor call on ``x``'s own statistics, or through ``group``
    on those of the whole tensor over its ranks."""
    if group is None:
        return compressor(x, key, gamma=gamma, beta=beta)
    return group.compress(compressor, x, key, gamma=gamma, beta=beta)


class _CompressionTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, compressor, compress_forward, compress_backward,
                key_fwd, key_bwd, sizes, gamma, beta, group):
        ctx.compressor = compressor
        ctx.compress_backward = compress_backward
        ctx.key_bwd = key_bwd
        ctx.sizes = sizes
        ctx.group = group
        if compress_forward:
            with scope("compress/forward"):
                y, s = _compress(compressor, x, _key(key_fwd), group, gamma, beta)
        else:
            y, s = x, SizeStats.of(x.numel(), 32, 32, x.device)
        if y is x:  # a passthrough still has to be a new autograd output
            y = x.view_as(x)
        ctx.mark_non_differentiable(s.orig_bits, s.new_bits)
        return y, s.orig_bits, s.new_bits

    @staticmethod
    def backward(ctx, g, _g_orig, _g_new):
        if ctx.compress_backward:
            with scope("compress/backward"):
                g, s = _compress(ctx.compressor, g.contiguous(), _key(ctx.key_bwd), ctx.group)
            if ctx.sizes is not None:
                ctx.sizes.add("backward_autograd", s)
        return g, None, None, None, None, None, None, None, None, None


def compression_tap(
    x: torch.Tensor,
    gen: torch.Generator | DeviceKey,
    compressor: CompressorBase,
    *,
    compress_forward: bool = True,
    compress_backward: bool = True,
    sizes: SizeTotals | None = None,
    gamma: torch.Tensor | None = None,
    beta: torch.Tensor | None = None,
    stats_group=None,
) -> tuple[torch.Tensor, SizeStats]:
    """Apply the tap; returns ``(y, forward SizeStats)``.  The backward
    sizes are added to ``sizes`` under ``backward_autograd``.  ``gamma`` and
    ``beta`` (no gradient flows to them here) go to the forward compress;
    ``stats_group`` as ``TapContext``'s."""
    if isinstance(gen, DeviceKey):
        key_fwd, key_bwd = gen.reserve(DRAWS_PER_COMPRESS), gen.reserve(DRAWS_PER_COMPRESS)
    else:
        key_fwd, key_bwd = torch.randint(0, 2**62, (2,), generator=gen).tolist()
    y, orig_bits, new_bits = _CompressionTap.apply(
        x, compressor, compress_forward, compress_backward, key_fwd, key_bwd, sizes,
        gamma, beta, stats_group,
    )
    return y, SizeStats(orig_bits, new_bits)


def own_key(gen: torch.Generator | DeviceKey) -> torch.Generator | DeviceKey:
    """The key of one compressor call of its own drawn from ``gen``: a block
    of ``DRAWS_PER_COMPRESS`` call indices of a step key, or a generator of
    one seed drawn from a host generator."""
    if isinstance(gen, DeviceKey):
        return gen.reserve(DRAWS_PER_COMPRESS)
    return _key(int(torch.randint(0, 2**62, (1,), generator=gen)))


class _LossCompression(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loss, compressor, key):
        ctx.derivative = compressor.loss_derivative
        y, _ = compressor(loss.reshape(1), key)
        return y.reshape(())

    @staticmethod
    def backward(ctx, g):
        return g * ctx.derivative, None, None


def compress_loss(loss: torch.Tensor, compressor: CompressorBase,
                  gen: torch.Generator | DeviceKey) -> torch.Tensor:
    """``--compress_loss``: the scalar loss through ``compressor`` under a
    key of its own (``own_key``), as the JAX package's step compresses
    ``loss[None]``.  The gradient is what JAX's autodiff gives through the
    encoder on one element (``CompressorBase.loss_derivative``): the
    identity where the encoder passes the loss through (SmaQ below
    ``min_size``, S2FP8, FP32), zero for FP8, FP16 and BF16, whose rounding
    is bit arithmetic.  No size is counted (the JAX step drops the loss's
    ``SizeStats``)."""
    return _LossCompression.apply(loss, compressor, own_key(gen))


@dataclasses.dataclass(frozen=True)
class TapConfig:
    """Everything a model needs to place compression taps: the compressor,
    the per-direction toggles, the layer policy and the forward tag."""

    compressor: CompressorBase | None = None
    compress_forward: bool = True
    compress_backward: bool = True
    policy: TapPolicy = DEFAULT_POLICY
    use_batch_norm: bool = False
    # the global-hook mode is this config with compress_backward=False and
    # tag="forward_hook"
    tag: str = "forward_autograd"

    def as_global_hook(self) -> "TapConfig":
        """Forward-output-only compression (the reference's global_hook)."""
        return dataclasses.replace(self, compress_backward=False, tag="forward_hook")

    @property
    def active(self) -> bool:
        return self.compressor is not None and (
            self.compress_forward or self.compress_backward
        )


def module_tap(
    x: torch.Tensor,
    kind: LayerKind,
    cfg: TapConfig | None,
    tap_ctx: TapContext | None,
    *,
    gamma: torch.Tensor | None = None,
    beta: torch.Tensor | None = None,
) -> torch.Tensor:
    """Tap ``x`` if ``cfg``'s policy covers ``kind``; forward sizes go to
    ``tap_ctx.sizes`` under ``cfg.tag``.  ``gamma``/``beta`` reach the
    compressor only under ``cfg.use_batch_norm``."""
    if cfg is None or not cfg.active or not cfg.policy.should_tap(kind):
        return x
    if tap_ctx is None:
        raise ValueError("an active tap needs a TapContext (a key + sizes)")
    if not cfg.use_batch_norm:
        gamma = beta = None
    y, stats = compression_tap(
        x,
        tap_ctx.gen,
        cfg.compressor,
        compress_forward=cfg.compress_forward,
        compress_backward=cfg.compress_backward,
        sizes=tap_ctx.sizes,
        gamma=gamma,
        beta=beta,
        stats_group=tap_ctx.stats_group,
    )
    if tap_ctx.sizes is not None:
        tap_ctx.sizes.add(cfg.tag, stats)
    return y
