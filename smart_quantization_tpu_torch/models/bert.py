"""BERT for sequence classification in PyTorch.

Counterpart of ``smart_quantization_tpu/models/bert.py``, module by module
and with the same names, so ``convert.params_from_jax`` maps the flax tree
onto the ``state_dict`` (the flax ``dense`` and ``norm`` levels fold away):

- ``TappedDense`` taps its output (bias included) as ``LINEAR``;
  ``TappedLayerNorm`` taps its output as ``NORM``;
- ``BertSelfAttention`` computes QK^T and PV with ``torch.matmul`` (the
  JAX package's ``jnp.einsum``, outside any kernel), divides by sqrt(d),
  adds the mask bias ``(1 - mask) * -1e9``, takes the softmax in float32,
  drops out probabilities and taps the context as ``ATTENTION``;
- the intermediate GELU is exact and not tapped (the reference's patcher
  never saw it); the pooler's Dense is not tapped, its tanh is, as
  ``ACTIVATION``; the classifier is tapped as ``LINEAR``; ``EMBED`` taps
  the embeddings after their norm and dropout.  The default policy leaves
  ``EMBED`` and ``ATTENTION`` out: 99 tap sites in bert-base;
- Dense and embedding weights are drawn from N(0, 0.02) by an explicit
  generator, biases are 0, LayerNorm eps is 1e-12;
- ``freeze_encoder`` detaches the encoder's output before the pooler: the
  encoder leaves get no gradient, which the trainer takes as zeros (JAX's
  ``stop_gradient`` gives zeros), so AdamW still decays them and the
  weight tap still compresses them.

Dropout is flax's: keep with probability 1 - rate, scale the kept values
by 1 / (1 - rate).  Its masks are drawn in training mode from
``TapContext.dropout_gen`` (a generator on the CPU, or the step's key on
the card, that the trainer derives from the seed and the step), never from
the global RNG.
The word-embedding gradient is dense, as JAX's.

``dtype`` is the compute dtype (``--compute_dtype``), with flax's
semantics of ``dtype=`` on each module, by explicit casts (not
``torch.autocast``, whose per-op rules are not flax's): the embedding sum
stays float32 and is then cast; each Dense casts its float32 weight and
bias to it; the attention scores are in it, the float32 mask bias is
added to them in float32 and the softmax taken in float32, then cast back;
dropout, GELU, tanh and the residual adds run in it; LayerNorm takes its
statistics and normalizes in float32 (flax's ``_compute_stats`` and
``_normalize`` promote to float32) and returns its input's dtype; the
logits come back float32.  Parameters stay float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from smart_quantization_tpu_torch.inject.policy import LayerKind
from smart_quantization_tpu_torch.inject.tap import TapConfig, TapContext, module_tap
from smart_quantization_tpu_torch.ops.keys import DeviceKey
from smart_quantization_tpu_torch.ops.rounding import uniform

INIT_STD = 0.02


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12

    @staticmethod
    def tiny() -> "BertConfig":
        """The 2-layer test config; the full vocabulary keeps tokenizer ids
        in range."""
        return BertConfig(
            vocab_size=30522, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_position_embeddings=512,
        )


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | DeviceKey | None) -> torch.Tensor:
    """flax's ``nn.Dropout`` in training mode, masks drawn from ``gen`` (a
    generator on ``x``'s device, or the step's key: ``rounding.uniform``)."""
    if rate == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in training mode needs TapContext.dropout_gen")
    keep_prob = 1.0 - rate
    keep = uniform(x.shape, gen, x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is (out, in) as torch's, the bias 0."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.zeros(fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Embed(nn.Module):
    def __init__(self, num: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class TappedDense(Dense):
    def __init__(self, fin: int, fout: int, tap: TapConfig | None):
        super().__init__(fin, fout)
        self.tap = tap

    def forward(self, x, tap_ctx=None):
        return module_tap(super().forward(x), LayerKind.LINEAR, self.tap, tap_ctx)


class TappedLayerNorm(nn.Module):
    def __init__(self, features: int, eps: float, tap: TapConfig | None):
        super().__init__()
        self.tap = tap
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, tap_ctx=None):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, self.eps).to(x.dtype)
        return module_tap(y, LayerKind.NORM, self.tap, tap_ctx)


def _dropout_gen(tap_ctx: TapContext | None) -> torch.Generator | DeviceKey | None:
    return None if tap_ctx is None else tap_ctx.dropout_gen


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, tap: TapConfig | None):
        super().__init__()
        self.cfg, self.tap = cfg, tap
        h = cfg.hidden_size
        self.query = TappedDense(h, h, tap)
        self.key = TappedDense(h, h, tap)
        self.value = TappedDense(h, h, tap)
        self.output = TappedDense(h, h, tap)
        self.output_norm = TappedLayerNorm(h, cfg.layer_norm_eps, tap)

    def forward(self, x, mask_bias, tap_ctx=None):
        cfg = self.cfg
        b, length, h = x.shape
        heads, head_dim = cfg.num_heads, h // cfg.num_heads
        rate = cfg.dropout_rate if self.training else 0.0
        gen = _dropout_gen(tap_ctx)

        def heads_first(t):  # (b, l, h) -> (b, heads, l, head_dim)
            return t.view(b, length, heads, head_dim).transpose(1, 2)

        q = heads_first(self.query(x, tap_ctx))
        k = heads_first(self.key(x, tap_ctx))
        v = heads_first(self.value(x, tap_ctx))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim)
        probs = torch.softmax(scores.float() + mask_bias, dim=-1).to(x.dtype)
        probs = dropout(probs, rate, gen)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, length, h)
        ctx = module_tap(ctx, LayerKind.ATTENTION, self.tap, tap_ctx)
        out = dropout(self.output(ctx, tap_ctx), rate, gen)
        return self.output_norm(out + x, tap_ctx)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, tap: TapConfig | None):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg, tap)
        self.intermediate = TappedDense(cfg.hidden_size, cfg.intermediate_size, tap)
        self.ffn_output = TappedDense(cfg.intermediate_size, cfg.hidden_size, tap)
        self.ffn_norm = TappedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, tap)

    def forward(self, x, mask_bias, tap_ctx=None):
        x = self.attention(x, mask_bias, tap_ctx)
        # not tapped: the reference-era HF BERT's GELU is a function, which
        # the reference's patcher never reached
        h = F.gelu(self.intermediate(x, tap_ctx), approximate="none")
        h = self.ffn_output(h, tap_ctx)
        h = dropout(h, self.cfg.dropout_rate if self.training else 0.0, _dropout_gen(tap_ctx))
        return self.ffn_norm(h + x, tap_ctx)


class BertForSequenceClassification(nn.Module):
    """``num_labels`` logits (float32) from ``(batch, length)`` token ids,
    attention mask and token types."""

    def __init__(self, cfg: BertConfig, num_labels: int = 2, tap: TapConfig | None = None,
                 freeze_encoder: bool = False, seed: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.tap, self.freeze_encoder = cfg, tap, freeze_encoder
        self.compute_dtype = dtype
        h = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, h)
        self.position_embeddings = Embed(cfg.max_position_embeddings, h)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, h)
        self.embeddings_norm = TappedLayerNorm(h, cfg.layer_norm_eps, tap)
        self.layer_names = [f"layer_{i}" for i in range(cfg.num_layers)]
        for name in self.layer_names:
            self.add_module(name, BertLayer(cfg, tap))
        self.pooler = Dense(h, h)
        self.classifier = Dense(h, num_labels)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Dense, Embed)):
                    m.weight.normal_(0.0, INIT_STD, generator=gen)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                tap_ctx: TapContext | None = None) -> torch.Tensor:
        tap, cfg = self.tap, self.cfg
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        rate = cfg.dropout_rate if self.training else 0.0
        gen = _dropout_gen(tap_ctx)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = (self.word_embeddings(input_ids) + self.position_embeddings(pos)[None]
               + self.token_type_embeddings(token_type_ids))
        x = dropout(self.embeddings_norm(emb.to(self.compute_dtype), tap_ctx), rate, gen)
        x = module_tap(x, LayerKind.EMBED, tap, tap_ctx)
        mask_bias = (1.0 - attention_mask.float()[:, None, None, :]) * -1e9
        for name in self.layer_names:
            x = getattr(self, name)(x, mask_bias, tap_ctx)
        if self.freeze_encoder:
            x = x.detach()
        pooled = torch.tanh(self.pooler(x[:, 0]))
        pooled = dropout(module_tap(pooled, LayerKind.ACTIVATION, tap, tap_ctx), rate, gen)
        logits = module_tap(self.classifier(pooled), LayerKind.LINEAR, tap, tap_ctx)
        return logits.float()
