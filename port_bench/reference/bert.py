"""BERT for sequence regression (Devlin et al. 2019; bert-base-uncased's
published config), forward and loss in plain PyTorch over a dict of
float32 parameters.

Post-norm encoder layers: self-attention (scores scaled by 1/sqrt(head
size), an additive mask bias of -1e9 on padding, the softmax in float32),
dropout on the probabilities and on each sublayer's output, exact GELU,
LayerNorm in float32 (eps 1e-12); the pooler's tanh on the first token;
a linear head of one output, trained by mean squared error.  The compute
dtype casts the embedding sum and each weight at use; the logits come
back float32.  Dropout keeps an element with probability 1 - rate and
scales it by 1 / (1 - rate).

A compression tap sits after the embeddings' LayerNorm, after each linear
layer of a layer (query, key, value, attention output, intermediate,
output), after each LayerNorm, on the pooler's tanh and on the head's
output (99 in bert-base), in this order; the attention context, the
embedding sum and the GELU are not tapped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

INPUT_KEYS = ("input_ids", "attention_mask", "token_type_ids")


def param_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    shapes = [("word_embeddings.weight", (cfg["vocab_size"], h)),
              ("position_embeddings.weight", (cfg["max_position_embeddings"], h)),
              ("token_type_embeddings.weight", (cfg["type_vocab_size"], h)),
              ("embeddings_norm.weight", (h,)), ("embeddings_norm.bias", (h,))]

    def dense(name, fin, fout):
        return [(f"{name}.weight", (fout, fin)), (f"{name}.bias", (fout,))]

    for i in range(cfg["num_hidden_layers"]):
        a = f"layer_{i}.attention"
        for part in ("query", "key", "value", "output"):
            shapes += dense(f"{a}.{part}", h, h)
        shapes += [(f"{a}.output_norm.weight", (h,)), (f"{a}.output_norm.bias", (h,))]
        shapes += dense(f"layer_{i}.intermediate", h, f) + dense(f"layer_{i}.ffn_output", f, h)
        shapes += [(f"layer_{i}.ffn_norm.weight", (h,)), (f"layer_{i}.ffn_norm.bias", (h,))]
    return shapes + dense("pooler", h, h) + dense("classifier", h, cfg["num_labels"])


def _dense(step, p, name, x):
    w, b = p[name + ".weight"], p[name + ".bias"]
    return F.linear(step.operand(x), step.operand(w.to(x.dtype)), b.to(x.dtype))


def _norm(step, p, name, x, eps):
    y = F.layer_norm(x.float(), x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)
    return step.tap(y.to(x.dtype))


def forward(cfg: dict, p: dict, inputs: dict, step, dtype: torch.dtype) -> torch.Tensor:
    """Float32 logits ``(batch, num_labels)`` of int token ids, mask and
    token types ``(batch, length)``."""
    tap = step.tap
    ids, mask, types = (inputs[k] for k in INPUT_KEYS)
    rate, eps = cfg["hidden_dropout_prob"], cfg["layer_norm_eps"]
    heads = cfg["num_attention_heads"]
    b, length = ids.shape
    pos = torch.arange(length, device=ids.device)
    emb = (F.embedding(ids, p["word_embeddings.weight"])
           + F.embedding(pos, p["position_embeddings.weight"])[None]
           + F.embedding(types, p["token_type_embeddings.weight"]))
    x = step.dropout(_norm(step, p, "embeddings_norm", emb.to(dtype), eps), rate)
    mask_bias = (1.0 - mask.float()[:, None, None, :]) * -1e9
    for i in range(cfg["num_hidden_layers"]):
        a = f"layer_{i}.attention"
        h = x.shape[-1]
        head_dim = h // heads

        def heads_first(t):
            return t.view(b, length, heads, head_dim).transpose(1, 2)

        q = heads_first(tap(_dense(step, p, f"{a}.query", x)))
        k = heads_first(tap(_dense(step, p, f"{a}.key", x)))
        v = heads_first(tap(_dense(step, p, f"{a}.value", x)))
        scores = torch.matmul(step.operand(q), step.operand(k).transpose(-1, -2)) / math.sqrt(
            head_dim)
        probs = torch.softmax(scores.float() + mask_bias, dim=-1).to(x.dtype)
        probs = step.dropout(probs, cfg["attention_probs_dropout_prob"])
        ctx = torch.matmul(step.operand(probs), step.operand(v)).transpose(1, 2).reshape(
            b, length, h)
        out = step.dropout(tap(_dense(step, p, f"{a}.output", ctx)), rate)
        x = _norm(step, p, f"{a}.output_norm", out + x, eps)
        y = F.gelu(tap(_dense(step, p, f"layer_{i}.intermediate", x)), approximate="none")
        y = step.dropout(tap(_dense(step, p, f"layer_{i}.ffn_output", y)), rate)
        x = _norm(step, p, f"layer_{i}.ffn_norm", y + x, eps)
    pooled = torch.tanh(_dense(step, p, "pooler", x[:, 0]))
    pooled = step.dropout(tap(pooled), rate)
    return tap(_dense(step, p, "classifier", pooled)).float()


def loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((logits[:, 0] - labels) ** 2)
