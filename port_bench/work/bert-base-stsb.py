"""The work of a bert-base sequence-regression training step, counted from
the configuration's published shapes (not from what the program launches).

- ``flops_per_sample``: 3 x the forward pass: 2 x the multiply-accumulates
  of every linear layer of the encoder, the pooler and the head on every
  position of the padded sequence, plus the attention's two products
  (scores and context); embeddings, LayerNorm, softmax and GELU left out;
- ``compression``: the elements SmaQ quantizes in a step on one chip, by
  structure and element type: the 99 tapped maps forward and their
  gradient maps backward (in the compute dtype), and, in float32, every
  gradient, every weight and Adam's two moments (2 passes: read once,
  written once); and the 32-bit random words of the dropout masks, which
  the program's own Philox kernel writes (1 pass).
"""


def _linear_macs_per_token(cfg) -> int:
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (4 * h * h + 2 * h * f)


def flops_per_sample(cfg) -> float:
    h, length = cfg["hidden_size"], cfg["max_position_embeddings"]
    encoder = _linear_macs_per_token(cfg) * length
    attention = cfg["num_hidden_layers"] * 2 * length * length * h
    head = h * h + h * cfg["num_labels"]
    return 3 * 2.0 * (encoder + attention + head)


def params(cfg) -> int:
    h, f, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    emb = (cfg["vocab_size"] + cfg["max_position_embeddings"] + cfg["type_vocab_size"]) * h + 2 * h
    layer = 4 * (h * h + h) + 2 * h + (h * f + f) + (f * h + h) + 2 * h
    return emb + layers * layer + (h * h + h) + (h + 1) * cfg["num_labels"]


def _tapped_elements(cfg) -> int:
    """Elements of the 99 tapped maps of one sample."""
    h, f, length = cfg["hidden_size"], cfg["intermediate_size"], cfg["max_position_embeddings"]
    per_layer = (7 * h + f) * length  # q, k, v, output, two norms, ffn output; intermediate
    return h * length + cfg["num_hidden_layers"] * per_layer + h + cfg["num_labels"]


def _dropout_words(cfg) -> int:
    """Random words of one sample's dropout masks: after the embeddings,
    on the attention probabilities and two sublayer outputs a layer, on
    the pooler."""
    h, length, heads = (cfg["hidden_size"], cfg["max_position_embeddings"],
                        cfg["num_attention_heads"])
    per_layer = heads * length * length + 2 * h * length
    return h * length + cfg["num_hidden_layers"] * per_layer + h


def compression(cfg, mix) -> list[tuple[str, int, str, int]]:
    if not mix["compress"]:
        return []
    rows = mix["batch"] // mix["chips"]
    maps = rows * _tapped_elements(cfg)
    p = params(cfg)
    dt = mix["compute_dtype"]
    return [("forward_maps", maps, dt, 2), ("gradient_maps", maps, dt, 2),
            ("gradients", p, "float32", 2), ("weights", p, "float32", 2),
            ("momentum", 2 * p, "float32", 2),
            ("dropout_words", rows * _dropout_words(cfg), "uint32", 1)]
