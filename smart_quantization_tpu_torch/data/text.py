"""Tokenization for the text pipelines.

Counterpart of ``smart_quantization_tpu/data/text.py``: a locally cached HF
BERT tokenizer when ``transformers`` and a local copy of the tokenizer are
both present, otherwise the deterministic hash tokenizer with BERT's
special-token conventions (the same ids as the JAX package's), so the GLUE
and IMDB pipelines run without a network.  Nothing is downloaded: the HF
path loads with ``local_files_only=True``, and ``transformers`` is imported
only when a local copy exists.
"""

from __future__ import annotations

import hashlib
import os

PAD_ID, UNK_ID, CLS_ID, SEP_ID = 0, 100, 101, 102
DEFAULT_VOCAB = 30522


def hf_home() -> str:
    return os.environ.get("HF_HOME", os.path.join(os.path.expanduser("~"), ".cache", "huggingface"))


def hub_cached(name: str) -> bool:
    """True when ``name`` is a local directory or has an entry in the local
    HF hub cache (where ``from_pretrained(..., local_files_only=True)``
    looks)."""
    if os.path.isdir(name):
        return True
    hub = os.environ.get("HF_HUB_CACHE", os.path.join(hf_home(), "hub"))
    return os.path.isdir(os.path.join(hub, "models--" + name.replace("/", "--")))


class HashTokenizer:
    """Deterministic word-hash tokenizer (offline fallback): md5 of each
    lower-cased word into ids 1000..vocab-1, [CLS] a [SEP] (b [SEP]), token
    types 0/1, truncated and padded to ``max_len``."""

    vocab_size = DEFAULT_VOCAB

    def _word_ids(self, text: str) -> list[int]:
        return [
            1000 + int(hashlib.md5(w.encode()).hexdigest()[:8], 16) % (self.vocab_size - 1000)
            for w in text.lower().split()
        ]

    def encode_pair(self, a: str, b: str | None, max_len: int):
        ids = [CLS_ID] + self._word_ids(a) + [SEP_ID]
        types = [0] * len(ids)
        if b is not None:
            more = self._word_ids(b) + [SEP_ID]
            ids += more
            types += [1] * len(more)
        ids, types = ids[:max_len], types[:max_len]
        pad = max_len - len(ids)
        return ids + [PAD_ID] * pad, [1] * len(ids) + [0] * pad, types + [0] * pad


class HFTokenizer:
    """A locally cached HF tokenizer (never downloads)."""

    def __init__(self, name: str = "bert-base-uncased"):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
        self.vocab_size = self.tok.vocab_size

    def encode_pair(self, a: str, b: str | None, max_len: int):
        out = self.tok(a, b, max_length=max_len, padding="max_length",
                       truncation="longest_first")
        return out["input_ids"], out["attention_mask"], out.get("token_type_ids", [0] * max_len)


def build_tokenizer(name: str = "bert-base-uncased"):
    """The HF tokenizer ``name`` if ``transformers`` and a local copy are
    present, else :class:`HashTokenizer`."""
    if hub_cached(name):
        try:
            return HFTokenizer(name)
        except (ImportError, OSError, ValueError) as e:
            print(f"tokenizer {name!r} unavailable offline ({type(e).__name__}); "
                  "using the hash tokenizer")
    return HashTokenizer()
