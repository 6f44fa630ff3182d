"""The port's text pipeline against the JAX package's: the hash tokenizer's
ids, the synthetic GLUE and IMDB corpora, the tokenized batches and the
GLUE metrics, all exactly equal (no tolerance: the same integer and numpy
arithmetic on both sides).

Without a local HF cache (as here) both packages take the hash tokenizer
and the synthetic corpus.  The JAX loaders find that out by importing
``transformers`` and ``datasets`` (about 12 s in a fresh process); the
batch tests hand them those fallbacks directly, and check separately that
the port takes them on its own.
"""

import numpy as np
import pytest
import torch

from smart_quantization_tpu.data import glue as jglue
from smart_quantization_tpu.data import text as jtext
from smart_quantization_tpu.train import glue_metrics as jmetrics
from smart_quantization_tpu_torch.data import glue, text
from smart_quantization_tpu_torch.train import glue_metrics

PAIRS = [
    ("The quick brown fox", "jumps over the lazy dog", 32),
    ("A single sentence with UPPER case words.", None, 16),
    ("one two three four five six seven eight nine ten", "eleven twelve", 8),
    ("", None, 4),
    ("word", "", 6),
]


@pytest.mark.parametrize("a,b,max_len", PAIRS)
def test_hash_tokenizer_ids_equal_jax(a, b, max_len):
    got = text.HashTokenizer().encode_pair(a, b, max_len)
    assert got == jtext.HashTokenizer().encode_pair(a, b, max_len)
    ids, mask, types = got
    assert len(ids) == len(mask) == len(types) == max_len
    assert ids[0] == text.CLS_ID


def test_no_cache_means_the_hash_tokenizer(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    assert not text.hub_cached("bert-base-uncased")
    assert isinstance(text.build_tokenizer("bert-base-uncased"), text.HashTokenizer)
    (tmp_path / "hub" / "models--bert-base-uncased").mkdir(parents=True)
    assert text.hub_cached("bert-base-uncased")


def test_task_registry_equals_jax():
    assert glue.TASK_TEXT_FIELDS == jglue.TASK_TEXT_FIELDS
    assert glue.TASK_NUM_LABELS == jglue.TASK_NUM_LABELS


@pytest.mark.parametrize("task", sorted(jglue.TASK_TEXT_FIELDS))
def test_synthetic_examples_equal_jax(task):
    for seed in (0, 3):
        assert glue._synthetic_examples(task, 24, seed) == jglue._synthetic_examples(task, 24, seed)


@pytest.fixture
def jax_offline(monkeypatch):
    """The JAX loaders' no-cache fallbacks, without their imports."""
    monkeypatch.setattr(jglue, "build_tokenizer", lambda name="": jtext.HashTokenizer())
    monkeypatch.setattr(jglue, "_load_hf", lambda task: None)
    monkeypatch.setattr(jglue.IMDBData, "_load_imdb", staticmethod(lambda: None))


def assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("task", ["stsb", "mrpc", "cola", "mnli", "imdb"])
def test_batches_equal_jax(task, jax_offline, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))  # no local cache
    kw = dict(batch_size=16, max_input_length=24)
    if task == "imdb":
        ours, theirs = glue.IMDBData(**kw), jglue.IMDBData(**kw)
    else:
        ours, theirs = glue.GLUEData(task=task, **kw), jglue.GLUEData(task=task, **kw)
    assert ours.synthetic and isinstance(ours.tokenizer, text.HashTokenizer)
    assert (len(ours.train_examples), len(ours.val_examples)) == (1024, 256)
    assert ours.val_batch_size == theirs.val_batch_size == 4
    assert (ours.num_labels, ours.is_regression) == (theirs.num_labels, theirs.is_regression)
    assert ours.steps_per_epoch == theirs.steps_per_epoch
    assert ours.val_steps_per_epoch == theirs.val_steps_per_epoch
    assert ours.train_arrays["labels"].dtype == (np.float32 if task == "stsb" else np.int32)
    assert_batches_equal(ours.train_batches(5), theirs.train_batches(5))
    assert_batches_equal(ours.val_batches(), theirs.val_batches())


def test_device_batches_are_the_host_batches():
    """The batches sliced from the uploaded splits (here on the CPU) are
    the host batches, in the same order."""
    data = glue.GLUEData(task="stsb", batch_size=32, max_input_length=16)
    dev = torch.device("cpu")
    host = list(data.train_batches(7))
    got = list(data.device_train_batches(7, dev))
    assert len(got) == len(host) == data.steps_per_epoch
    for (inputs, labels), h in zip(got, host):
        for k in glue.INPUT_KEYS:
            np.testing.assert_array_equal(inputs[k].numpy(), h[k])
        np.testing.assert_array_equal(labels.numpy(), h["labels"])
    val = list(data.device_val_batches(dev))
    assert len(val) == data.val_steps_per_epoch
    np.testing.assert_array_equal(torch.cat([lb for _, lb in val]).numpy(),
                                  data.val_arrays["labels"])
    # uploaded once
    assert data.device_arrays(dev) is data.device_arrays(dev)


@pytest.mark.parametrize("task", ["stsb", "cola", "mrpc", "qqp", "sst2", "mnli", "imdb"])
def test_glue_metrics_equal_jax(task):
    r = np.random.RandomState(4)
    if task == "stsb":
        labels = np.round(r.uniform(0, 5, 64), 1).astype(np.float32)  # ties for spearman
        preds = (labels + r.randn(64)).astype(np.float32)
        preds[:5] = preds[5]
    else:
        k = 3 if task == "mnli" else 2
        labels = r.randint(k, size=64).astype(np.int32)
        preds = np.where(r.rand(64) < 0.7, labels, r.randint(k, size=64)).astype(np.int64)
    got = glue_metrics.glue_metrics(task, preds, labels)
    assert got == jmetrics.glue_metrics(task, preds, labels)
    assert all(np.isfinite(v) for v in got.values())
