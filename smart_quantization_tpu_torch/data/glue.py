"""GLUE (all ten task configs) and IMDB, served from the device.

Counterpart of ``smart_quantization_tpu/data/glue.py``: the same task
registry (text fields and label counts), float32 labels for the STSB
regression task and int32 otherwise, the ``validation_matched`` split for
MNLI, ``val_batch_size = batch_size // 4``, and the same deterministic
synthetic corpus (the same ``RandomState`` draws, so byte-identical arrays)
when no local HF ``datasets`` cache holds the task.

Each split is tokenized once and uploaded to the device once
(``device_arrays``), as ``data/cifar.py`` does: a training step slices its
batch on the device and never copies from the host.  Batches are
``(inputs, labels)`` with ``inputs`` a dict of ``input_ids``,
``attention_mask`` and ``token_type_ids`` (int32, ``(batch, max_len)``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from smart_quantization_tpu_torch.data.text import build_tokenizer, hf_home

TASK_TEXT_FIELDS = {
    "cola": ["sentence"],
    "sst2": ["sentence"],
    "mrpc": ["sentence1", "sentence2"],
    "qqp": ["question1", "question2"],
    "stsb": ["sentence1", "sentence2"],
    "mnli": ["premise", "hypothesis"],
    "qnli": ["question", "sentence"],
    "rte": ["sentence1", "sentence2"],
    "wnli": ["sentence1", "sentence2"],
    "ax": ["premise", "hypothesis"],
}

TASK_NUM_LABELS = {
    "cola": 2,
    "sst2": 2,
    "mrpc": 2,
    "qqp": 2,
    "stsb": 1,
    "mnli": 3,
    "qnli": 2,
    "rte": 2,
    "wnli": 2,
    "ax": 3,
}

INPUT_KEYS = ("input_ids", "attention_mask", "token_type_ids")

_WORDS = (
    "the a of to and in that it is was for on are as with his they at be "
    "this have from or one had by word but not what all were we when your "
    "can said there use an each which she do how their if will up other "
    "about out many then them these so some her would make like him into "
    "time has look two more write go see number no way could people my"
).split()


def _synthetic_examples(task: str, n: int, seed: int):
    """Label-correlated synthetic sentences (offline stand-in), the JAX
    package's draws in its order."""
    rng = np.random.RandomState(seed)
    fields = TASK_TEXT_FIELDS[task]
    num_labels = TASK_NUM_LABELS[task]
    markers = ["alpha", "bravo", "charlie"]
    out = []
    for _ in range(n):
        if task == "stsb":
            label = float(rng.uniform(0, 5))
            base = [rng.choice(_WORDS) for _ in range(12)]
            overlap = int(round(label / 5 * 10))
            s2 = base[:overlap] + [rng.choice(_WORDS) for _ in range(12 - overlap)]
            ex = {"sentence1": " ".join(base), "sentence2": " ".join(s2), "label": label}
        else:
            label = int(rng.randint(num_labels))
            words = [rng.choice(_WORDS) for _ in range(14)]
            words[rng.randint(14)] = markers[label % len(markers)]
            ex = {f: " ".join(words) for f in fields}
            ex["label"] = label
        out.append(ex)
    return out


def _load_datasets(*load_args):
    """``datasets.load_dataset(*load_args)`` from the local cache only, or
    None: ``datasets`` is imported only when a local cache directory
    exists, and then in offline mode (no download is ever tried)."""
    cache = os.environ.get("HF_DATASETS_CACHE", os.path.join(hf_home(), "datasets"))
    if not os.path.isdir(cache):
        return None
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    try:
        import datasets

        return datasets.load_dataset(*load_args)
    except (ImportError, OSError, ValueError):
        return None


def _load_glue(task: str):
    ds = _load_datasets("glue", task)
    if ds is None:
        return None
    val_key = "validation_matched" if task == "mnli" else "validation"
    return list(ds["train"]), list(ds[val_key])


class GLUEData:
    """One GLUE task: tokenized splits, shuffled training epochs, batches
    on the device."""

    def __init__(
        self,
        task: str = "stsb",
        batch_size: int = 32,
        val_batch_size: int | None = None,
        max_input_length: int = 512,
        tokenizer_name: str = "bert-base-uncased",
        synthetic_train: int = 1024,
        synthetic_val: int = 256,
    ):
        if task not in TASK_TEXT_FIELDS:
            raise ValueError(f"unknown GLUE task {task!r}")
        loaded = _load_glue(task)
        self.synthetic = loaded is None
        if loaded is None:
            loaded = (_synthetic_examples(task, synthetic_train, 0),
                      _synthetic_examples(task, synthetic_val, 1))
        self._setup(task, TASK_NUM_LABELS[task], task == "stsb", TASK_TEXT_FIELDS[task],
                    loaded, batch_size, val_batch_size, max_input_length, tokenizer_name)

    def _setup(self, task, num_labels, is_regression, text_fields, loaded, batch_size,
               val_batch_size, max_input_length, tokenizer_name):
        self.task = task
        self.num_labels = num_labels
        self.is_regression = is_regression
        self.text_fields = text_fields
        self.batch_size = batch_size
        self.val_batch_size = val_batch_size or max(batch_size // 4, 1)
        self.max_input_length = max_input_length
        self.tokenizer = build_tokenizer(tokenizer_name)
        self.train_examples, self.val_examples = loaded
        self.train_arrays = self._encode(self.train_examples)
        self.val_arrays = self._encode(self.val_examples)
        self._device_arrays: dict = {}

    def _encode(self, examples) -> dict[str, np.ndarray]:
        """Every example of a split as int32 ``(n, max_len)`` arrays and
        the labels (float32 for STSB, int32 otherwise)."""
        ids, masks, types, labels = [], [], [], []
        for ex in examples:
            a = ex[self.text_fields[0]]
            b = ex[self.text_fields[1]] if len(self.text_fields) == 2 else None
            i, m, t = self.tokenizer.encode_pair(a, b, self.max_input_length)
            ids.append(i)
            masks.append(m)
            types.append(t)
            labels.append(ex["label"])
        shape = (len(examples), self.max_input_length)
        return dict(
            input_ids=np.asarray(ids, np.int32).reshape(shape),
            attention_mask=np.asarray(masks, np.int32).reshape(shape),
            token_type_ids=np.asarray(types, np.int32).reshape(shape),
            labels=np.asarray(labels, np.float32 if self.is_regression else np.int32),
        )

    def epoch_order(self, epoch_seed: int) -> np.ndarray:
        # the reference leaves the train shuffle commented out (glue.py:124);
        # the JAX package shuffles, and so does the port
        order = np.arange(len(self.train_examples))
        np.random.RandomState(epoch_seed).shuffle(order)
        return order

    @staticmethod
    def _host_batches(arrays, order, bs):
        for i in range(0, len(order) - bs + 1, bs):
            idx = order[i : i + bs]
            yield {k: v[idx] for k, v in arrays.items()}

    def train_batches(self, epoch_seed: int):
        """Host batches (dicts of numpy arrays with ``labels``) in the JAX
        package's order."""
        yield from self._host_batches(self.train_arrays, self.epoch_order(epoch_seed),
                                      self.batch_size)

    def val_batches(self):
        yield from self._host_batches(self.val_arrays, np.arange(len(self.val_examples)),
                                      self.val_batch_size)

    def device_arrays(self, device: torch.device) -> dict[str, dict[str, torch.Tensor]]:
        """Both splits on ``device`` (uploaded once, then cached)."""
        key = str(device)
        if key not in self._device_arrays:
            self._device_arrays[key] = {
                split: {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
                for split, arrays in (("train", self.train_arrays), ("val", self.val_arrays))
            }
        return self._device_arrays[key]

    def device_train_batches(self, epoch_seed: int, device: torch.device):
        """One epoch of shuffled ``(inputs, labels)`` batches sliced on the
        device, in ``train_batches``' order: one host-to-device copy of the
        epoch's order, none per batch."""
        arrs = self.device_arrays(device)["train"]
        order = torch.from_numpy(self.epoch_order(epoch_seed)).to(device)
        bs = self.batch_size
        for i in range(0, len(order) - bs + 1, bs):
            idx = order[i : i + bs]
            yield {k: arrs[k][idx] for k in INPUT_KEYS}, arrs["labels"][idx]

    def device_val_batches(self, device: torch.device):
        arrs = self.device_arrays(device)["val"]
        bs = self.val_batch_size
        for i in range(0, len(self.val_examples) - bs + 1, bs):
            yield {k: arrs[k][i : i + bs] for k in INPUT_KEYS}, arrs["labels"][i : i + bs]

    @property
    def steps_per_epoch(self) -> int:
        return len(self.train_examples) // self.batch_size

    @property
    def val_steps_per_epoch(self) -> int:
        return len(self.val_examples) // self.val_batch_size


class IMDBData(GLUEData):
    """IMDB sentiment (reference data/imdb.py:17-102): one text field,
    binary labels; the synthetic stand-in is SST-2's corpus drawn with
    seeds 2 and 3."""

    def __init__(self, batch_size: int = 32, val_batch_size: int | None = None,
                 max_input_length: int = 512, tokenizer_name: str = "bert-base-uncased",
                 synthetic_train: int = 1024, synthetic_val: int = 256):
        ds = _load_datasets("imdb")
        loaded = None if ds is None else (list(ds["train"]), list(ds["test"]))
        self.synthetic = loaded is None
        if loaded is None:
            loaded = tuple(
                [{"text": e["sentence"], "label": e["label"]} for e in
                 _synthetic_examples("sst2", n, seed)]
                for n, seed in ((synthetic_train, 2), (synthetic_val, 3))
            )
        self._setup("imdb", 2, False, ["text"], loaded, batch_size, val_batch_size,
                    max_input_length, tokenizer_name)
