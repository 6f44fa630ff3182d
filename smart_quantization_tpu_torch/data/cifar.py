"""CIFAR-10/100 data, with augmentation on the device.

Counterpart of ``smart_quantization_tpu/data/cifar.py``: the same
normalization constants, the same pad-4 random crop + horizontal flip on
train batches (on the device, from a ``torch.Generator`` on that device),
``val_batch_size = batch_size // 4``, the same pickle loaders, and the same
deterministic synthetic stand-in (byte-identical arrays) when the archives
are not under ``$SMAQ_DATA_DIR``.

Batches keep the JAX package's NHWC uint8 layout at the public functions.
The whole split is uploaded to the device once (``device_arrays``), so a
training step slices its batch on the device and never copies from the
host.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.247, 0.243, 0.261], np.float32)


def _data_dir() -> str:
    return os.environ.get("SMAQ_DATA_DIR", os.path.expanduser("~/datasets"))


def _load_cifar10(root: str):
    d = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        return None
    xs, ys = [], []
    for name in [f"data_batch_{i}" for i in range(1, 6)]:
        with open(os.path.join(d, name), "rb") as f:
            batch = pickle.load(f, encoding="latin1")
        xs.append(batch["data"])
        ys.extend(batch["labels"])
    train_x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    train_y = np.array(ys, np.int32)
    with open(os.path.join(d, "test_batch"), "rb") as f:
        batch = pickle.load(f, encoding="latin1")
    test_x = batch["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    test_y = np.array(batch["labels"], np.int32)
    return (train_x, train_y), (test_x, test_y)


def _load_cifar100(root: str):
    d = os.path.join(root, "cifar-100-python")
    if not os.path.isdir(d):
        return None
    out = []
    for name in ("train", "test"):
        with open(os.path.join(d, name), "rb") as f:
            batch = pickle.load(f, encoding="latin1")
        x = batch["data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y = np.array(batch["fine_labels"], np.int32)
        out.append((x, y))
    return tuple(out)


def _synthetic(num_classes: int, n_train: int = 2048, n_test: int = 512):
    """Deterministic class-separable synthetic CIFAR stand-in, the same
    draws as the JAX package's (``SMAQ_SYNTH_TRAIN_N`` / ``_TEST_N`` /
    ``_SHIFT`` resize the splits and set the per-class shift)."""
    n_train = int(os.environ.get("SMAQ_SYNTH_TRAIN_N", n_train))
    n_test = int(os.environ.get("SMAQ_SYNTH_TEST_N", n_test))
    shift_step = int(
        os.environ.get("SMAQ_SYNTH_SHIFT", 128 // max(num_classes - 1, 1))
    )
    rng = np.random.RandomState(0)

    def make(n):
        y = rng.randint(0, num_classes, size=n).astype(np.int32)
        x = rng.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)
        shift = (y[:, None, None, None] * shift_step).astype(np.uint8)
        x = ((x.astype(np.int32) + shift) // 2).astype(np.uint8)
        return x, y

    return make(n_train), make(n_test)


_constants: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}


def normalize(batch_u8: torch.Tensor) -> torch.Tensor:
    """NHWC uint8 -> NHWC float32, per-channel standardized."""
    key = str(batch_u8.device)
    if key not in _constants:  # one upload per device, not one per batch
        _constants[key] = (
            torch.from_numpy(CIFAR_MEAN).to(batch_u8.device),
            torch.from_numpy(CIFAR_STD).to(batch_u8.device),
        )
    mean, std = _constants[key]
    return (batch_u8.to(torch.float32) / 255.0 - mean) / std


def augment(batch_u8: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Random crop (pad 4) + horizontal flip of an NHWC uint8 batch, on the
    batch's device; ``gen`` is a generator on that device."""
    n, h, w, _ = batch_u8.shape
    dev = batch_u8.device
    padded = F.pad(batch_u8, (0, 0, 4, 4, 4, 4))
    off = torch.randint(0, 9, (n, 2), generator=gen, device=dev)
    flip = torch.rand(n, generator=gen, device=dev) < 0.5
    rows = off[:, :1] + torch.arange(h, device=dev)
    cols = off[:, 1:] + torch.arange(w, device=dev)
    cols = torch.where(flip[:, None], cols.flip(1), cols)
    idx = torch.arange(n, device=dev)[:, None, None]
    return padded[idx, rows[:, :, None], cols[:, None, :]]


class CIFARData:
    """Shuffled-epoch batcher over in-memory arrays (labels int32, NHWC u8),
    serving batches from the device."""

    num_classes: int = 10

    def __init__(self, batch_size: int = 8, val_batch_size: int | None = None):
        self.batch_size = batch_size
        self.val_batch_size = val_batch_size or max(batch_size // 4, 1)
        loaded = self._load(_data_dir())
        self.synthetic = loaded is None
        if loaded is None:
            loaded = _synthetic(self.num_classes)
        (self.train_x, self.train_y), (self.test_x, self.test_y) = loaded
        self._device_arrays: dict = {}

    def _load(self, root):
        raise NotImplementedError

    def epoch_order(self, epoch_seed: int) -> np.ndarray:
        return np.random.RandomState(epoch_seed).permutation(len(self.train_x))

    def device_arrays(self, device: torch.device) -> dict[str, torch.Tensor]:
        """The splits on ``device`` (uploaded once, then cached)."""
        key = str(device)
        if key not in self._device_arrays:
            self._device_arrays[key] = {
                name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for name, a in (
                    ("train_x", self.train_x), ("train_y", self.train_y),
                    ("test_x", self.test_x), ("test_y", self.test_y),
                )
            }
        return self._device_arrays[key]

    def device_train_batches(self, epoch_seed: int, device: torch.device):
        """One epoch of shuffled ``(images, labels)`` batches sliced on the
        device (the JAX package's order): one host-to-device copy of the
        epoch's order, none per batch."""
        arrs = self.device_arrays(device)
        order = torch.from_numpy(self.epoch_order(epoch_seed)).to(device)
        bs = self.batch_size
        for i in range(0, len(order) - bs + 1, bs):
            idx = order[i : i + bs]
            yield arrs["train_x"][idx], arrs["train_y"][idx]

    def device_val_batches(self, device: torch.device):
        arrs = self.device_arrays(device)
        bs = self.val_batch_size
        for i in range(0, len(self.test_x) - bs + 1, bs):
            yield arrs["test_x"][i : i + bs], arrs["test_y"][i : i + bs]

    @property
    def steps_per_epoch(self) -> int:
        return len(self.train_x) // self.batch_size

    @property
    def val_steps_per_epoch(self) -> int:
        return len(self.test_x) // self.val_batch_size


class CIFAR10Data(CIFARData):
    num_classes = 10

    def _load(self, root):
        return _load_cifar10(root)


class CIFAR100Data(CIFARData):
    num_classes = 100

    def _load(self, root):
        return _load_cifar100(root)
