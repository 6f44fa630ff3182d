"""The port's CIFAR data against the JAX package's: the synthetic stand-in
byte for byte, ``normalize`` to 1e-6, and ``augment``'s shape, dtype and
crop range (its random draws differ by design: torch.Generator vs JAX key).
"""

import jax.numpy as jnp
import numpy as np
import torch

from smart_quantization_tpu.data import cifar as jcifar
from smart_quantization_tpu_torch.data import cifar


def test_synthetic_is_byte_identical():
    for classes in (10, 100):
        ours, ref = cifar._synthetic(classes, 64, 16), jcifar._synthetic(classes, 64, 16)
        for (x, y), (xr, yr) in zip(ours, ref):
            assert x.dtype == xr.dtype == np.uint8 and y.dtype == yr.dtype == np.int32
            np.testing.assert_array_equal(x, xr)
            np.testing.assert_array_equal(y, yr)


def test_normalize_matches():
    x = np.random.RandomState(0).randint(0, 256, size=(4, 32, 32, 3)).astype(np.uint8)
    got = cifar.normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcifar.normalize(jnp.asarray(x))), atol=1e-6)


def test_augment_is_a_padded_crop_with_flip():
    x = np.random.RandomState(1).randint(1, 256, size=(16, 32, 32, 3)).astype(np.uint8)
    out = cifar.augment(torch.from_numpy(x), torch.Generator().manual_seed(0)).numpy()
    assert out.shape == x.shape and out.dtype == np.uint8
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)))
    flipped = 0
    for i in range(len(x)):
        crops = [
            (flip, padded[i, r:r + 32, c:c + 32][:, ::-1] if flip else padded[i, r:r + 32, c:c + 32])
            for r in range(9) for c in range(9) for flip in (False, True)
        ]
        match = [flip for flip, crop in crops if np.array_equal(crop, out[i])]
        assert match, f"image {i} is no pad-4 crop of its input"
        flipped += match[0]
    assert 0 < flipped < len(x)  # both directions occur


def test_batches_and_val_batch_size():
    data = cifar.CIFAR10Data(batch_size=8)
    assert data.val_batch_size == 2  # batch_size // 4
    ref = jcifar.CIFAR10Data(batch_size=8)
    batches = list(data.device_train_batches(3, torch.device("cpu")))
    refs = list(ref.train_batches(3))
    assert len(batches) == len(refs) == data.steps_per_epoch
    for (x, y), (xr, yr) in zip(batches[:3], refs[:3]):
        np.testing.assert_array_equal(x.numpy(), xr)
        np.testing.assert_array_equal(y.numpy(), yr)
    (xv, yv), (xvr, yvr) = next(data.device_val_batches(torch.device("cpu"))), next(ref.val_batches())
    np.testing.assert_array_equal(xv.numpy(), xvr)
    np.testing.assert_array_equal(yv.numpy(), yvr)
