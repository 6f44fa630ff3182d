"""Checkpoints and the dense bit packer of the port.

- ``pack_bits``/``unpack_bits`` give JAX's 32-bit words bitwise at every
  width of JAX's tests (tests/test_pack.py:20-89) and round-trip exactly;
  ``smaq_pack`` gives JAX's words in truncation mode and ``smaq_unpack``
  its values to float32 tolerance (the stats are summed in another
  order); the packed codec's error, footprint and outlier overflow behave
  as JAX's tests ask;
- ``pack_tree``/``save_compressed``/``restore_compressed`` round-trip a
  state at under 45 % of its bytes;
- the trainer's own checkpoint: a tiny ResNet (SGD) and the tiny BERT
  (AdamW, with the master weights) with packed momentum and packed
  weights, stochastic SmaQ on every structure, checkpointed after step 2:
  a fresh trainer resumed from it ends step 3 bitwise where the straight
  run ends it (loss, packed codes and stats, master weights, BatchNorm
  statistics).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.ops import pack as jpack
from smart_quantization_tpu.ops.smaq import SmaQParams as JaxSmaQParams
from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.inject.tap import TapConfig
from smart_quantization_tpu_torch.ops.pack import (
    PackSpec,
    pack_bits,
    smaq_pack,
    smaq_unpack,
    unpack_bits,
)
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, smaq_quantize_dequantize
from smart_quantization_tpu_torch.optim.compressed import OptimizerCompression, build_optimizer
from smart_quantization_tpu_torch.train.checkpoint import (
    pack_tree,
    restore_compressed,
    save_compressed,
    tree_nbytes,
    unpack_tree,
)
from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer
from smart_quantization_tpu_torch.train.state import to_saved

WIDTHS = [1, 3, 6, 8, 13, 16, 32]


def values(bits, n=1000):
    rng = np.random.RandomState(bits)
    return rng.randint(0, 2**bits, size=n, dtype=np.uint64)


def x_pack():
    return (np.random.RandomState(0).randn(8192) * 2.0 + 0.5).astype(np.float32)


@functools.cache
def jax_packed():
    """JAX's words at each width, and its truncation-mode ``smaq_pack`` of
    ``x_pack()`` with the unpacked values (one jit)."""
    spec = jpack.PackSpec(params=JaxSmaQParams(stochastic_rounding=False))

    def run(vals, x):
        words = {b: jpack.pack_bits(v, b) for b, v in vals.items()}
        p = jpack.smaq_pack(x, None, spec)
        return words, (p.main, p.flags, p.outliers, p.mean, p.std), jpack.smaq_unpack(
            p, x.size, spec)

    vals = {b: jnp.asarray(values(b).astype(np.uint32)) for b in WIDTHS}
    words, packed, y = jax.jit(run)(vals, jnp.asarray(x_pack()))
    return ({b: np.asarray(w) for b, w in words.items()},
            tuple(np.asarray(v) for v in packed), np.asarray(y))


@pytest.mark.parametrize("bits", WIDTHS)
def test_pack_bits_matches_jax(bits):
    vals = values(bits)
    words = pack_bits(torch.from_numpy(vals.astype(np.int64)), bits)
    assert words.numel() == -(-vals.size * bits // 32)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jax_packed()[0][bits])
    np.testing.assert_array_equal(unpack_bits(words, bits, vals.size).numpy(), vals)


def test_smaq_pack_matches_jax():
    spec = PackSpec(params=SmaQParams(stochastic_rounding=False))
    x = torch.from_numpy(x_pack())
    p = smaq_pack(x, None, spec)
    (main, flags, outliers, mean, std), want = jax_packed()[1:]
    for got, ref in ((p.main, main), (p.flags, flags), (p.outliers, outliers)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    np.testing.assert_allclose([float(p.mean), float(p.std)], [mean, std], rtol=1e-6)
    y = smaq_unpack(p, x.numel(), spec).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # the packed codec's error is on the fake path's scale (it clamps at 2.5 sigma)
    y_fake, _ = smaq_quantize_dequantize(x, None, spec.params)
    err, err_fake = float(((torch.from_numpy(y) - x) ** 2).mean()), float(((y_fake - x) ** 2).mean())
    assert err < err_fake * 3 + 1e-4


def test_smaq_pack_footprint_and_overflow():
    spec = PackSpec()
    n = 65536
    p = smaq_pack(torch.randn(n, generator=torch.Generator().manual_seed(1)),
                  torch.Generator().manual_seed(2), spec)
    bits = (p.main.numel() + p.flags.numel() + p.outliers.numel()) * 32 + 64
    assert bits <= spec.packed_bits(n) + 96 and n * 32 / bits > 3.0
    assert 0 < float(p.n_outliers) < n
    # heavy tails: far more outliers than a 1 % capacity holds
    tight = PackSpec(params=SmaQParams(stochastic_rounding=False), outlier_capacity_frac=0.01)
    x = torch.from_numpy(np.random.RandomState(3).standard_t(2.0, 4096).astype(np.float32))
    y = smaq_unpack(smaq_pack(x, None, tight), x.numel(), tight)
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_compressed_checkpoint_round_trip(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(64, 128, generator=g), "mu": torch.randn(64, 128, generator=g) * 0.01,
             "small": torch.ones(3), "step": torch.tensor(7, dtype=torch.int32)}
    spec = PackSpec(params=SmaQParams(stochastic_rounding=False))
    packed = pack_tree(state, torch.Generator().manual_seed(2), spec)
    assert tree_nbytes(packed) < tree_nbytes(state) * 0.45
    back = unpack_tree(packed, spec)
    assert int(back["step"]) == 7 and torch.equal(back["small"], state["small"])
    assert float((back["w"] - state["w"]).abs().mean()) < 0.05
    path = str(tmp_path / "ckpt.pt")
    save_compressed(path, state, torch.Generator().manual_seed(3), spec)
    restored = restore_compressed(path, spec)
    assert int(restored["step"]) == 7 and restored["w"].shape == (64, 128)


# ---------------------------------------------------------------- resume
def resnet_trainer():
    from smart_quantization_tpu_torch.models.resnet import BasicBlock, ResNet

    comp = build_compressor("smart")
    torch.manual_seed(0)
    model = ResNet((1, 1), BasicBlock, num_classes=10, tap=TapConfig(compressor=comp))
    return Trainer(model, None, build_optimizer("sgd", 0.1, momentum=0.9),
                   optim_comp=OptimizerCompression(compressor=comp, packed_momentum=True,
                                                   packed_weights=True),
                   config=TrainConfig(seed=3), device="cpu")


def resnet_batch(i):
    r = np.random.RandomState(10 + i)
    images = torch.from_numpy(r.randint(0, 256, (4, 8, 8, 3), dtype=np.uint8))
    return images, torch.from_numpy(r.randint(0, 10, 4).astype(np.int64))


def bert_trainer():
    from smart_quantization_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
    from smart_quantization_tpu_torch.train.bert_loop import BertTrainer

    comp = build_compressor("smart")
    model = BertForSequenceClassification(BertConfig.tiny(), num_labels=1,
                                          tap=TapConfig(compressor=comp), seed=0)
    return BertTrainer(model, None, build_optimizer("adamw", 2e-5, weight_decay=0.01),
                       task="stsb", config=TrainConfig(seed=3), device="cpu",
                       optim_comp=OptimizerCompression(
                           compressor=comp, packed_momentum=True, packed_weights=True,
                           use_weight_accumulator=True))


def bert_batch(i):
    r = np.random.RandomState(20 + i)
    inputs = {"input_ids": torch.from_numpy(r.randint(0, 30522, (4, 16)).astype(np.int64)),
              "attention_mask": torch.ones(4, 16, dtype=torch.int64),
              "token_type_ids": torch.zeros(4, 16, dtype=torch.int64)}
    return inputs, torch.from_numpy(r.rand(4).astype(np.float32) * 5)


def step(trainer, state, batch):
    inputs, labels = batch
    return float(trainer.train_step(state, trainer.task.prepare_train(inputs, trainer.data_gen),
                                    labels)["train_loss"])


def snapshot(trainer, state) -> dict:
    """Every tensor of the run: packed parameters (codes and stats),
    optimizer state, buffers."""
    flat = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(tree, torch.Tensor):
            flat[prefix] = tree
        else:
            flat[prefix] = torch.tensor(tree)

    walk("params", to_saved(state.packed_params))
    walk("opt", to_saved(state.opt_state))
    walk("buffers", dict(trainer.model.named_buffers()))
    return flat


@pytest.mark.parametrize("model", ["resnet", "bert"])
def test_resume_equals_straight_run(model, tmp_path):
    make, batch = {"resnet": (resnet_trainer, resnet_batch), "bert": (bert_trainer, bert_batch)}[model]
    straight = make()
    state = straight.init_state()
    for i in range(2):
        step(straight, state, batch(i))
    path = str(tmp_path / "epoch_0000.pt")
    straight.save_checkpoint(path, state)
    loss = step(straight, state, batch(2))

    resumed = make()
    s2 = resumed.load_checkpoint(path)
    assert s2.step == 2
    assert step(resumed, s2, batch(2)) == loss
    want, got = snapshot(straight, state), snapshot(resumed, s2)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    codes = [v for k, v in got.items() if k.endswith("smaq_codes")]
    assert codes and all(c.dtype == torch.uint8 for c in codes)
