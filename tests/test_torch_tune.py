"""``train/tune.py``: the learning-rate range test and the batch-size scaler,
against the JAX package's ``train/tune.py`` where the two compute the same
thing, and on a tiny trainer on the CPU.

- ``suggest_from_losses`` is a numpy copy: bitwise JAX's suggestion on the
  same curves, NaN and too-short curves included;
- ``lr_range_schedule`` is JAX's schedule in float64 (JAX's is float32):
  the endpoints exactly, every step to float32's 1e-6;
- ``auto_scale_batch_size`` doubles until ``torch.cuda.OutOfMemoryError``
  and propagates any other error, as JAX's stops at RESOURCE_EXHAUSTED;
- ``auto_lr_find`` and ``scale_batch_size`` on a TinyCNN trainer (at K=1
  and K=2) put back the parameters, buffers, augmentation generator,
  optimizer spec and cached step graphs; the probe's optimizer keeps only
  the kind (JAX ``tune.py:67``), and ``tune_from_args`` trains at the
  constant rate found, without the schedule (JAX ``train.py:124-131``).
"""

import argparse

import numpy as np
import pytest
import torch

from smart_quantization_tpu.train import tune as jtune
from smart_quantization_tpu_torch.models.tiny import TinyCNN
from smart_quantization_tpu_torch.optim.compressed import build_optimizer
from smart_quantization_tpu_torch.train import tune
from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer

r = np.random.RandomState(0)
STEPS = np.arange(50)
CURVES = {
    "descent": 2.5 - np.tanh((STEPS - 25) / 6.0) + 0.05 * r.randn(50),
    "diverging tail": np.concatenate(
        [np.linspace(2.3, 1.2, 35), [3.0, 9.0, np.inf] + [np.nan] * 12]),
    "nan inside": np.where(STEPS % 7 == 3, np.nan, 2.0 - 0.02 * STEPS),
    "too short": np.array([np.nan] * 46 + [1.0, 0.9, 0.8, 0.7]),
    "flat": np.full(50, 1.5),
}


@pytest.mark.parametrize("name", sorted(CURVES))
def test_suggest_from_losses_is_jax_bitwise(name):
    lrs = np.geomspace(1e-6, 1.0, 50)
    got = tune.suggest_from_losses(lrs, CURVES[name])
    want = jtune.suggest_from_losses(lrs, CURVES[name])
    assert np.float64(got).view(np.int64) == np.float64(want).view(np.int64)


def test_lr_range_schedule_matches_jax():
    ours, theirs = tune.lr_range_schedule(1e-6, 1.0, 50), jtune.lr_range_schedule(1e-6, 1.0, 50)
    assert ours(0) == 1e-6 and ours(49) == 1.0 and ours(60) == 1.0
    np.testing.assert_allclose([ours(s) for s in range(50)],
                               [float(theirs(s)) for s in range(50)], rtol=1e-6)


def test_auto_scale_batch_size_doubles_until_out_of_memory():
    tried = []

    def try_batch(size):
        tried.append(size)
        if size >= 64:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate ...")

    assert tune.auto_scale_batch_size(try_batch, init_size=8) == 32
    assert tried == [8, 16, 32, 64]
    assert tune.auto_scale_batch_size(lambda s: None, init_size=8, max_trials=3) == 32


def test_auto_scale_batch_size_propagates_other_errors():
    def broken(size):
        raise ValueError("not a memory error")

    with pytest.raises(ValueError, match="not a memory error"):
        tune.auto_scale_batch_size(broken)

    def oom(size):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    with pytest.raises(RuntimeError, match="even batch size 8 does not fit"):
        tune.auto_scale_batch_size(oom)


class Batches:
    """Four uint8 CIFAR-shaped batches of 4, every epoch."""

    steps_per_epoch = 4

    def __init__(self):
        r = np.random.RandomState(2)
        self.batch_size = 4
        self.batches = [(torch.from_numpy(r.randint(0, 256, (4, 32, 32, 3)).astype(np.uint8)),
                         torch.from_numpy(r.randint(0, 10, 4).astype(np.int64)))
                        for _ in range(4)]

    def device_train_batches(self, epoch_seed, device):
        yield from self.batches


def tiny_trainer(k):
    torch.manual_seed(0)
    spec = build_optimizer("sgd", lambda count: 0.1 * 0.5 ** (count // 3), momentum=0.5,
                           weight_decay=1e-3)
    return Trainer(TinyCNN(num_classes=10), Batches(), spec,
                   config=TrainConfig(steps_per_call=k), device="cpu")


def snapshot(trainer):
    return ([p.detach().clone() for p in trainer.model.parameters()],
            [b.clone() for b in trainer.model.buffers()], trainer.data_gen.get_state())


def assert_put_back(trainer, before, spec, graphs):
    params, buffers, gen_state = before
    assert all(torch.equal(a, b) for a, b in zip(trainer.model.parameters(), params))
    assert all(torch.equal(a, b) for a, b in zip(trainer.model.buffers(), buffers))
    assert torch.equal(trainer.data_gen.get_state(), gen_state)
    assert trainer.spec is spec
    assert (trainer._train_graph, trainer._eval_graph) == graphs


@pytest.mark.parametrize("k", [1, 2])
def test_auto_lr_find_puts_the_trainer_back(k, monkeypatch):
    trainer = tiny_trainer(k)
    spec, before = trainer.spec, snapshot(trainer)
    # stand-ins for the cached K-step and eval graphs the card would hold
    graphs = (object(), object())
    trainer._train_graph, trainer._eval_graph = graphs
    seen = []
    real_step = Trainer.train_step

    def recording_step(self, state, x, y):
        seen.append((self.spec, self._train_graph))
        return real_step(self, state, x, y)

    monkeypatch.setattr(Trainer, "train_step", recording_step)
    lr = tune.auto_lr_find(trainer, num_steps=6)
    assert 1e-6 <= lr <= 1.0
    # K=2 runs its groups through train_steps (eager here): 6 steps, 0 single
    assert len(seen) == 6
    probe, graph = seen[0]
    # JAX's probe keeps only the optimizer's kind
    assert (probe.kind, probe.momentum, probe.weight_decay) == ("sgd", 0.9, 0.0)
    assert [probe.lr(c) for c in (0, 5)] == [1e-6, 1.0]
    assert graph is None
    assert_put_back(trainer, before, spec, graphs)


def test_scale_batch_size_and_tune_from_args_on_a_tiny_trainer(monkeypatch):
    trainer = tiny_trainer(1)
    spec, before = trainer.spec, snapshot(trainer)
    assert tune.scale_batch_size(trainer, 4, max_trials=2) == 8
    assert_put_back(trainer, before, spec, (None, None))
    args = argparse.Namespace(
        auto_scale_batch_size=True, auto_lr_find=True, batch_size=4, optimizer_type="sgd",
        momentum=0.5, weight_decay=1e-3, beta1=None, beta2=None, epsilon=None)
    scale, find = tune.scale_batch_size, tune.auto_lr_find
    monkeypatch.setattr(tune, "scale_batch_size", lambda t, size: scale(t, size, max_trials=2))
    monkeypatch.setattr(tune, "auto_lr_find", lambda t: find(t, num_steps=5))
    tune.tune_from_args(trainer, args)
    assert trainer.data.batch_size == 8
    # a constant rate: the schedule is gone, the other settings are the run's
    s = trainer.spec
    assert s.lr(0) == s.lr(100) and (s.momentum, s.weight_decay) == (0.5, 1e-3)
    assert trainer._train_graph is None
