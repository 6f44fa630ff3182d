"""``--steps_per_call`` in the port, on the CPU, with TinyCNN.

The port's counterparts of tests/test_multi_step.py: K steps grouped into
one dispatch (on the card one CUDA graph; on the CPU the same grouping,
eager) take the steps K single dispatches take.  Every step's randomness
derives from (seed, step), never from the grouping, so here the grouped
run equals the single one bit for bit:

- K=2 over 5 batches (two groups and a leftover single) against K=1:
  parameters, BatchNorm statistics and optimizer state, step counts, the
  compression sizes and the logged step indices;
- grouped evaluation (K=3 over 7 batches: two groups and a leftover)
  against single evaluation on the same state;
- a NaN inside a group stops training at the drain after the group, with
  the rest of the group run (the JAX package's documented tradeoff);
- K=2 with packed weights and packed momentum, checkpointed after a group
  and a leftover step, then resumed: the resumed group ends where the
  straight one does;
- a ``--profile_dir`` run writes a trace that names the five regions.
"""

import glob
import json

import numpy as np
import torch

from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.data.cifar import CIFAR10Data
from smart_quantization_tpu_torch.inject.tap import TapConfig
from smart_quantization_tpu_torch.models.tiny import TinyCNN
from smart_quantization_tpu_torch.optim.compressed import OptimizerCompression, build_optimizer
from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer
from smart_quantization_tpu_torch.train.state import to_saved
from smart_quantization_tpu_torch.train.task import ImageClassificationTask
from smart_quantization_tpu_torch.utils.profiling import REGIONS


class RecordingLogger:
    """Keeps every logged (step, scalars)."""

    def __init__(self):
        self.records = []

    def log(self, step, scalars, echo=True):
        self.records.append((int(step), dict(scalars)))

    def close(self):
        pass


class NaNAtBatch(ImageClassificationTask):
    """Training batch ``at`` (counted from 0) comes out of the preparation
    as NaN."""

    def __init__(self, at: int):
        object.__setattr__(self, "at", at)
        object.__setattr__(self, "seen", [0])

    def prepare_train(self, images_u8, gen):
        x = super().prepare_train(images_u8, gen)
        self.seen[0] += 1
        return x * float("nan") if self.seen[0] - 1 == self.at else x


_DATA = []


def data() -> CIFAR10Data:
    """One synthetic CIFAR-10 for every test (batches of 8, eval of 2)."""
    if not _DATA:
        _DATA.append(CIFAR10Data(batch_size=8))
    return _DATA[0]


def make_trainer(steps_per_call, n_batches=5, *, packed=False, task=None, **cfg):
    comp = build_compressor("smart")
    torch.manual_seed(0)
    model = TinyCNN(num_classes=10, tap=TapConfig(compressor=comp))
    cfg = {"log_every": 2, **cfg}
    config = TrainConfig(epochs=1, limit_train_batches=n_batches, limit_val_batches=1,
                         steps_per_call=steps_per_call, measure_compression_ratio=True,
                         seed=3, **cfg)
    return Trainer(model, data(), build_optimizer("sgd", 0.05, momentum=0.9),
                   optim_comp=OptimizerCompression(compressor=comp, packed_momentum=packed,
                                                   packed_weights=packed),
                   config=config, logger=RecordingLogger(), device="cpu", task=task)


def snapshot(trainer, state) -> dict:
    """Every tensor a run keeps: parameters (packed ones as their codes),
    buffers and the optimizer state."""
    flat = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}", v)
        else:
            flat[prefix] = tree if isinstance(tree, torch.Tensor) else torch.tensor(tree)

    params = state.packed_params
    if params is None:
        params = {n: p.detach() for n, p in trainer.model.named_parameters()}
    walk("params", to_saved(params))
    walk("buffers", dict(trainer.model.named_buffers()))
    walk("opt", to_saved(state.opt_state))
    return flat


def assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


def test_grouped_steps_equal_single_steps():
    t1, t2 = make_trainer(1), make_trainer(2)  # K=2: two groups + a leftover single
    s1, s2 = t1.fit(), t2.fit()
    assert s1.step == s2.step == 5
    assert_same(snapshot(t1, s1), snapshot(t2, s2))
    assert t1.ratio_acc.summary() == t2.ratio_acc.summary()
    steps = [[s for s, r in t.logger.records if "train_loss" in r] for t in (t1, t2)]
    assert steps[0] == steps[1] == [1, 2, 3, 4, 5]
    losses = [[r["train_loss"] for _, r in t.logger.records if "train_loss" in r]
              for t in (t1, t2)]
    assert losses[0] == losses[1]


def test_grouped_eval_matches_single_eval():
    trainer = make_trainer(1, n_batches=2)
    state = trainer.fit()
    trainer.cfg.limit_val_batches = 7
    single = trainer.evaluate(state)
    trainer.cfg.steps_per_call = 3  # two groups of 3 and a leftover single
    assert trainer.evaluate(state) == single


def test_nan_stops_at_the_drain_after_its_group():
    # batch 2 (step 3) is NaN; K=2 groups steps 3 and 4, drained together
    single = make_trainer(1, task=NaNAtBatch(2), log_every=1)
    grouped = make_trainer(2, task=NaNAtBatch(2), log_every=2)
    s1, s2 = single.fit(), grouped.fit()
    assert single.nan_terminated and grouped.nan_terminated
    assert s1.step == 3 and s2.step == 4  # the rest of the group ran
    for t in (single, grouped):
        logged = [s for s, r in t.logger.records if "train_loss" in r]
        assert logged == [1, 2, 3]
        assert not np.isfinite(t.logger.records[-1][1]["train_loss"])


def test_grouped_packed_state_resumes(tmp_path):
    straight = make_trainer(2, packed=True)
    state = straight.init_state()
    batches = []
    for inputs, labels in straight.data.device_train_batches(0, straight.device):
        batches.append((straight.task.prepare_train(inputs, straight.data_gen), labels))
        if len(batches) == 5:
            break
    straight.train_steps(state, batches[0:2])
    straight.train_step(state, *batches[2])  # a leftover single
    path = str(tmp_path / "epoch_0000.pt")
    straight.save_checkpoint(path, state)
    losses = straight.train_steps(state, batches[3:5])["train_loss"]

    resumed = make_trainer(2, packed=True)
    s2 = resumed.load_checkpoint(path)
    assert s2.step == 3
    assert torch.equal(resumed.train_steps(s2, batches[3:5])["train_loss"], losses)
    assert s2.step == state.step == 5
    want, got = snapshot(straight, state), snapshot(resumed, s2)
    assert_same(want, got)
    assert any(v.dtype == torch.uint8 for v in got.values())


def test_profile_dir_names_the_regions(tmp_path):
    trainer = make_trainer(2, n_batches=2, profile_dir=str(tmp_path), profile_steps=2)
    trainer.fit()
    traces = glob.glob(str(tmp_path / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(REGIONS) <= names
