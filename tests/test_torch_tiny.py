"""The port's TinyCNN against the JAX package's, and a grouped fit of it
against the JAX ``Trainer`` at ``steps_per_call=2``.

The flax variables are made with numpy (the layout of ``TinyCNN.init``,
checked by ``jax.eval_shape``) and carried over with
``convert.params_from_jax``.  The forward pass without taps is one jitted
JAX call (a jit compiles it in half the time eager dispatch takes); with
SmaQ 6/8 truncation taps it is the first step of the fit.  Both trainers
take the same three unaugmented batches, SmaQ on every structure, SGD; the
JAX trainer compiles its K-step scan and the single step of the leftover
batch.

Tolerances, as ``tests/test_torch_resnet.py`` and
``tests/test_torch_train.py::test_trainer_step_matches_jax`` hold them:
without taps the logits agree to 1e-4 (float32 CPU convolutions sum in
other orders); with the truncation taps a last-ulp difference can move an
element across a grid boundary and the flip travels on, so each step's
loss (the first is the tapped forward at the carried-over weights) is held
to 1e-2 relative, every tag's original size exactly and its new size to
1 %, and the trained parameters only to be finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.inject.tap import TapConfig as JaxTapConfig
from smart_quantization_tpu.models.tiny import TinyCNN as JaxTinyCNN
from smart_quantization_tpu.optim import compressed as jopt
from smart_quantization_tpu.train import loop as jloop
from smart_quantization_tpu.train import task as jtask
from smart_quantization_tpu.train.state import TrainState as JaxTrainState
from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.convert import params_from_jax
from smart_quantization_tpu_torch.inject.tap import TapConfig
from smart_quantization_tpu_torch.models.tiny import TinyCNN
from smart_quantization_tpu_torch.optim.compressed import OptimizerCompression, build_optimizer
from smart_quantization_tpu_torch.train import task as ttask
from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer

TAGS = ("forward_autograd", "backward_autograd", "optimizer_grad",
        "optimizer_weight", "optimizer_momentum")


def flax_variables(seed=0):
    r = np.random.RandomState(seed)
    f = np.float32
    params = {
        "conv1": {"kernel": (r.randn(3, 3, 3, 16) * np.sqrt(2 / 144)).astype(f)},
        "bn1": {"bn": {"scale": (1 + 0.1 * r.randn(16)).astype(f),
                       "bias": (0.1 * r.randn(16)).astype(f)}},
        "conv2": {"kernel": (r.randn(3, 3, 16, 32) * np.sqrt(2 / 288)).astype(f)},
        "fc": {"kernel": (r.randn(32, 10) / np.sqrt(32)).astype(f),
               "bias": (0.1 * r.randn(10)).astype(f)},
    }
    stats = {"bn1": {"bn": {"mean": np.zeros(16, f), "var": np.ones(16, f)}}}
    return params, stats


def test_flax_layout_is_tinycnn_init():
    params, stats = flax_variables()
    shapes = jax.eval_shape(
        lambda: JaxTinyCNN(num_classes=10).init(
            jax.random.key(0), jnp.zeros((2, 32, 32, 3)), train=True))
    want = jax.tree.map(lambda a: a.shape, {"params": params, "batch_stats": stats})
    assert jax.tree.map(lambda a: a.shape, shapes) == want


def port_model(tap=None):
    model = TinyCNN(num_classes=10, tap=tap)
    model.load_state_dict(params_from_jax(*flax_variables()), strict=True)
    return model


def test_forward_matches_jax():
    x = np.random.RandomState(1).randn(8, 32, 32, 3).astype(np.float32)
    variables = dict(zip(("params", "batch_stats"), flax_variables()))
    ref = jax.jit(lambda v, x: JaxTinyCNN(num_classes=10).apply(
        v, x, train=True, mutable=["batch_stats"])[0])(variables, x)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = port_model()(xt).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


class Batches:
    """The same three uint8 batches for both trainers, no eval split."""

    def __init__(self):
        r = np.random.RandomState(2)
        self.batches = [(r.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8),
                         r.randint(0, 10, 8).astype(np.int32)) for _ in range(3)]
        self.steps_per_epoch = self.val_steps_per_epoch = 3

    def train_batches(self, epoch_seed):
        yield from self.batches

    def device_train_batches(self, epoch_seed, device):
        for x, y in self.batches:
            yield torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    def val_batches(self):
        return iter(())

    def device_val_batches(self, device):
        return iter(())


class JaxNoAug(jtask.ImageClassificationTask):
    def prepare_train(self, inputs, key):
        return self.prepare_eval(inputs)


class PortNoAug(ttask.ImageClassificationTask):
    def prepare_train(self, images_u8, gen):
        return self.prepare_eval(images_u8)


class RecordingLogger:
    def __init__(self):
        self.losses = {}

    def log(self, step, scalars, echo=True):
        if "train_loss" in scalars:
            self.losses[int(step)] = float(scalars["train_loss"])

    def close(self):
        pass


def test_grouped_fit_matches_jax():
    # three batches at K=2: one group and a leftover single on both sides
    cfg = dict(epochs=1, log_every=1, limit_train_batches=3, limit_val_batches=0,
               steps_per_call=2, measure_compression_ratio=True)
    jcomp = jax_build_compressor("smart", use_pallas=False, stochastic_rounding=False)
    jtap = JaxTapConfig(compressor=jcomp)
    jspec = jopt.build_optimizer("sgd", 0.05, momentum=0.9)
    jlog = RecordingLogger()
    jt = jloop.Trainer(JaxTinyCNN(num_classes=10, tap=jtap), Batches(), jspec, task=JaxNoAug(),
                       tap_cfg=jtap, optim_comp=jopt.OptimizerCompression(compressor=jcomp),
                       config=jloop.TrainConfig(**cfg), logger=jlog)
    params, stats = flax_variables()
    jstate = jt.fit(JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats=stats, opt_state=jspec.tx.init(params)))

    comp = build_compressor("smart", stochastic_rounding=False)
    log = RecordingLogger()
    trainer = Trainer(port_model(TapConfig(compressor=comp)), Batches(),
                      build_optimizer("sgd", 0.05, momentum=0.9), task=PortNoAug(),
                      optim_comp=OptimizerCompression(compressor=comp),
                      config=TrainConfig(**cfg), logger=log, device="cpu")
    state = trainer.fit()

    assert state.step == int(jstate.step) == 3
    assert sorted(log.losses) == sorted(jlog.losses) == [1, 2, 3]
    for s, ref in jlog.losses.items():
        assert abs(log.losses[s] - ref) <= 1e-2 * abs(ref), s
    got, want = trainer.ratio_acc.summary(), jt.ratio_acc.summary()
    for tag in TAGS:
        assert got[f"orig_size_{tag}"] == want[f"orig_size_{tag}"], tag
        assert abs(got[f"new_size_{tag}"] - want[f"new_size_{tag}"]) <= (
            0.01 * want[f"new_size_{tag}"]), tag
    ref_shapes = {k: v.shape for k, v in params_from_jax(
        jax.tree.map(np.asarray, jstate.params)).items()}
    for n, p in trainer.model.named_parameters():
        assert p.shape == ref_shapes[n] and torch.isfinite(p).all(), n
