"""``--compute_dtype bfloat16``: the port against the JAX package with
``dtype=jnp.bfloat16``, on the same numpy inputs and flax parameters.

- Each encoder's plain version on a bfloat16 tensor against the JAX
  encoder (its jnp path) on the same bfloat16 tensor: bitwise for FP8,
  FP16 (and FP8 under ``--precision 16``), BF16, FP32 and SmaQ in
  truncation (z-score and range std), sizes equal; S2FP8 by the JAX
  package's rule (tests/test_encoders.py:126-133), sizes equal.
- The tiny ResNet (stage sizes (1, 1), batch 4, 8x8, training mode) and the
  tiny BERT (eval mode, padding in the second row) without taps: bfloat16
  rounds at other places in the two frameworks (one rounding for GELU and
  a biased Dense in PyTorch, one a primitive in XLA), so the logits are
  held to a bfloat16-level tolerance: no farther from flax's bfloat16
  logits than twice the distance of the port's own float32 logits from
  them, and nearer to them than to the float32 logits (the model really
  computes in bfloat16).
- One full-coverage SmaQ 6/8 step in truncation (taps on every site,
  gradients, weights and momentum compressed; SGD on the tiny CNN (the
  ResNet family's tiny model: convs, a tapped BatchNorm, the pool and the
  fc), AdamW without dropout on one layer of the tiny BERT, marked slow)
  against JAX's
  ``value_and_grad`` + ``compressed_optimizer_step``.  Truncation is
  discontinuous: a last-ulp difference moves a tapped element across a
  grid boundary and the backward taps carry the flip on, so the float32
  step already disagrees with JAX's by up to 0.45 of a leaf's update
  (the tiny ResNet's conv1, measured at float32).  Held: the loss to
  1e-2 relative; every tag's original size exactly; every tag's new size
  to 1e-3 relative (a flip moves an element between buckets: a few bits
  of a million); the update of all parameters together within 0.5 of
  JAX's in L2; each element within twice its leaf's largest update plus
  one grid step of the leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.inject.tap import TapConfig as JaxTapConfig
from smart_quantization_tpu.models import bert as jbert
from smart_quantization_tpu.models.resnet import BasicBlock as JaxBasicBlock
from smart_quantization_tpu.models.resnet import ResNet as JaxResNet
from smart_quantization_tpu.models.tiny import TinyCNN as JaxTinyCNN
from smart_quantization_tpu.optim import compressed as jopt
from smart_quantization_tpu.train.metrics import fold_sown_stats
from smart_quantization_tpu.train.task import SequenceClassificationTask as JaxSeqTask
from smart_quantization_tpu.train.task import cross_entropy as jax_cross_entropy
from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.convert import params_from_jax, tree_from_jax
from smart_quantization_tpu_torch.inject.tap import TapConfig
from smart_quantization_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
from smart_quantization_tpu_torch.models.resnet import BasicBlock, ResNet
from smart_quantization_tpu_torch.models.tiny import TinyCNN
from smart_quantization_tpu_torch.optim.compressed import OptimizerCompression, build_optimizer
from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer
from smart_quantization_tpu_torch.train.task import SequenceClassificationTask

TAGS = ("forward_autograd", "backward_autograd", "optimizer_grad",
        "optimizer_weight", "optimizer_momentum")
BERT_CFG = dataclasses.replace(BertConfig.tiny(), dropout_rate=0.0)
JAX_BERT_CFG = dataclasses.replace(jbert.BertConfig.tiny(), dropout_rate=0.0)
# the step's BERT: the tiny config's first layer and a 2048-word vocabulary
# (JAX's CPU compile and run of the compressed step grow with both)
STEP_CFG = dataclasses.replace(BERT_CFG, num_layers=1, vocab_size=2048)
JAX_STEP_CFG = dataclasses.replace(JAX_BERT_CFG, num_layers=1, vocab_size=2048)


def bf16_pair(x: np.ndarray):
    """``x`` rounded to bfloat16 by JAX, as a JAX and a torch tensor."""
    jx = jnp.asarray(x, jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)


def to_f32(y) -> np.ndarray:
    return y.float().numpy() if isinstance(y, torch.Tensor) else np.asarray(y.astype(jnp.float32))


r = np.random.RandomState(0)
ENCODER_X = (r.randn(33, 77) * 2.5 + 0.7).astype(np.float32)
ENCODERS = [
    ("fp8", {"stochastic": False}),
    ("fp8", {"stochastic": False, "precision": 16}),
    ("fp16", {"stochastic": False}),
    ("bf16", {"stochastic": False}),
    ("fp32", {}),
    ("smart", {"stochastic_rounding": False}),
    ("smart", {"stochastic_rounding": False, "use_range_std_dev": True}),
    ("s2fp8", {"stochastic": False}),
]


@pytest.mark.parametrize("name,kw", ENCODERS, ids=[f"{n}-{'-'.join(k)}" for n, k in ENCODERS])
def test_encoder_plain_version_on_bf16_matches_jax(name, kw):
    jx, tx = bf16_pair(ENCODER_X)
    y_ref, s_ref = jax_build_compressor(name, **kw)(jx, None)
    y, s = build_compressor(name, **kw)(tx, None)
    assert y.dtype == torch.bfloat16 and y_ref.dtype == jnp.bfloat16
    a, b = to_f32(y), to_f32(y_ref)
    if name == "s2fp8":
        rel = np.abs(a - b) / (np.abs(b) + 1e-30)
        assert (rel < 1e-3).mean() >= 0.98 and np.all(rel < 0.4)
    else:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert float(s.orig_bits) == float(s_ref.orig_bits) == ENCODER_X.size * 32
    assert float(s.new_bits) == float(s_ref.new_bits)


def resnet_input():
    return np.random.RandomState(1).randn(4, 8, 8, 3).astype(np.float32)


def bert_inputs():
    r = np.random.RandomState(0)
    ids = r.randint(1000, STEP_CFG.vocab_size, size=(2, 16)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    ids[1, 11:] = 0
    types = np.zeros((2, 16), np.int32)
    types[:, 8:] = 1
    return ids, mask, types


def assert_bf16_level(port_bf16, port_f32, ref_bf16):
    """The port's bfloat16 logits against flax's (see the module note)."""
    d_bf16 = np.abs(port_bf16 - ref_bf16).max()
    d_f32 = np.abs(port_f32 - ref_bf16).max()
    assert d_bf16 <= 2 * d_f32, (d_bf16, d_f32)
    assert d_bf16 < np.abs(port_bf16 - port_f32).max()


def test_resnet_forward_in_bf16_matches_flax():
    x = resnet_input()
    jmodel = JaxResNet(stage_sizes=(1, 1), block_cls=JaxBasicBlock, num_classes=10,
                       dtype=jnp.bfloat16)
    variables = jax.jit(lambda k: jmodel.init({"params": k}, jnp.asarray(x), train=True))(
        jax.random.key(0))
    ref, _ = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), train=True,
                                            mutable=["batch_stats"]))(variables)
    state = params_from_jax(jax.tree.map(np.asarray, variables["params"]),
                            jax.tree.map(np.asarray, variables["batch_stats"]))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = ResNet((1, 1), BasicBlock, num_classes=10, dtype=dtype)
        model.load_state_dict(state)
        logits = model(xt)
        assert logits.dtype == torch.float32
        out[dtype] = logits.detach().numpy()
    assert np.asarray(ref).dtype == np.float32
    assert_bf16_level(out[torch.bfloat16], out[torch.float32], np.asarray(ref))


def test_bert_forward_in_bf16_matches_flax():
    args = bert_inputs()
    jmodel = jbert.BertForSequenceClassification(JAX_BERT_CFG, 2, dtype=jnp.bfloat16)
    jargs = tuple(jnp.asarray(a) for a in args)
    params = jax.jit(lambda k: jmodel.init({"params": k, "dropout": k}, *jargs, train=False))(
        jax.random.key(0))["params"]
    ref = np.asarray(jax.jit(lambda p: jmodel.apply({"params": p}, *jargs, train=False))(params))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = BertForSequenceClassification(BERT_CFG, 2, dtype=dtype)
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
        model.eval()
        logits = model(*(torch.from_numpy(a) for a in args))
        assert logits.dtype == torch.float32
        out[dtype] = logits.detach().numpy()
    assert_bf16_level(out[torch.bfloat16], out[torch.float32], ref)


def jax_step(model, variables, spec, comp, model_args, loss_fn, rngs):
    """JAX's full-coverage step: ``value_and_grad`` (the backward sizes as
    the telemetry's cotangent) and ``compressed_optimizer_step``."""
    def step(params, tel):
        def loss_of(p, t):
            v = {"params": p, "telemetry": t}
            if "batch_stats" in variables:
                v["batch_stats"] = variables["batch_stats"]
            logits, mut = model.apply(v, *model_args, train=True, rngs=rngs,
                                      mutable=["batch_stats", "compression_stats"])
            return loss_fn(logits), mut

        (loss, mut), (grads, tel_g) = jax.value_and_grad(
            loss_of, argnums=(0, 1), has_aux=True)(params, tel)
        new_p, _, opt_sizes = jopt.compressed_optimizer_step(
            spec, params, grads, spec.tx.init(params), jax.random.key(2),
            jopt.OptimizerCompression(compressor=comp),
            weight_exempt=jopt.norm_param_mask(params))
        sizes = dict(fold_sown_stats(mut.get("compression_stats", {})), **opt_sizes)
        sizes["backward_autograd"] = sum(jax.tree.leaves(tel_g))
        return loss, new_p, sizes

    return jax.jit(step)(variables["params"], variables["telemetry"])


def assert_step_matches(metrics, model, params0, loss_ref, p_ref, sizes_ref):
    """The step's tolerances of the module note."""
    assert abs(float(metrics["train_loss"]) - float(loss_ref)) <= 1e-2 * abs(float(loss_ref))
    for tag in TAGS:
        got, want = metrics[f"_ratio/{tag}"].numpy(), np.asarray(sizes_ref[tag])
        assert got[0] == want[0], tag
        assert abs(float(got[1]) - float(want[1])) <= 1e-3 * float(want[1]), tag
    refs = tree_from_jax(jax.tree.map(np.asarray, p_ref))
    starts = tree_from_jax(jax.tree.map(np.asarray, params0))
    diff_sq = update_sq = 0.0
    for name, p in model.named_parameters():
        a = p.detach().numpy().astype(np.float64)
        b, b0 = refs[name].numpy().astype(np.float64), starts[name].numpy()
        assert np.isfinite(a).all(), name
        grid = np.std(b) / 15  # SmaQ 6/8's main-bucket quantum of the leaf
        assert np.abs(a - b).max() <= 2 * np.abs(b - b0).max() + grid + 1e-7, name
        diff_sq += float(((a - b) ** 2).sum())
        update_sq += float(((b - b0) ** 2).sum())
    assert diff_sq <= 0.25 * update_sq, (diff_sq, update_sq)


def test_cnn_full_coverage_step_in_bf16_matches_jax():
    x, labels = resnet_input(), np.array([1, 4, 7, 9], np.int32)
    jcomp = jax_build_compressor("smart", stochastic_rounding=False)
    jmodel = JaxTinyCNN(num_classes=10, tap=JaxTapConfig(compressor=jcomp), dtype=jnp.bfloat16)
    variables = jax.jit(lambda k: jmodel.init({"params": k, "compress": k}, jnp.asarray(x),
                                              train=True))(jax.random.key(0))
    spec = jopt.build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=5e-4)
    loss_ref, p_ref, sizes_ref = jax_step(
        jmodel, variables, spec, jcomp, (jnp.asarray(x),),
        lambda logits: jax_cross_entropy(logits, jnp.asarray(labels)),
        {"compress": jax.random.key(1)})

    comp = build_compressor("smart", stochastic_rounding=False)
    model = TinyCNN(num_classes=10, tap=TapConfig(compressor=comp), dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables["params"]),
                                          jax.tree.map(np.asarray, variables["batch_stats"])))
    trainer = Trainer(model, None, build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=5e-4),
                      optim_comp=OptimizerCompression(compressor=comp),
                      config=TrainConfig(measure_compression_ratio=True), device="cpu")
    metrics = trainer.train_step(trainer.init_state(),
                                 torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                 torch.from_numpy(labels))
    assert_step_matches(metrics, model, variables["params"], loss_ref, p_ref, sizes_ref)


@pytest.mark.slow  # about 11 s, JAX's CPU compile of the tapped, compressed step
def test_bert_full_coverage_step_in_bf16_matches_jax():
    args, labels = bert_inputs(), np.array([1.5, 3.25], np.float32)
    jargs = tuple(jnp.asarray(a) for a in args)
    jcomp = jax_build_compressor("smart", stochastic_rounding=False)
    jmodel = jbert.BertForSequenceClassification(
        JAX_STEP_CFG, 1, tap=JaxTapConfig(compressor=jcomp), dtype=jnp.bfloat16)
    variables = jax.jit(lambda k: jmodel.init({"params": k, "compress": k, "dropout": k},
                                              *jargs, train=False))(jax.random.key(0))
    spec = jopt.build_optimizer("adamw", 2e-5, weight_decay=0.01)
    jtask = JaxSeqTask(task_name="stsb", is_regression=True)
    loss_ref, p_ref, sizes_ref = jax_step(
        jmodel, variables, spec, jcomp, jargs,
        lambda logits: jtask.loss(logits, jnp.asarray(labels)),
        {"compress": jax.random.key(1), "dropout": jax.random.key(1)})

    comp = build_compressor("smart", stochastic_rounding=False)
    model = BertForSequenceClassification(STEP_CFG, 1, tap=TapConfig(compressor=comp),
                                          dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    trainer = Trainer(model, None, build_optimizer("adamw", 2e-5, weight_decay=0.01),
                      optim_comp=OptimizerCompression(compressor=comp),
                      task=SequenceClassificationTask("stsb", True),
                      config=TrainConfig(measure_compression_ratio=True), device="cpu")
    inputs = dict(zip(("input_ids", "attention_mask", "token_type_ids"),
                      (torch.from_numpy(a) for a in args)))
    metrics = trainer.train_step(trainer.init_state(), inputs, torch.from_numpy(labels))
    assert_step_matches(metrics, model, variables["params"], loss_ref, p_ref, sizes_ref)
