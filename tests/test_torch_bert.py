"""The port's BERT against the JAX package's flax BERT at the tiny config
(2 layers, hidden 64, 2 heads, FFN 128, the full 30522-word vocabulary),
batch 2 x 16 tokens with padding in the second row, the flax parameters
carried over with ``convert.params_from_jax``.

Tolerances:
- taps off, eval mode: logits to 1e-5 absolute (float32 CPU matmuls and
  LayerNorms sum in different orders);
- SmaQ taps in truncation mode: a last-ulp difference can move an element
  across a bucket or grid boundary and the flip travels on, so the logits
  are held to 1e-2 of their largest magnitude and the new sizes to 1 %, the
  original sizes exactly (the flip rule of tests/test_torch_resnet.py);
- one AdamW step (lr 2e-5, weight decay 0.01, compression off, dropout
  rate 0) against JAX's ``value_and_grad`` + ``compressed_optimizer_step``:
  the loss to 1e-5 relative, every parameter to 1e-5 absolute, Adam's mu to
  1e-5 and nu to 1e-4 of its leaf's largest magnitude, but of no less than
  1e-3 of the largest over all leaves (the key biases' gradients are float
  noise: the softmax ignores them), for the STSB regression head, a
  two-label cross-entropy head, and ``freeze_encoder`` (the encoder leaves
  step with zero gradients: decay alone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.compress.encoders import FP32 as JaxFP32
from smart_quantization_tpu.inject.policy import TapPolicy as JaxTapPolicy
from smart_quantization_tpu.inject.tap import TapConfig as JaxTapConfig
from smart_quantization_tpu.models import bert as jbert
from smart_quantization_tpu.optim import compressed as jopt
from smart_quantization_tpu.train.metrics import fold_sown_stats
from smart_quantization_tpu.train.task import SequenceClassificationTask as JaxSeqTask
from smart_quantization_tpu_torch.compress import SizeTotals, build_compressor
from smart_quantization_tpu_torch.convert import bert_state_dict_from_hf, params_from_jax, tree_from_jax
from smart_quantization_tpu_torch.inject.policy import LayerKind, TapPolicy
from smart_quantization_tpu_torch.inject.tap import TapConfig, TapContext
from smart_quantization_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
from smart_quantization_tpu_torch.optim.compressed import build_optimizer, norm_param_mask
from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer
from smart_quantization_tpu_torch.train.task import SequenceClassificationTask

CFG = BertConfig.tiny()
JCFG = jbert.BertConfig.tiny()


def inputs_np():
    r = np.random.RandomState(0)
    ids = r.randint(1000, CFG.vocab_size, size=(2, 16)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    ids[1, 11:] = 0
    types = np.zeros((2, 16), np.int32)
    types[:, 8:] = 1
    return ids, mask, types


def jax_init(model, args):
    return jax.jit(lambda k: model.init(
        {"params": k, "compress": k, "dropout": k}, *args, train=False))(jax.random.key(0))


@pytest.fixture(scope="module")
def setup():
    args = tuple(jnp.asarray(a) for a in inputs_np())
    params = jax.tree.map(np.asarray, jax_init(jbert.BertForSequenceClassification(JCFG, 2), args)["params"])
    r = np.random.RandomState(1)
    # non-trivial LayerNorm affine parameters and biases
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * r.randn(*v.shape).astype(np.float32)
        if getattr(p[-1], "key", "") in ("scale", "bias") else v,
        params,
    )
    return args, params


def torch_model(params, num_labels=2, tap=None, cfg=CFG, **kw):
    model = BertForSequenceClassification(cfg, num_labels, tap=tap, **kw)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def torch_args():
    return tuple(torch.from_numpy(a) for a in inputs_np())


def test_conversion_is_total_and_one_to_one(setup):
    _, params = setup
    leaves = jax.tree_util.tree_leaves(params)
    converted = params_from_jax(params)
    assert len(converted) == len(leaves) == 5 + 16 * CFG.num_layers + 4
    model = BertForSequenceClassification(CFG, 2)
    assert {k: tuple(v.shape) for k, v in converted.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    # the Dense kernels transpose, the embeddings and LayerNorm leaves do not
    np.testing.assert_array_equal(converted["layer_0.attention.query.weight"].numpy(),
                                  params["layer_0"]["attention"]["query"]["dense"]["kernel"].T)
    np.testing.assert_array_equal(converted["word_embeddings.weight"].numpy(),
                                  params["word_embeddings"]["embedding"])
    np.testing.assert_array_equal(converted["layer_1.ffn_norm.weight"].numpy(),
                                  params["layer_1"]["ffn_norm"]["norm"]["scale"])


def test_init_draws_from_its_generator():
    """N(0, 0.02) weights from the seed's generator, zero biases, unit
    LayerNorm scales; the global RNG is not drawn from."""
    state = torch.random.get_rng_state()
    a = BertForSequenceClassification(CFG, 2, seed=3).state_dict()
    assert torch.equal(state, torch.random.get_rng_state())
    b = BertForSequenceClassification(CFG, 2, seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["word_embeddings.weight"]
    assert abs(float(w.std()) - 0.02) < 1e-3
    assert float(a["layer_0.intermediate.bias"].abs().max()) == 0.0
    assert float((a["layer_0.ffn_norm.weight"] - 1).abs().max()) == 0.0


@pytest.mark.parametrize("num_labels", [1, 2])
def test_logits_match_without_taps(setup, num_labels):
    args, params = setup
    if num_labels == 1:
        params = dict(params, classifier={"kernel": params["classifier"]["kernel"][:, :1],
                                          "bias": params["classifier"]["bias"][:1]})
    jmodel = jbert.BertForSequenceClassification(JCFG, num_labels)
    ref = jax.jit(lambda p: jmodel.apply({"params": p}, *args, train=False))(params)
    model = torch_model(params, num_labels).eval()
    with torch.no_grad():
        logits = model(*torch_args())
    assert logits.dtype == torch.float32 and logits.shape == (2, num_labels)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_tapped_forward_matches_in_truncation_mode(setup):
    args, params = setup
    jcfg = JaxTapConfig(compressor=jax_build_compressor("smart", stochastic_rounding=False))
    jmodel = jbert.BertForSequenceClassification(JCFG, 2, tap=jcfg)
    logits_ref, mut = jax.jit(lambda p: jmodel.apply(
        {"params": p}, *args, train=False, rngs={"compress": jax.random.key(2)},
        mutable=["compression_stats"]))(params)
    sizes_ref = {k: np.asarray(v) for k, v in fold_sown_stats(mut["compression_stats"]).items()}

    cfg = TapConfig(compressor=build_compressor("smart", stochastic_rounding=False))
    model = torch_model(params, tap=cfg).eval()
    ctx = TapContext(torch.Generator().manual_seed(0), SizeTotals())
    with torch.no_grad():
        logits = model(*torch_args(), ctx)
    scale = float(np.abs(logits_ref).max())
    assert float((logits - torch.from_numpy(np.array(logits_ref))).abs().max()) <= 1e-2 * scale
    assert set(ctx.sizes.totals) == set(sizes_ref) == {"forward_autograd"}
    got, ref = ctx.sizes.totals["forward_autograd"].numpy(), sizes_ref["forward_autograd"]
    assert got[0] == ref[0]
    assert abs(got[1] - ref[1]) <= 0.01 * ref[1]


class CountingTotals(SizeTotals):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def add(self, tag, stats):
        self.calls += tag == "forward_autograd"
        super().add(tag, stats)


@pytest.mark.parametrize("kinds", [
    None,  # the default policy: LINEAR, NORM and ACTIVATION sites of BERT
    (LayerKind.LINEAR,), (LayerKind.NORM,), (LayerKind.ACTIVATION,),
    (LayerKind.EMBED,), (LayerKind.ATTENTION,),
])
def test_tap_sites_match_jax(setup, kinds):
    """The number of tap sites of each kind equals JAX's: 8 per layer, the
    embeddings' norm, the pooler's tanh and the classifier by default
    (EMBED and ATTENTION sites exist but only a policy that names them
    taps them)."""
    args, params = setup
    names = None if kinds is None else [k.value for k in kinds]
    jpolicy = JaxTapPolicy() if kinds is None else JaxTapPolicy.of(*names)
    policy = TapPolicy() if kinds is None else TapPolicy.of(*names)
    calls = []

    class Counting(JaxFP32):
        def __call__(self, x, key, **kw):
            calls.append(x.shape)
            return super().__call__(x, key, **kw)

    jmodel = jbert.BertForSequenceClassification(
        JCFG, 2, tap=JaxTapConfig(compressor=Counting(), policy=jpolicy))
    jmodel.apply({"params": params}, *args, train=False, rngs={"compress": jax.random.key(0)},
                 mutable=["compression_stats"])
    want = len(calls)
    model = torch_model(params, tap=TapConfig(compressor=build_compressor("fp32"),
                                              policy=policy)).eval()
    ctx = TapContext(torch.Generator(), CountingTotals())
    with torch.no_grad():
        model(*torch_args(), ctx)
    assert ctx.sizes.calls == want
    expected = {None: 8 * CFG.num_layers + 3, (LayerKind.LINEAR,): 6 * CFG.num_layers + 1,
                (LayerKind.NORM,): 2 * CFG.num_layers + 1, (LayerKind.ACTIVATION,): 1,
                (LayerKind.EMBED,): 1, (LayerKind.ATTENTION,): CFG.num_layers}[kinds]
    assert want == expected


def test_weight_exemption_mask_matches_jax(setup):
    """JAX exempts leaves with "bn" in a path key; BERT has none, so every
    leaf (LayerNorm included) is weight-compressed, leaf by leaf the same."""
    _, params = setup
    ref = {k: bool(v) for k, v in tree_from_jax(jopt.norm_param_mask(params)).items()}
    model = BertForSequenceClassification(CFG, 2)
    got = norm_param_mask(n for n, _ in model.named_parameters())
    assert got == ref
    assert not any(got.values())


def _adam_state(opt_state):
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu")):
        if hasattr(s, "mu"):
            return s
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("case", ["stsb", "sst2", "stsb frozen"])
def test_adamw_step_matches_jax(setup, case):
    _, params = setup
    task_name, frozen = case.split()[0], case.endswith("frozen")
    regression = task_name == "stsb"
    num_labels = 1 if regression else 2
    if regression:
        params = dict(params, classifier={"kernel": params["classifier"]["kernel"][:, :1],
                                          "bias": params["classifier"]["bias"][:1]})
    ids, mask, types = inputs_np()
    labels = np.array([1.5, 3.25], np.float32) if regression else np.array([1, 0], np.int32)
    lr, wd = 2e-5, 0.01

    jcfg = dataclasses.replace(JCFG, dropout_rate=0.0)
    jmodel = jbert.BertForSequenceClassification(jcfg, num_labels, freeze_encoder=frozen)
    jtask = JaxSeqTask(task_name=task_name, is_regression=regression)
    spec_j = jopt.build_optimizer("adamw", lr, weight_decay=wd)

    def jax_step(p):
        def loss_fn(p):
            logits = jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                                  jnp.asarray(types), train=True,
                                  rngs={"dropout": jax.random.key(1)})
            return jtask.loss(logits, jnp.asarray(labels))

        loss, grads = jax.value_and_grad(loss_fn)(p)
        new_p, opt, _ = jopt.compressed_optimizer_step(
            spec_j, p, grads, spec_j.tx.init(p), jax.random.key(2),
            jopt.OptimizerCompression(), weight_exempt=jopt.norm_param_mask(p))
        adam = _adam_state(opt)
        return loss, new_p, adam.mu, adam.nu

    loss_ref, p_ref, mu_ref, nu_ref = jax.jit(jax_step)(params)

    model = torch_model(params, num_labels, cfg=dataclasses.replace(CFG, dropout_rate=0.0),
                        freeze_encoder=frozen)
    trainer = Trainer(model, None, build_optimizer("adamw", lr, weight_decay=wd),
                      task=SequenceClassificationTask(task_name, regression),
                      config=TrainConfig(), device="cpu")
    state = trainer.init_state()
    inputs = dict(zip(("input_ids", "attention_mask", "token_type_ids"),
                      (torch.from_numpy(a) for a in (ids, mask, types))))
    metrics = trainer.train_step(state, inputs, torch.from_numpy(labels))

    assert abs(float(metrics["train_loss"]) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    got = {n: p.detach() for n, p in model.named_parameters()}
    for name, ref in tree_from_jax(jax.tree.map(np.asarray, p_ref)).items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    for buf, ref_tree, rel in (("mu", mu_ref, 1e-5), ("nu", nu_ref, 1e-4)):
        refs = tree_from_jax(jax.tree.map(np.asarray, ref_tree))
        top = max(float(r.abs().max()) for r in refs.values())
        for name, ref in refs.items():
            a, b = state.opt_state[buf][name].numpy(), ref.numpy()
            scale = max(float(np.abs(b).max()), 1e-3 * top)
            np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=f"{buf} {name}")
    if frozen:
        # the encoder stepped by the decoupled decay alone
        w0 = params["layer_0"]["intermediate"]["dense"]["kernel"].T
        np.testing.assert_allclose(got["layer_0.intermediate.weight"].numpy(),
                                   w0 - lr * wd * w0, rtol=0, atol=1e-7)


def test_hf_state_dict_map_matches_jax(monkeypatch):
    """A tiny random HF ``BertModel`` through both converters: the port's
    logits equal JAX's to 1e-5 (the map's keys and layouts are the JAX
    package's)."""
    monkeypatch.setenv("USE_TF", "0")  # transformers need not import TensorFlow
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12,
    )
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jcfg = jbert.BertConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                            intermediate_size=64, max_position_embeddings=64, dropout_rate=0.0)
    cfg = BertConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                     intermediate_size=64, max_position_embeddings=64, dropout_rate=0.0)
    jparams = jbert.convert_torch_state_dict(sd, jcfg, num_labels=1)
    # a nonzero classifier, the same on both sides, so the logits see the pooler
    w = np.random.RandomState(2).randn(32, 1).astype(np.float32)
    jparams["classifier"]["kernel"] = jnp.asarray(w)
    state = bert_state_dict_from_hf(hf.state_dict(), cfg.num_layers, 1)
    state["classifier.weight"] = torch.from_numpy(w.T.copy())
    ids = np.array([[101, 17, 33, 5, 9, 64, 3, 102], [101, 7, 8, 102, 0, 0, 0, 0]], np.int32)
    mask = (ids != 0).astype(np.int32)
    jmodel = jbert.BertForSequenceClassification(jcfg, 1)
    ref = jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                                         train=False))(jparams)
    model = BertForSequenceClassification(cfg, 1).eval()
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        logits = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_load_pretrained_without_a_cache(tmp_path, monkeypatch, capsys):
    from smart_quantization_tpu_torch.convert import load_pretrained

    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    assert load_pretrained("bert-base-uncased", 12, 1) is None
    assert "using fresh init" in capsys.readouterr().out
