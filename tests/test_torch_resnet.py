"""The port's ResNet against the JAX package's flax ResNet at a tiny size:
``ResNet(stage_sizes=(1, 1), block_cls=BasicBlock)`` (full channel widths
64/128), batch 2, 8x8 input, the flax parameters carried over with
``convert.params_from_jax``.

Tolerances: with taps off, logits, BatchNorm statistics and gradients agree
to atol = rtol = 1e-4 (float32 CPU convolutions sum in different orders).
With SmaQ taps on in truncation mode, a last-ulp difference can move an
element across a bucket or grid boundary and the flip then travels through
the later layers, so the logits are held to 1e-2 of their largest magnitude
and the new sizes to 1 %; the original sizes are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.inject.tap import TapConfig as JaxTapConfig
from smart_quantization_tpu.models.resnet import BasicBlock as JaxBasicBlock
from smart_quantization_tpu.models.resnet import ResNet as JaxResNet
from smart_quantization_tpu.train.metrics import fold_sown_stats
from smart_quantization_tpu.train.task import cross_entropy as jax_cross_entropy
from smart_quantization_tpu_torch.compress import SizeTotals, build_compressor
from smart_quantization_tpu_torch.convert import params_from_jax, tree_from_jax
from smart_quantization_tpu_torch.inject.tap import TapConfig, TapContext
from smart_quantization_tpu_torch.models.resnet import BasicBlock, ResNet

STAGES = (1, 1)


@pytest.fixture(scope="module")
def setup():
    r = np.random.RandomState(0)
    x = r.randn(2, 8, 8, 3).astype(np.float32)
    labels = np.array([3, 7], np.int32)
    jmodel = JaxResNet(stage_sizes=STAGES, block_cls=JaxBasicBlock, num_classes=10)
    # jit at this size compiles in about a second; eager dispatch is slower
    variables = jax.jit(
        lambda k: jmodel.init({"params": k, "compress": k}, jnp.asarray(x), train=True)
    )(jax.random.key(0))
    params = jax.tree.map(np.asarray, variables["params"])
    # non-trivial BN affine parameters, so the comparison exercises them
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * r.randn(*v.shape).astype(np.float32)
        if any(getattr(k, "key", "") in ("scale", "bias") for k in p) else v,
        params,
    )
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    return x, labels, params, stats


def torch_model(params, stats, tap=None):
    model = ResNet(STAGES, BasicBlock, num_classes=10, tap=tap)
    model.load_state_dict(params_from_jax(params, stats), strict=True)
    return model


def nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def test_logits_bn_stats_and_eval_match_with_taps_off(setup):
    x, _, params, stats = setup
    jmodel = JaxResNet(stage_sizes=STAGES, block_cls=JaxBasicBlock, num_classes=10)
    logits_ref, mut = jax.jit(
        lambda p, s: jmodel.apply(
            {"params": p, "batch_stats": s}, jnp.asarray(x), train=True,
            mutable=["batch_stats"],
        )
    )(params, stats)
    model = torch_model(params, stats).train()
    logits = model(nchw(x))
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref, atol=1e-4, rtol=1e-4)
    new_stats = tree_from_jax(jax.tree.map(np.asarray, mut["batch_stats"]))
    sd = model.state_dict()
    for name, ref in new_stats.items():
        np.testing.assert_allclose(sd[name].numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)

    eval_ref = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), train=False))(
        mut | {"params": params}
    )
    with torch.no_grad():
        eval_logits = model.eval()(nchw(x))
    np.testing.assert_allclose(eval_logits.numpy(), eval_ref, atol=1e-4, rtol=1e-4)


def test_running_variance_is_the_biased_batch_variance(setup):
    """flax updates the running variance with the biased batch variance
    (torch's BatchNorm2d would use the unbiased one)."""
    x, _, params, stats = setup
    model = torch_model(params, stats).train()
    with torch.no_grad():
        h = model.conv1(nchw(x))
        model(nchw(x))
    biased = h.var(dim=(0, 2, 3), correction=0)
    expected = 0.9 * torch.ones_like(biased) + 0.1 * biased
    torch.testing.assert_close(model.bn1.running_var, expected, atol=1e-6, rtol=1e-5)
    unbiased = 0.9 + 0.1 * h.var(dim=(0, 2, 3), correction=1)
    assert not torch.allclose(model.bn1.running_var, unbiased, atol=1e-6, rtol=1e-5)


def test_gradients_match_with_taps_off(setup):
    x, labels, params, stats = setup
    jmodel = JaxResNet(stage_sizes=STAGES, block_cls=JaxBasicBlock, num_classes=10)

    def loss_fn(p):
        logits, _ = jmodel.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
            mutable=["batch_stats"],
        )
        return jax_cross_entropy(logits, jnp.asarray(labels))

    grads_ref = tree_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params)))
    model = torch_model(params, stats).train()
    loss = torch.nn.functional.cross_entropy(model(nchw(x)), torch.from_numpy(labels).long())
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(grads_ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads_ref[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_tapped_forward_matches_in_truncation_mode(setup):
    x, _, params, stats = setup
    jcfg = JaxTapConfig(compressor=jax_build_compressor("smart", stochastic_rounding=False))
    jmodel = JaxResNet(stage_sizes=STAGES, block_cls=JaxBasicBlock, num_classes=10, tap=jcfg)
    logits_ref, mut = jax.jit(
        lambda p, s: jmodel.apply(
            {"params": p, "batch_stats": s}, jnp.asarray(x), train=True,
            rngs={"compress": jax.random.key(2)},
            mutable=["batch_stats", "compression_stats"],
        )
    )(params, stats)
    sizes_ref = {k: np.asarray(v) for k, v in fold_sown_stats(mut["compression_stats"]).items()}

    cfg = TapConfig(compressor=build_compressor("smart", stochastic_rounding=False))
    model = torch_model(params, stats, tap=cfg).train()
    ctx = TapContext(torch.Generator().manual_seed(0), SizeTotals())
    with torch.no_grad():
        logits = model(nchw(x), ctx)
    scale = float(np.abs(logits_ref).max())
    assert float((logits - torch.from_numpy(np.array(logits_ref))).abs().max()) <= 1e-2 * scale
    assert set(ctx.sizes.totals) == set(sizes_ref) == {"forward_autograd"}
    got = ctx.sizes.totals["forward_autograd"].numpy()
    ref = sizes_ref["forward_autograd"]
    assert got[0] == ref[0]
    assert abs(got[1] - ref[1]) <= 0.01 * ref[1]


@pytest.mark.parametrize("train", [False, True])
def test_bn_folded_forward_matches_jax(setup, train):
    """``use_batch_norm``: every BatchNorm tap folds the layer's (nonzero,
    see ``setup``) gamma and beta into SmaQ, in truncation mode.  JAX runs
    this forward pass (its training step cannot, ROADMAP Queue 3); held as
    the tapped forward above: logits to 1e-2 of their scale, the original
    sizes exactly and the new ones to 1 %."""
    x, _, params, stats = setup
    jcomp = jax_build_compressor("smart", stochastic_rounding=False, use_batch_norm=True)
    jmodel = JaxResNet(stage_sizes=STAGES, block_cls=JaxBasicBlock, num_classes=10,
                       tap=JaxTapConfig(compressor=jcomp, use_batch_norm=True))
    mutable = ["batch_stats", "compression_stats"] if train else ["compression_stats"]
    logits_ref, mut = jax.jit(
        lambda p, s: jmodel.apply(
            {"params": p, "batch_stats": s}, jnp.asarray(x), train=train,
            rngs={"compress": jax.random.key(2)}, mutable=mutable,
        )
    )(params, stats)
    ref = np.asarray(fold_sown_stats(mut["compression_stats"])["forward_autograd"])

    comp = build_compressor("smart", stochastic_rounding=False, use_batch_norm=True)
    model = torch_model(params, stats, tap=TapConfig(compressor=comp, use_batch_norm=True))
    ctx = TapContext(torch.Generator().manual_seed(0), SizeTotals())
    with torch.no_grad():
        logits = model.train(train)(nchw(x), ctx)
    scale = float(np.abs(logits_ref).max())
    assert float((logits - torch.from_numpy(np.array(logits_ref))).abs().max()) <= 1e-2 * scale
    got = ctx.sizes.totals["forward_autograd"].numpy()
    assert got[0] == ref[0]
    assert abs(got[1] - ref[1]) <= 0.01 * ref[1]
    # the fold changes the result: the same model without it differs
    plain = torch_model(params, stats, tap=TapConfig(compressor=comp))
    with torch.no_grad():
        unfolded = plain.train(train)(nchw(x), TapContext(torch.Generator().manual_seed(0)))
    assert not torch.equal(unfolded, logits)
