"""The port's Inception-v3 against the JAX package's flax Inception-v3.

Each block type (A-E, at their real widths) at batch 2 and spatial 8 (A,
B, D) or 5 (C, E); the same numpy inputs and weights on both sides, the
weights made from a numpy seed in the flax tree's shapes (``jax.eval_shape``,
no init compile) and carried over with ``convert.params_from_jax``; JAX's
jnp SmaQ path (``use_pallas=False``).

Tolerances: with taps off, outputs (train and eval) and the BatchNorms'
updated statistics to 1e-5 of their largest magnitude, gradients to 1e-4
(float32 CPU convolutions sum in different orders).  With SmaQ taps on in
truncation mode the per-tag original sizes are exactly equal and the new
ones within 1e-4; the output of blocks A and D to 1e-5 of its scale, that
of B, C and E by the flip rule of ``flips_held``: a tap's mean sums NCHW in
another order than JAX's NHWC, so it can be an ulp apart and move an
element across a grid boundary (a flip of one quantum), which the next
conv spreads and the next BatchNorm's batch statistics and the block tap's
own statistics carry to other elements (at these seeds, 1 element of C's
output beyond 1e-5 of its scale, 13 of E's, 11 293 of B's).

Each block's JAX side is one jit compile of a few seconds, so block A runs
in tier-1 and B-E are ``slow``.

The whole ``Inception3`` (batch 2, 16x16: 16 -> 7 -> 3 through B and D, in
eval mode, taps off and in truncation) compiles for about 30 s in JAX on
the CPU, so it is ``slow``; its dropout is held against flax's statistically, and
the conversion of all 272 parameter and 180 statistics leaves runs on the
flax tree's shapes alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.inject.tap import TapConfig as JaxTapConfig
from smart_quantization_tpu.models import inception as J
from smart_quantization_tpu.train.metrics import fold_sown_stats
from smart_quantization_tpu_torch.compress import SizeTotals, build_compressor
from smart_quantization_tpu_torch.convert import params_from_jax, tree_from_jax
from smart_quantization_tpu_torch.inject.tap import TapConfig, TapContext
from smart_quantization_tpu_torch.models import inception as T

# block: (JAX class and its arguments, the port's class and its arguments,
# input channels, spatial size)
BLOCKS = {
    "A": (J.InceptionA, (32,), T.InceptionA, (192, 32), 192, 8),
    "B": (J.InceptionB, (), T.InceptionB, (288,), 288, 8),
    "C": (J.InceptionC, (128,), T.InceptionC, (768, 128), 768, 5),
    "D": (J.InceptionD, (), T.InceptionD, (768,), 768, 8),
    "E": (J.InceptionE, (), T.InceptionE, (1280,), 1280, 5),
}
# blocks whose tapped output stays within 1e-5 of JAX's (no flip)
NO_FLIP = {"A", "D"}


def jax_tap():
    return JaxTapConfig(compressor=jax_build_compressor(
        "smart", use_pallas=False, stochastic_rounding=False))


def torch_tap():
    return TapConfig(compressor=build_compressor("smart", stochastic_rounding=False))


def random_variables(shapes, r):
    """numpy values in a flax tree's shapes: conv kernels kaiming fan-out
    normal, Dense kernels lecun normal, BatchNorm scales about 1, biases and
    running means about 0, running variances about 1."""

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan = np.prod(s.shape[:-2]) * s.shape[-1] if len(s.shape) == 4 else s.shape[0]
            gain = 2.0 if len(s.shape) == 4 else 1.0
            return (r.randn(*s.shape) * np.sqrt(gain / fan)).astype(np.float32)
        if leaf in ("scale", "var"):
            return (1.0 + 0.1 * np.abs(r.randn(*s.shape))).astype(np.float32)
        return (0.1 * r.randn(*s.shape)).astype(np.float32)

    return {k: jax.tree_util.tree_map_with_path(fill, v) for k, v in shapes.items()}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def assert_close(got, want, rtol):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rtol * scale, f"max |d| {err:.3e} > {rtol} x {scale:.3e}"


@pytest.fixture(scope="module", params=[
    name if name == "A" else pytest.param(name, marks=pytest.mark.slow) for name in sorted(BLOCKS)])
def block(request):
    """One block's inputs, weights and every JAX result: the taps-off
    forward in train mode with its updated statistics and in eval mode, the
    parameter gradients of a fixed projection of the train output, and the
    tapped train forward with its sizes by tag."""
    jcls, jargs, tcls, targs, cin, size = BLOCKS[request.param]
    r = np.random.RandomState(ord(request.param))
    x = r.randn(2, size, size, cin).astype(np.float32)
    xj = jnp.asarray(x)
    train, evalm = jcls(*jargs, tap=None, train=True), jcls(*jargs, tap=None, train=False)
    shapes = jax.eval_shape(lambda: train.init({"params": jax.random.key(0)}, xj))
    variables = random_variables(shapes, r)
    params, stats = variables["params"], variables["batch_stats"]
    out_shape = jax.eval_shape(lambda: train.apply(variables, xj, mutable=["batch_stats"]))[0]
    w = r.randn(*out_shape.shape).astype(np.float32)

    def plain(p):
        def loss(p):
            y, mut = train.apply({"params": p, "batch_stats": stats}, xj, mutable=["batch_stats"])
            return jnp.sum(y * w), (y, mut["batch_stats"])

        (_, (y, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return y, new_stats, grads, evalm.apply({"params": p, "batch_stats": stats}, xj)

    tapped = jcls(*jargs, tap=jax_tap(), train=True)

    def both(p):  # one compile for the plain and the tapped passes
        return plain(p), tapped.apply(
            {"params": p, "batch_stats": stats}, xj, rngs={"compress": jax.random.key(2)},
            mutable=["batch_stats", "compression_stats"])

    (y, new_stats, grads, y_eval), (y_tap, mut) = jax.jit(both)(params)
    ref = {
        "y": np.asarray(y), "stats": tree_from_jax(jax.tree.map(np.asarray, new_stats)),
        "grads": tree_from_jax(jax.tree.map(np.asarray, grads)), "y_eval": np.asarray(y_eval),
        "y_tap": np.asarray(y_tap),
        "sizes": {k: np.asarray(v) for k, v in fold_sown_stats(mut["compression_stats"]).items()},
    }
    return {"name": request.param, "x": x, "w": w, "tcls": tcls, "targs": targs,
            "params": params, "stats": stats, "ref": ref}


def torch_block(b, tap=None):
    model = b["tcls"](*b["targs"], tap=tap)
    model.load_state_dict(params_from_jax(b["params"], b["stats"]), strict=True)
    return model


def test_block_forward_and_bn_stats_match_with_taps_off(block):
    model = torch_block(block).train()
    y = model(nchw(block["x"]))
    assert_close(nhwc(y), block["ref"]["y"], 1e-5)
    sd = model.state_dict()
    for name, want in block["ref"]["stats"].items():
        assert_close(sd[name].numpy(), want.numpy(), 1e-5)


def test_block_eval_forward_matches_with_taps_off(block):
    model = torch_block(block).eval()
    with torch.no_grad():
        y = model(nchw(block["x"]))
    assert_close(nhwc(y), block["ref"]["y_eval"], 1e-5)


def test_block_gradients_match_with_taps_off(block):
    model = torch_block(block).train()
    y = model(nchw(block["x"]))
    (y * nchw(block["w"])).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    want = block["ref"]["grads"]
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def flips_held(got, want, range_main=15.0):
    """The tapped output's flip rule, in main quanta ``q = std / range_main``
    of the last tap's input (``want``'s std): at most 1 % of the elements
    more than q / 2 apart, none more than 5 q."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    q = np.std(want, ddof=1) / range_main
    d = np.abs(got - want)
    assert (d > q / 2).mean() <= 0.01, f"{int((d > q / 2).sum())} of {d.size} beyond q/2"
    assert d.max() <= 5 * q, f"max |d| {d.max() / q:.2f} quanta"


def test_block_tapped_forward_matches_in_truncation_mode(block):
    """Every tap of the block (conv, BatchNorm, ReLU of each conv, the
    pooled branch, the output) in truncation mode, train mode: the output to
    1e-5 of its scale (A, D) or by ``flips_held`` (B, C, E), the original
    sizes exactly JAX's, the new ones within 1e-4 (2 bits a flip)."""
    model = torch_block(block, tap=torch_tap()).train()
    ctx = TapContext(torch.Generator().manual_seed(0), SizeTotals())
    with torch.no_grad():
        y = model(nchw(block["x"]), ctx)
    if block["name"] in NO_FLIP:
        assert_close(nhwc(y), block["ref"]["y_tap"], 1e-5)
    else:
        flips_held(nhwc(y), block["ref"]["y_tap"])
    ref = block["ref"]["sizes"]
    assert set(ctx.sizes.totals) == set(ref) == {"forward_autograd"}
    got = ctx.sizes.totals["forward_autograd"].numpy()
    assert got[0] == ref["forward_autograd"][0]
    assert abs(got[1] - ref["forward_autograd"][1]) <= 1e-4 * ref["forward_autograd"][1]


# ------------------------------------------------------------ whole model
def inception_shapes():
    x = jnp.zeros((2, 16, 16, 3), jnp.float32)
    return jax.eval_shape(lambda: J.Inception3().init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x, train=False))


@pytest.fixture(scope="module")
def whole():
    return inception_shapes()


def test_conversion_maps_every_leaf(whole):
    """All 272 parameter leaves and 180 statistics leaves of a flax
    ``Inception3`` map onto the port's ``state_dict`` names, shapes equal."""
    n_params = len(jax.tree.leaves(whole["params"]))
    n_stats = len(jax.tree.leaves(whole["batch_stats"]))
    assert (n_params, n_stats) == (272, 180)
    variables = random_variables(whole, np.random.RandomState(5))
    sd = params_from_jax(variables["params"], variables["batch_stats"])
    model = T.inception_v3()
    want = model.state_dict()
    assert len(sd) == 452 and set(sd) == set(want)
    for name, t in sd.items():
        assert t.shape == want[name].shape, name
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == 21_638_954
    # a 1x7 kernel goes HWIO -> OIHW like any conv
    k = variables["params"]["Mixed_6b"]["branch7x7_2"]["conv"]["kernel"]
    np.testing.assert_array_equal(model.Mixed_6b.branch7x7_2.conv.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))


@pytest.mark.slow
def test_whole_model_eval_forward_matches(whole):
    """Batch 2 at 16x16 through the stem, A x3, B, C x4, D, E x2 and the
    head, in eval mode.  Taps off: the float32 logits to 1e-5 of their
    scale.  Every tap in truncation mode: the original sizes exactly JAX's
    and the new ones within 1e-4; the last block's output (2 x 3 x 3 x
    2048) as far from JAX's, in L2 norm, as 0.15 of JAX's own quantization
    error there (its tapped output against its untapped one): flips
    compound over the 292 taps before it (see ``flips_held``), and the 20
    logits pass two taps of their own, whose grid of std / 15 makes whole
    steps of them, so they are not compared."""
    r = np.random.RandomState(6)
    variables = random_variables(whole, r)
    x = r.randn(2, 16, 16, 3).astype(np.float32)
    logits_ref, plain_mut = jax.jit(lambda v: J.Inception3().apply(
        v, jnp.asarray(x), train=False, capture_intermediates=lambda m, _: m.name == "Mixed_7c",
        mutable=["intermediates"]))(variables)
    last_plain = np.asarray(plain_mut["intermediates"]["Mixed_7c"]["__call__"][0], np.float64)
    jmodel = J.Inception3(tap=jax_tap())
    (_, mut) = jax.jit(lambda v: jmodel.apply(
        v, jnp.asarray(x), train=False, rngs={"compress": jax.random.key(2)},
        capture_intermediates=lambda m, _: m.name == "Mixed_7c",
        mutable=["compression_stats", "intermediates"]))(variables)
    ref = np.asarray(fold_sown_stats(mut["compression_stats"])["forward_autograd"])
    last_ref = np.asarray(mut["intermediates"]["Mixed_7c"]["__call__"][0], np.float64)

    sd = params_from_jax(variables["params"], variables["batch_stats"])
    plain = T.inception_v3()
    plain.load_state_dict(sd)
    with torch.no_grad():
        logits = plain.eval()(nchw(x))
    assert logits.dtype == torch.float32 and logits.shape == (2, 10)
    assert_close(logits.numpy(), logits_ref, 1e-5)

    model = T.inception_v3(tap=torch_tap())
    model.load_state_dict(sd)
    seen = {}
    model.Mixed_7c.register_forward_hook(lambda m, a, y: seen.__setitem__("y", y))
    ctx = TapContext(torch.Generator().manual_seed(0), SizeTotals())
    with torch.no_grad():
        assert bool(torch.isfinite(model.eval()(nchw(x), ctx)).all())
    got = ctx.sizes.totals["forward_autograd"].numpy()
    assert got[0] == ref[0]
    assert abs(got[1] - ref[1]) <= 1e-4 * ref[1]
    last = nhwc(seen["y"]).astype(np.float64)
    # 0.07 of it at this seed
    assert np.linalg.norm(last - last_ref) <= 0.15 * np.linalg.norm(last_ref - last_plain)


def pre_fc(model, x, ctx):
    """The fc layer's input on one forward pass of ``model``, and the pooled
    features it was made from."""
    seen = {}
    h1 = model.fc.register_forward_pre_hook(lambda m, a: seen.__setitem__("fc_in", a[0]))
    h2 = model.Mixed_7c.register_forward_hook(
        lambda m, a, y: seen.__setitem__("pooled", y.mean(dim=(2, 3))))
    with torch.no_grad():
        model(x, ctx)
    h1.remove()
    h2.remove()
    return seen["fc_in"], seen["pooled"]


def test_dropout_keeps_half_scaled_like_flax_and_is_off_in_eval():
    """The pre-fc dropout keeps about half of the 2 x 2048 features and
    scales them by 1/0.5, as flax's ``nn.Dropout(0.5)`` does to the same
    features; in eval the fc sees the pooled features unchanged."""
    import flax.linen as nn

    torch.manual_seed(0)
    model = T.inception_v3()
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 3, 8, 8).astype(np.float32))
    ctx = TapContext(torch.Generator().manual_seed(0), dropout_gen=torch.Generator().manual_seed(3))
    fc_in, pooled = pre_fc(model.train(), x, ctx)
    live = pooled != 0  # ReLU's zeros stay zeros, kept or not
    kept = (fc_in != 0) & live
    torch.testing.assert_close(fc_in[kept], pooled[kept] * 2.0, rtol=1e-6, atol=0)
    ref = np.asarray(nn.Dropout(0.5, deterministic=False).apply(
        {}, jnp.asarray(pooled.numpy()), rngs={"dropout": jax.random.key(4)}))
    ref_kept = (ref != 0) & live.numpy()
    np.testing.assert_allclose(ref[ref_kept], pooled.numpy()[ref_kept] * 2.0, rtol=1e-6)
    n = int(live.sum())
    assert n > 1000
    for share in (int(kept.sum()) / n, int(ref_kept.sum()) / n):
        assert abs(share - 0.5) <= 4 * np.sqrt(0.25 / n)
    fc_in, pooled = pre_fc(model.eval(), x, TapContext(torch.Generator().manual_seed(0)))
    assert torch.equal(fc_in, pooled)


@pytest.mark.slow
def test_inception_cli_smoke_smart(tmp_path):
    """``--model inception --compress smart`` through the CLI on the CPU, as
    ``tests/test_inception_e2e.py`` runs the JAX one: the five tags, a ratio
    of 4.5-5.5, a finite loss."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # two threads, as on a machine shared with the suite's other workers
    env = dict(os.environ, SMAQ_SYNTH_TEST_N="8", SMAQ_DISABLE_TB="1", OMP_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "smart_quantization_tpu_torch.train", "--device", "cpu",
         "--model", "inception", "--dataset", "cifar10", "--compress", "smart",
         "--measure_compression_ratio", "--limit_train_batches", "2", "--limit_val_batches", "1",
         "--batch_size", "4", "--logdir", str(tmp_path)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    final = json.loads(out.stdout.split("final:", 1)[1])
    for tag in ("forward_autograd", "backward_autograd", "optimizer_grad", "optimizer_weight",
                "optimizer_momentum"):
        assert final[f"orig_size_{tag}"] > 0, tag
    assert 4.5 <= final["compression_ratio"] <= 5.5
    assert np.isfinite(final["val_loss"])
