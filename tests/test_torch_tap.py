"""The port's compression tap against ``jax.vjp`` of the JAX package's
``compression_tap``, in truncation mode on the same numpy inputs.

Tolerance: the flip rule (tests/test_smaq.py:144-152) on the forward value
and on the gradient; the per-tag sizes agree to 2 bits per flipped element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.inject.tap import compression_tap as jax_tap
from smart_quantization_tpu_torch.compress import SizeTotals, build_compressor
from smart_quantization_tpu_torch.inject.policy import LayerKind, TapPolicy
from smart_quantization_tpu_torch.inject.tap import (
    TapConfig,
    TapContext,
    compression_tap,
    module_tap,
)


def flips(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    diff = np.abs(a - b)
    flipped = diff > 1e-5 + 2.5e-7 * np.abs(b)
    return diff, int(flipped.sum())


def assert_close(a, b, quantum):
    diff, n_flip = flips(a, b)
    assert n_flip <= 1e-4 * diff.size
    assert diff.max() <= quantum * (1 + 1e-4) + 1e-6
    return n_flip


@pytest.fixture(scope="module")
def inputs():
    r = np.random.RandomState(0)
    x = (r.randn(4, 6, 5, 8) * 1.5 + 0.2).astype(np.float32)
    ct = (r.randn(4, 6, 5, 8) * 0.3).astype(np.float32)
    return x, ct


def test_tap_value_gradient_and_sizes_match_jax(inputs):
    x, ct = inputs
    jcomp = jax_build_compressor("smart", stochastic_rounding=False)
    tcomp = build_compressor("smart", stochastic_rounding=False)

    def f(xx, tok):
        return jax_tap(xx, None, jcomp, bwd_token=tok)[0]

    y_ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.zeros((2,), jnp.float32))
    g_ref, bwd_ref = vjp(jnp.asarray(ct))
    _, fwd_ref = jax_tap(jnp.asarray(x), None, jcomp)

    xt = torch.from_numpy(x).requires_grad_()
    sizes = SizeTotals()
    y, fwd = compression_tap(xt, torch.Generator().manual_seed(0), tcomp, sizes=sizes)
    y.backward(torch.from_numpy(ct))

    q_x = np.std(x, ddof=1) / tcomp.params.range_main
    q_g = np.std(ct, ddof=1) / tcomp.params.range_main
    n_fwd = assert_close(y.detach().numpy(), y_ref, q_x)
    n_bwd = assert_close(xt.grad.numpy(), g_ref, q_g)
    assert float(fwd.orig_bits) == float(fwd_ref.orig_bits) == x.size * 32
    assert abs(float(fwd.new_bits) - float(fwd_ref.new_bits)) <= 2 * n_fwd
    bwd = sizes.totals["backward_autograd"].numpy()
    assert bwd[0] == float(bwd_ref[0]) == ct.size * 32
    assert abs(bwd[1] - float(bwd_ref[1])) <= 2 * n_bwd


@pytest.mark.parametrize("mode", ["autograd", "global_hook", "policy_off"])
def test_module_tap_tags_and_directions(inputs, mode):
    """``module_tap`` records forward sizes under the config's tag; the
    global-hook mode leaves the gradient untouched; a kind outside the
    policy passes through."""
    x, ct = inputs
    comp = build_compressor("smart", stochastic_rounding=False)
    cfg = TapConfig(compressor=comp)
    if mode == "global_hook":
        cfg = cfg.as_global_hook()
    elif mode == "policy_off":
        cfg = TapConfig(compressor=comp, policy=TapPolicy.of(LayerKind.CONV))
    xt = torch.from_numpy(x).requires_grad_()
    ctx = TapContext(torch.Generator().manual_seed(1), SizeTotals())
    y = module_tap(xt, LayerKind.ACTIVATION, cfg, ctx)
    y.backward(torch.from_numpy(ct))
    if mode == "policy_off":
        assert y is xt and ctx.sizes.totals == {}
        return
    assert set(ctx.sizes.totals) == (
        {"forward_hook"} if mode == "global_hook" else {"forward_autograd", "backward_autograd"}
    )
    assert not torch.equal(y.detach(), xt.detach())  # forward compressed
    grad_untouched = torch.equal(xt.grad, torch.from_numpy(ct))
    assert grad_untouched == (mode == "global_hook")
