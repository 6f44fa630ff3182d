"""The port's BatchNorm-folded SmaQ against the JAX package's, in truncation
mode on the same numpy inputs.

The port folds over dim 1 of NCHW tensors, the JAX package over the last
axis of NHWC ones, so inputs are transposed between the two.  Tolerance:
the JAX package's own rule (tests/test_smaq.py:205-209): the two sides fold
reciprocals and sum in different orders, so elements near a bucket or grid
boundary may flip; fewer than 1e-3 of the elements differ by more than
1e-4, none by more than 0.5, and the bit counts by at most 2 per flip.

The JAX jnp path divides by gamma unguarded (NaN at gamma = 0); the port
follows the TPU kernel, which takes gamma = 0 as 1, on both its paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.ops.pallas.smaq_kernel import smaq_fused_bn
from smart_quantization_tpu.ops.smaq import SmaQParams as JaxParams
from smart_quantization_tpu.ops.smaq import smaq_quantize_dequantize as jax_smaq
from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, smaq_quantize_dequantize

TRUNC = SmaQParams(stochastic_rounding=False)
JTRUNC = JaxParams(stochastic_rounding=False)


def assert_rule(y, y_ref, bits, bits_ref):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    diff = np.abs(y - y_ref)
    flipped = diff > 1e-4
    assert flipped.mean() < 1e-3, f"{flipped.sum()} of {diff.size} flipped"
    assert diff.max() < 0.5
    assert abs(float(bits) - float(bits_ref)) <= 2 * flipped.sum() + 1e-3


def nhwc(x):
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def case(shape, seed, zero_gamma=False):
    """An NCHW input with per-channel (gamma, beta); gamma with zeros (the
    zero init of each residual branch's last BN) when asked."""
    r = np.random.RandomState(seed)
    c = shape[1]
    x = (r.randn(*shape) * 1.5 + 0.4).astype(np.float32)
    gamma = np.linspace(0.5, 2.0, c).astype(np.float32)
    if zero_gamma:
        gamma[::2] = 0.0
    beta = np.linspace(-0.5, 0.5, c).astype(np.float32)
    return x, gamma, beta


SHAPES = {"8x16x8x8": (8, 16, 8, 8), "ragged_4x10x7x5": (4, 10, 7, 5), "hw1_64x10x1x1": (64, 10, 1, 1)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_path_matches_jax(shape):
    x, g, b = case(SHAPES[shape], 0)
    y, bits = smaq_quantize_dequantize(torch.from_numpy(x), None, TRUNC,
                                       gamma=torch.from_numpy(g), beta=torch.from_numpy(b))
    y_ref, bits_ref = jax_smaq(jnp.asarray(nhwc(x)), None, JTRUNC,
                               gamma=jnp.asarray(g), beta=jnp.asarray(b))
    assert y.shape == x.shape
    assert_rule(nhwc(y.numpy()), y_ref, bits, bits_ref)


@pytest.mark.parametrize("zero_gamma", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_plain_version_matches_pallas_kernel(shape, zero_gamma):
    x, g, b = case(SHAPES[shape], 1, zero_gamma)
    y, bits = K.smaq_fused_bn_reference(torch.from_numpy(x), None, torch.from_numpy(g),
                                        torch.from_numpy(b), TRUNC)
    y_ref, bits_ref = smaq_fused_bn(jnp.asarray(nhwc(x)), None, jnp.asarray(g),
                                    jnp.asarray(b), JTRUNC, interpret=True)
    assert np.isfinite(y.numpy()).all()
    assert_rule(nhwc(y.numpy()), y_ref, bits, bits_ref)
    # the plain path keeps the same guard
    y2, bits2 = smaq_quantize_dequantize(torch.from_numpy(x), None, TRUNC,
                                         gamma=torch.from_numpy(g), beta=torch.from_numpy(b))
    assert_rule(y2.numpy(), y.numpy(), bits2, bits)


@pytest.mark.parametrize("path", ["plain", "kernel_plain_version"])
def test_bn_scalar_params_matches_jax_encoder(path):
    """``--bn_scalar_params`` folds the mean (gamma, beta) pair over the
    whole tensor, through the same functions."""
    x, g, b = case((8, 16, 8, 8), 2)
    enc = build_compressor("smart", stochastic_rounding=False, use_batch_norm=True,
                           bn_scalar_params=True)
    jenc = jax_build_compressor("smart", stochastic_rounding=False, use_batch_norm=True,
                                bn_scalar_params=True)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    if path == "plain":
        y, stats = enc(torch.from_numpy(x), None, gamma=gt, beta=bt)
        bits = stats.new_bits
    else:
        y, bits = K.smaq_fused_bn_reference(torch.from_numpy(x), None, gt.mean(), bt.mean(), TRUNC)
    y_ref, stats_ref = jenc(jnp.asarray(nhwc(x)), None, gamma=jnp.asarray(g), beta=jnp.asarray(b))
    assert_rule(nhwc(y.numpy()), y_ref, bits, stats_ref.new_bits)


def test_encoder_ignores_gamma_without_use_batch_norm():
    x, g, b = case((4, 8, 4, 4), 3)
    xt = torch.from_numpy(x)
    enc = build_compressor("smart", stochastic_rounding=False)
    y, _ = enc(xt, None, gamma=torch.from_numpy(g), beta=torch.from_numpy(b))
    y_ref, _ = smaq_quantize_dequantize(xt, None, TRUNC)
    assert torch.equal(y, y_ref)


def test_kernel_plain_version_stochastic_on_grid_and_layout_checks():
    x, g, b = case((8, 16, 8, 8), 4)
    xt, gt, bt = torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)
    params = SmaQParams()
    y, _ = K.smaq_fused_bn_reference(xt, torch.Generator().manual_seed(5), gt, bt, params)
    lo, _ = K.smaq_fused_bn_reference(xt, None, gt, bt, params, u=torch.zeros_like(xt))
    hi, _ = K.smaq_fused_bn_reference(xt, None, gt, bt, params, u=torch.ones_like(xt))
    assert bool((((y - lo).abs() <= 1e-6) | ((y - hi).abs() <= 1e-6)).all())
    assert K.channel_layout(xt, gt) == (16, 64)
    assert K.channel_layout(xt, gt.mean()) == (1, 1)
    with pytest.raises(ValueError):
        K.channel_layout(xt, gt[:8])
    with pytest.raises(ValueError):
        K.smaq_fused_bn(xt, None, gt, bt, TRUNC)
