"""The port's unified-codebook SmaQ storage (``ops/codebook.py``) against
the JAX package's, with JAX's own cases (tests/test_codebook.py:30-125) as
parametrised cases: on the same numpy input, truncation mode,

- the uint8 codes equal JAX's bitwise, the stats to float32 rounding, and
  the decoded values to float32 tolerance (stats summed in another order);
- ``smaq_decode(smaq_encode(x, gen))`` equals the port's plain fake path
  (``ops/smaq.py``) bitwise wherever ``|z| <= storage_z_limit``, with the
  same generator state in stochastic mode too (both draw the same noise on
  the CPU), with ``all_positive`` and with sampled stats;
- the alphabet's sizes and limits equal JAX's; the codes take a quarter of
  float32's bytes; zeros round-trip exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.ops import codebook as jcb
from smart_quantization_tpu.ops.smaq import SmaQParams as JaxSmaQParams
from smart_quantization_tpu_torch.ops import codebook as cb
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, smaq_quantize_dequantize

BITS = [(6, 8), (3, 5), (3, 4), (2, 3), (3, 3), (8, 8)]


def data(n=4096, scale=3.0, shift=1.5, seed=7):
    return (np.random.RandomState(seed).randn(n) * scale + shift).astype(np.float32)


@functools.cache
def jax_codes():
    """JAX's truncation-mode codes, stats and decode of ``data()`` at each
    bit width (one jit)."""
    x = data()

    def encode_all(x):
        out = {}
        for bm, bo in BITS:
            p = JaxSmaQParams(num_bits_main=bm, num_bits_outlier=bo, stochastic_rounding=False)
            enc = jcb.smaq_encode(x, None, p)
            out[(bm, bo)] = (enc.codes, enc.mean, enc.std, jcb.smaq_decode(enc, p))
        return out

    return {k: tuple(np.asarray(v) for v in vals)
            for k, vals in jax.jit(encode_all)(jnp.asarray(x)).items()}


def in_range(x, enc, params):
    z = (x - enc.mean) / enc.std
    return (z.abs() <= cb.storage_z_limit(params)).numpy()


@pytest.mark.parametrize("bm,bo", BITS)
def test_codes_match_jax(bm, bo):
    params = SmaQParams(num_bits_main=bm, num_bits_outlier=bo, stochastic_rounding=False)
    codes, mean, std, decoded = jax_codes()[(bm, bo)]
    enc = cb.smaq_encode(torch.from_numpy(data()), None, params)
    assert enc.codes.dtype == torch.uint8
    np.testing.assert_array_equal(enc.codes.numpy(), codes)
    np.testing.assert_allclose(float(enc.mean), mean, rtol=1e-6)
    np.testing.assert_allclose(float(enc.std), std, rtol=1e-6)
    got = cb.smaq_decode(enc, params).numpy()
    # 2/3 bits: range_main is 0, so main-bucket values are 0/0 = NaN, in JAX too
    np.testing.assert_allclose(got, decoded, rtol=1e-6, atol=1e-6 * np.nanmax(np.abs(decoded)))


@pytest.mark.parametrize("bm,bo", BITS)
@pytest.mark.parametrize("stochastic", [False, True])
def test_decode_is_the_fake_path_bitwise(bm, bo, stochastic):
    params = SmaQParams(num_bits_main=bm, num_bits_outlier=bo, stochastic_rounding=stochastic)
    x = torch.from_numpy(data())
    y_fake, _ = smaq_quantize_dequantize(x, torch.Generator().manual_seed(42), params)
    enc = cb.smaq_encode(x, torch.Generator().manual_seed(42), params)
    y = cb.smaq_decode(enc, params)
    ok = in_range(x, enc, params)
    np.testing.assert_array_equal(y.numpy()[ok], y_fake.numpy()[ok])
    assert np.isfinite(y.numpy()[~ok]).all()


@pytest.mark.parametrize("case", ["all_positive", "sampled_stats", "range_std"])
def test_decode_is_the_fake_path_bitwise_in_other_modes(case):
    params = SmaQParams(use_sample_stats=case == "sampled_stats",
                        use_range_std_dev=case == "range_std")
    ap = case == "all_positive"
    x = torch.from_numpy(data(2048, 0.01, 0.0, seed=3) if ap else data(8192, 1.0, 0.0, seed=12))
    y_fake, _ = smaq_quantize_dequantize(x, torch.Generator().manual_seed(4), params,
                                         all_positive=ap)
    enc = cb.smaq_encode(x, torch.Generator().manual_seed(4), params)
    y = cb.smaq_decode(enc, params, all_positive=ap)
    ok = in_range(x, enc, params)
    np.testing.assert_array_equal(y.numpy()[ok], y_fake.numpy()[ok])
    if ap:
        assert float(y.min()) >= 0.0


def test_alphabet_matches_jax():
    for bm, bo in BITS + [(9, 8), (9, 9)]:
        ours = SmaQParams(num_bits_main=bm, num_bits_outlier=bo)
        theirs = JaxSmaQParams(num_bits_main=bm, num_bits_outlier=bo)
        assert cb.codebook_size(ours) == jcb.codebook_size(theirs)
        assert cb.supports_codebook(ours) == jcb.supports_codebook(theirs)
        assert cb.outlier_side_steps(ours) == jcb.outlier_side_steps(theirs)
        assert cb.storage_z_limit(ours) == pytest.approx(jcb.storage_z_limit(theirs), rel=1e-12)
    assert cb.codebook_size(SmaQParams()) == 160
    with pytest.raises(ValueError, match="codebook"):
        cb.smaq_encode(torch.zeros(16), None, SmaQParams(num_bits_main=9, num_bits_outlier=9))
    with pytest.raises(ValueError, match="min_size"):
        cb.smaq_encode(torch.zeros(4), None, SmaQParams())


def test_storage_is_4x_smaller_and_zeros_round_trip():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    enc = cb.smaq_encode(x, torch.Generator().manual_seed(1), SmaQParams())
    assert enc.codes.shape == x.shape and enc.codes.dtype == torch.uint8
    assert cb.real_bits(enc) == x.numel() * 8 + 64
    assert enc.codes.numel() * enc.codes.element_size() * 4 == x.numel() * x.element_size()
    zeros = cb.smaq_encode(torch.zeros(256), torch.Generator().manual_seed(0), SmaQParams())
    assert torch.equal(cb.smaq_decode(zeros, SmaQParams()), torch.zeros(256))
