"""The port's float formats (``ops/float_format.py``, the plain version of
the float kernel) against the JAX package's ``float_quantize``, bitwise.

Both work on the float32 bit pattern, so the two agree bit for bit: in
nearest mode on their own, in stochastic mode when the port is handed the
exact bits JAX draws from its key (``jax.random.bits(key, shape,
uint32)``, ``float_format.py:112``).  The inputs hold the edge values:
signed zeros, +-1e38, float32 subnormals, +-inf, NaN, the formats' max and
``2^emin``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.ops import float_format as jff
from smart_quantization_tpu.ops.pallas.float_kernel import float_quantize_fused
from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.ops import float_format as ff
from smart_quantization_tpu_torch.ops.cuda import float_kernel as F

FORMATS = {
    "fp8": (ff.FP8_FORMAT, jff.FP8_FORMAT),
    "fp16": (ff.FP16_FORMAT, jff.FP16_FORMAT),
    "bf16": (ff.BF16_FORMAT, jff.BF16_FORMAT),
}
EDGES = np.array(
    [0.0, -0.0, 1e38, -1e38, 3.4e38, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
     1.1754942e-38, -5.9e-39, 57344.0, -57344.0, 61440.0, 65504.0, 65520.0,
     2.0**-14, -(2.0**-14), 2.0**-16, 2.0**-17, 1.5 * 2.0**-17, 2.0**-24,
     2.0**-126, 2.0**-133, 3.3895314e38],
    np.float32,
)


def inputs(seed=0, subnormals=True):
    r = np.random.RandomState(seed)
    parts = [r.randn(4096) * 2.0, r.randn(2048) * 1e-6, r.randn(512) * 3e4]
    if subnormals:
        parts.append(r.randn(512) * 1e-40)
    return np.concatenate([*(p.astype(np.float32) for p in parts), EDGES])


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("check_inf", [True, False])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_nearest_is_bitwise_equal_to_jax(fmt, check_inf):
    tf, jf = FORMATS[fmt]
    x = inputs()
    y = ff.float_quantize(torch.from_numpy(x), tf, stochastic=False, check_inf=check_inf)
    y_ref = jff.float_quantize(jnp.asarray(x), jf, None, stochastic=False, check_inf=check_inf)
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_array_equal(bits(y.numpy()), bits(y_ref))


@pytest.mark.parametrize("check_inf", [True, False])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_stochastic_is_bitwise_equal_given_jax_bits(fmt, check_inf):
    tf, jf = FORMATS[fmt]
    x = inputs(1).reshape(-1, 2)
    key = jax.random.key(3)
    rand = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    y = ff.float_quantize(torch.from_numpy(x), tf, stochastic=True, check_inf=check_inf,
                          rand=torch.from_numpy(rand.astype(np.int64)))
    y_ref = jff.float_quantize(jnp.asarray(x), jf, key, stochastic=True, check_inf=check_inf)
    np.testing.assert_array_equal(bits(y.numpy()), bits(y_ref))
    # int32 bit patterns are the same words
    y32 = ff.float_quantize(torch.from_numpy(x), tf, stochastic=True, check_inf=check_inf,
                            rand=torch.from_numpy(rand.view(np.int32).copy()))
    assert torch.equal(y32.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_plain_version_matches_pallas_kernel(fmt):
    """Nearest mode against the Pallas kernel in interpret mode.  For BF16
    the Pallas kernel takes float32 subnormal inputs through float
    arithmetic on its own subnormal grid, which in interpret mode on the
    CPU returns +-max or inf for them (ROADMAP Queue 3); those inputs are
    held against the jnp path above instead."""
    tf, jf = FORMATS[fmt]
    x = inputs(2, subnormals=fmt != "bf16")
    if fmt == "bf16":
        x = x[(np.abs(x) >= np.float32(2.0**-126)) | (x == 0) | ~np.isfinite(x)]
    y = ff.float_quantize(torch.from_numpy(x), tf, stochastic=False, check_inf=True)
    y_ref = float_quantize_fused(jnp.asarray(x), jf, None, stochastic=False, check_inf=True,
                                 interpret=True)
    np.testing.assert_array_equal(bits(y.numpy()), bits(y_ref))


def test_edge_semantics():
    """+max becomes +inf under check_inf and -max stays finite; 2^emin is
    a normal value; below half a quantum rounds to zero; NaN and inf pass."""
    fmt = ff.FP8_FORMAT
    x = torch.tensor([1e38, -1e38, 2.0**-14, 2.0**-17, 1.5 * 2.0**-17, float("nan"),
                      float("-inf"), -0.0])
    y = ff.float_quantize(x, fmt, stochastic=False, check_inf=True)
    assert y[0] == float("inf") and y[1] == -fmt.max_value
    assert y[2] == 2.0**-14
    assert y[3] == 0.0 and y[4] == 2.0**-16
    assert torch.isnan(y[5]) and y[6] == float("-inf")
    assert y[7] == 0.0 and torch.signbit(y[7])
    y = ff.float_quantize(x, fmt, stochastic=False, check_inf=False)
    assert y[0] == fmt.max_value


def test_stochastic_is_unbiased():
    x = torch.from_numpy(np.random.RandomState(4).randn(1 << 16).astype(np.float32))
    y = ff.float_quantize(x, ff.FP8_FORMAT, torch.Generator().manual_seed(5))
    err = (y - x).double()
    assert abs(float(err.mean())) <= 4 * float(err.std()) / np.sqrt(x.numel())
    lo = ff.float_quantize(x, ff.FP8_FORMAT, rand=torch.zeros(x.shape, dtype=torch.int64))
    hi = ff.float_quantize(x, ff.FP8_FORMAT, rand=torch.full(x.shape, 2**32 - 1))
    assert bool(((y == lo) | (y == hi)).all())


def test_cpu_dispatch_and_kernel_refusal():
    """A CPU tensor takes the plain version; the kernel wrapper refuses it."""
    x = torch.from_numpy(inputs(6))
    y = F.float_quantize_fused_or_reference(x, ff.BF16_FORMAT, None, stochastic=False)
    assert torch.equal(y.view(torch.int32),
                       ff.float_quantize(x, ff.BF16_FORMAT, stochastic=False).view(torch.int32))
    with pytest.raises(ValueError):
        F.float_quantize_fused(x, ff.FP8_FORMAT, None, stochastic=False)
    with pytest.raises(ValueError):
        F.float_quantize_fused_or_reference(x, ff.FP8_FORMAT, None, stochastic=True)


@pytest.mark.parametrize("name", ["fp8", "fp16", "bf16"])
def test_encoder_sizes_and_precision16_match_jax(name):
    """The float encoders in nearest mode: the same bits as JAX's encoder,
    with and without the precision-16 round trip through FP16, and
    ``n * total_bits`` as the new size."""
    from smart_quantization_tpu.compress import build_compressor as jax_build_compressor

    x = inputs(7)
    x = x[np.isfinite(x)][:7184].reshape(-1, 4)
    for precision in (32, 16):
        enc = build_compressor(name, stochastic=False, precision=precision)
        jenc = jax_build_compressor(name, stochastic=False, precision=precision)
        y, stats = enc(torch.from_numpy(x), None)
        y_ref, stats_ref = jenc(jnp.asarray(x), None)
        np.testing.assert_array_equal(bits(y.numpy()), bits(y_ref))
        assert float(stats.orig_bits) == float(stats_ref.orig_bits) == x.size * 32
        assert float(stats.new_bits) == float(stats_ref.new_bits) == x.size * enc.fmt.total_bits
