"""The port's S2FP8 against the JAX package's, on the same numpy inputs.

Tolerance: the JAX package's own rule (tests/test_encoders.py:126-133).
The two sides take log2, pow and the mean with their own libraries, so the
squeezed value of an element near a rounding midpoint may land one FP8
grid step away: at least 98 % of the elements agree to 1e-3 relative, all
to 0.4.  In stochastic mode the port is handed the bits JAX draws from its
key, so the comparison is element by element there too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.ops.pallas.s2fp8_kernel import s2fp8_fused
from smart_quantization_tpu.ops.s2fp8 import s2fp8_quantize_dequantize as jax_s2fp8
from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
from smart_quantization_tpu_torch.ops.s2fp8 import OVERHEAD_BITS, s2fp8_quantize_dequantize


def assert_rule(y, y_ref):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    rel = np.abs(y - y_ref) / (np.abs(y_ref) + 1e-30)
    assert (rel < 1e-3).mean() >= 0.98
    assert np.all(rel < 0.4)


r = np.random.RandomState(0)
CASES = {
    "normal": (r.randn(8192) * 3.0).astype(np.float32),
    "signs_zeros": np.concatenate([
        np.array([0.0, -0.0, -1.5, 2.25, -0.003, 1e-20], np.float32),
        r.randn(4090).astype(np.float32)]),
    "wide_range": np.concatenate(
        [(r.randn(512) * s).astype(np.float32) for s in (1e-4, 1.0, 1e4)]),
    "ragged_3x17x19": (r.randn(3, 17, 19) * 0.02 - 0.01).astype(np.float32),
}


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_path_matches_jax(case, stochastic):
    x = CASES[case]
    key = jax.random.key(1) if stochastic else None
    rand = None
    if stochastic:
        rand = torch.from_numpy(np.asarray(jax.random.bits(key, x.shape, jnp.uint32)).astype(np.int64))
    y = s2fp8_quantize_dequantize(torch.from_numpy(x), None, stochastic=stochastic, rand=rand)
    y_ref = jax_s2fp8(jnp.asarray(x), key, stochastic=stochastic)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert_rule(y.numpy(), y_ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_plain_version_matches_pallas_kernel(case):
    x = CASES[case]
    y = S.s2fp8_fused_reference(torch.from_numpy(x), stochastic=False)
    y_ref = s2fp8_fused(jnp.asarray(x), None, stochastic=False, interpret=True)
    assert y.shape == x.shape
    assert_rule(y.numpy(), y_ref)
    # zeros of either sign come out as zeros, and every value keeps its sign
    y = y.numpy()
    assert np.all(y[x == 0] == 0)
    nz = y != 0
    assert np.all(np.sign(y[nz]) == np.sign(x[nz]))


@pytest.mark.parametrize("value", [0.0, 2.0, -0.25])
def test_constant_tensor_guard_matches_jax(value):
    """max == mean takes alpha = 1 on both sides: the same outputs (values
    with an exact log2, so that both means are exactly the max)."""
    x = np.full((4096,), value, np.float32)
    for y in (s2fp8_quantize_dequantize(torch.from_numpy(x), None, stochastic=False),
              S.s2fp8_fused_reference(torch.from_numpy(x), stochastic=False)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(jax_s2fp8(jnp.asarray(x), None,
                                                                      stochastic=False)))
    np.testing.assert_array_equal(
        S.s2fp8_fused_reference(torch.from_numpy(x), stochastic=False).numpy(),
        np.asarray(s2fp8_fused(jnp.asarray(x), None, stochastic=False, interpret=True)))


def test_kernel_plain_version_stats_and_stochastic_grid():
    """The stats kernel's plain version is the float64 mean and the max of
    log2|x|; stochastic outputs sit on one of the two roundings."""
    x = torch.from_numpy(CASES["normal"])
    mu, m = S.stats_reference(x)
    lg = np.log2(np.abs(CASES["normal"].astype(np.float64)))
    assert abs(float(mu) - lg.mean()) <= 1e-6 and abs(float(m) - lg.max()) <= 1e-6
    y = S.s2fp8_fused_reference(x, torch.Generator().manual_seed(2))
    lo = S.s2fp8_fused_reference(x, rand=torch.zeros(x.shape, dtype=torch.int64))
    hi = S.s2fp8_fused_reference(x, rand=torch.full(x.shape, 2**32 - 1))
    assert bool(((y == lo) | (y == hi)).all())


def test_encoder_sizes_and_cpu_dispatch():
    """S2FP8's size is 8 bits an element plus the 64-bit (alpha, beta); a
    CPU tensor takes ``ops/s2fp8.py``; the kernel wrapper refuses it."""
    x = torch.from_numpy(CASES["normal"])
    enc = build_compressor("s2fp8", stochastic=False)
    y, stats = enc(x, None)
    assert float(stats.orig_bits) == x.numel() * 32
    assert float(stats.new_bits) == x.numel() * 8 + OVERHEAD_BITS
    assert torch.equal(y, s2fp8_quantize_dequantize(x, None, stochastic=False))
    with pytest.raises(ValueError):
        S.s2fp8_fused(x, None, stochastic=False)
