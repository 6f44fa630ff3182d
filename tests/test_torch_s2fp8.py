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
from smart_quantization_tpu_torch.ops.float_format import FP8_FORMAT, float_quantize, to_bits
from smart_quantization_tpu_torch.ops.s2fp8 import (
    OVERHEAD_BITS,
    s2fp8_quantize_dequantize,
    squeeze_coefs,
)


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


def _e5m2_grid() -> torch.Tensor:
    """Every finite positive e5m2 value: the subnormals 1-3 x 2^-16, then
    (1 + m/4) x 2^e for e in -14..15 (123 values)."""
    sub = [k * 2.0**-16 for k in (1, 2, 3)]
    normal = [(1 + m / 4) * 2.0**e for e in range(-14, 16) for m in range(4)]
    return torch.tensor(sub + normal, dtype=torch.float32)


def _table_index(t: torch.Tensor) -> torch.Tensor:
    """The kernels' table index of positive float32 values on the e5m2
    grid: ``(bits >> 21) - TABLE_BASE``."""
    return (to_bits(t) >> 21) - S.TABLE_BASE


def test_unsqueeze_table_index_covers_the_e5m2_grid():
    """The kernels' table index ``(bits >> 21) - 444`` puts the 123 values
    the e5m2 round can return (its fixed points, 2^-16 to 57344) in 0..127,
    each at its own index."""
    grid = _e5m2_grid()
    assert grid.numel() == 123 and float(grid.max()) == 57344.0
    assert torch.equal(float_quantize(grid, FP8_FORMAT, stochastic=False, check_inf=False), grid)
    k = _table_index(grid)
    assert int(k.min()) == 0 and int(k.max()) == S.TABLE_SIZE - 1
    assert k.unique().numel() == grid.numel()


def _coefs(x):
    return squeeze_coefs(*S.stats_reference(torch.from_numpy(x).reshape(-1)))


# (alpha, beta) of two test tensors and of the constant-tensor guard (alpha = 1)
COEFS = {
    "normal": lambda: _coefs(CASES["normal"]),
    "wide_range": lambda: _coefs(CASES["wide_range"]),
    "constant_guard": lambda: _coefs(np.full((64,), 2.0, np.float32)),
}


@pytest.mark.parametrize("coefs", sorted(COEFS))
def test_unsqueeze_table_matches_per_element_unsqueeze(coefs):
    """The table looked up at a grid value is, bitwise, what the plain
    version's per-element unsqueeze gives that value (here each grid value
    four times or more in a shuffled tensor, so the two go through other
    positions), and every nonzero output of the plain version is a table
    entry.  The tensor is 512 elements: torch's CPU exp2 runs its SIMD
    path in blocks of 32 and a scalar one on what is left, which may
    differ in the last bit (on the card every element takes the same
    path)."""
    alpha, beta = COEFS[coefs]()
    if coefs == "constant_guard":
        assert float(alpha) == 1.0
    table = S.unsqueeze_table_reference(alpha, beta)
    assert table.shape == (S.TABLE_SIZE,) and table.dtype == torch.float32
    grid = _e5m2_grid()
    t = grid[torch.from_numpy(np.random.RandomState(3).permutation(512) % grid.numel())]
    per_element = S.unsqueeze_reference(t, beta, 1.0 / alpha)
    assert torch.equal(table[_table_index(t)].view(torch.int32), per_element.view(torch.int32))
    if coefs != "constant_guard":
        y = S.s2fp8_fused_reference(torch.from_numpy(CASES[coefs]), stochastic=False).abs()
        assert bool(torch.isin(y[y != 0], table).all())


@pytest.mark.parametrize("n", [4096, 16385])
def test_constant_inexact_log2_stays_finite(n):
    """A constant -0.375 (log2 inexact): the float64 mean is exactly the
    max, so the guard takes alpha = 1 and the output stays finite, on each
    side of the small form's threshold."""
    x = torch.full((n,), -0.375)
    mu, m = S.stats_reference(x)
    assert float(mu) == float(m)
    y = S.s2fp8_fused_reference(x, stochastic=False)
    assert bool(torch.isfinite(y).all())
    assert float((y + 0.375).abs().max()) <= 1e-6


def test_constant_inexact_log2_plain_path_finite_where_jax_is_nan():
    """A constant -0.375 of 1000 elements: the port's plain path takes the
    mean of log2|x| in float64 (``log2_stats``), which is exactly the max,
    so the guard takes alpha = 1 and gives the value back, as the kernel
    does.  The JAX package's float32 mean misses the max by an ulp there
    and its output is NaN: a deliberate divergence (ROADMAP Queue 3)."""
    x = np.full((1000,), -0.375, np.float32)
    y = s2fp8_quantize_dequantize(torch.from_numpy(x), None, stochastic=False)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_array_equal(y.numpy(), x)
    np.testing.assert_array_equal(
        S.s2fp8_fused_reference(torch.from_numpy(x), stochastic=False).numpy(), x)
    assert np.isnan(np.asarray(jax_s2fp8(jnp.asarray(x), None, stochastic=False))).all()


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
