"""The port's SmaQ (``smart_quantization_tpu_torch.ops``) against the JAX
package's, on the same numpy inputs.

Tolerance (the rule of tests/test_smaq.py:144-152): the two sides fold
reciprocals and sum in different orders, so an element whose z lies within
an ulp of a bucket or grid boundary may land one quantum away.  Such flips
(elements more than 1e-5 apart) stay below a 1e-4 fraction, none is more
than one main-bucket quantum (std / range_main) apart, and the bit counts
differ by at most 2 per flip.
"""

import importlib
import pkgutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.ops.pallas.smaq_kernel import smaq_fused
from smart_quantization_tpu.ops.smaq import SmaQParams as JaxParams
from smart_quantization_tpu.ops.smaq import smaq_quantize_dequantize as jax_smaq
from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, smaq_quantize_dequantize


def assert_flip_rule(y, y_ref, bits, bits_ref, quantum):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    diff = np.abs(y - y_ref)
    flipped = diff > 1e-5 + 2.5e-7 * np.abs(y_ref)
    assert flipped.mean() <= 1e-4, f"{flipped.sum()} of {diff.size} flipped"
    assert diff.max() <= quantum * (1 + 1e-4) + 1e-6
    assert abs(float(bits) - float(bits_ref)) <= 2 * flipped.sum() + 1e-3


def both(**kw):
    kw.setdefault("stochastic_rounding", False)
    return SmaQParams(**kw), JaxParams(**kw)


def quantum(x, params):
    return float(np.std(np.asarray(x, np.float64), ddof=1)) / params.range_main


rng = np.random.RandomState(0)
CASES = {
    "passthrough_7": (np.arange(7, dtype=np.float32), {}, {}),
    "n1000": ((rng.randn(1000) * 1.3 - 0.2).astype(np.float32), {}, {}),
    "33x77": ((rng.randn(33, 77) * 2.5 + 0.7).astype(np.float32), {}, {}),
    "constant": (np.full((64,), 3.25, np.float32), {}, {}),
    "all_positive": (
        (rng.randn(512) * 0.01 + 0.005).astype(np.float32), {}, {"all_positive": True}
    ),
    "range_std": ((rng.randn(4096)).astype(np.float32), {"use_range_std_dev": True}, {}),
    "fp16_clamp": (
        (rng.randn(2048) * 1e-6).astype(np.float32),
        {"std_clamp_lo": 1e-4, "std_clamp_hi": 1e4}, {},
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_path_matches_jax(case):
    x, pkw, ckw = CASES[case]
    tp, jp = both(**pkw)
    y, bits = smaq_quantize_dequantize(torch.from_numpy(x), None, tp, **ckw)
    y_ref, bits_ref = jax_smaq(jnp.asarray(x), None, jp, **ckw)
    if x.size < tp.min_size:
        np.testing.assert_array_equal(y.numpy(), x)
        assert float(bits) == x.size * 32 == float(bits_ref)
        return
    assert y.shape == tuple(y_ref.shape) and y.dtype == torch.float32
    assert_flip_rule(y.numpy(), y_ref, bits, bits_ref, max(quantum(x, tp), 1e-6))
    if case == "all_positive":
        assert float(y.min()) >= 0.0


@pytest.mark.parametrize("n", [8192, 300_000, "ill_conditioned"])
def test_kernel_plain_version_matches_pallas_kernel(n):
    """``smaq_fused_reference`` (the CUDA kernels' plain version) against
    the Pallas kernel in interpret mode; the ill-conditioned case (mean 1e3,
    std 1e-2) checks that the pivot keeps the variance."""
    r = np.random.RandomState(1)
    if n == "ill_conditioned":
        x = (r.randn(65536) * 1e-2 + 1e3).astype(np.float32)
    else:
        x = (r.randn(n) * 1.7 + 0.3).astype(np.float32)
    tp, jp = both()
    y, bits = K.smaq_fused_reference(torch.from_numpy(x), None, tp)
    y_ref, bits_ref = smaq_fused(jnp.asarray(x), None, jp, interpret=True)
    if n != "ill_conditioned":
        assert_flip_rule(y.numpy(), y_ref, bits, bits_ref, quantum(x, tp))
        return
    # the Pallas kernel's x * (1/std) - mean/std cancels to a few percent of
    # a grid step here, so it flips many elements (the port's (x - mean) * a
    # does not: next test); the rule of tests/test_smaq.py:154-176: no
    # larger error than the other side, the output follows the input, bits
    # within 2 %
    y, y_ref = y.numpy().astype(np.float64), np.asarray(y_ref, np.float64)
    assert np.std(y - x) < 2 * np.std(y_ref - x) + 1e-6
    assert np.corrcoef(x - x.mean(), y - y.mean())[0, 1] > 0.99
    assert abs(float(bits) - float(bits_ref)) < 0.02 * float(bits_ref)
    assert np.abs(y - y_ref).max() <= 1.1 * quantum(x, tp)


def ill_conditioned() -> np.ndarray:
    return (np.random.RandomState(1).randn(65536) * 1e-2 + 1e3).astype(np.float32)


def test_ill_conditioned_plain_path_equals_jax_jnp_path():
    """At mean 1e3 and std 1e-2 the port's plain SmaQ (the path every CPU
    tensor takes) is JAX's jnp path: given the same (mean, std), bitwise
    the same outputs and size, in truncation and with ``all_positive``;
    only the kernels' z changed to ``(x - mean) * a``.  Each side's own
    float32 mean sums in its own order (a few ulp apart at 1e3, which
    moves every output by as much), so with their own stats the outputs
    stay within one quantum."""
    from smart_quantization_tpu.ops.smaq import compute_stats as jax_stats

    x = ill_conditioned()
    tp, jp = both()
    mean, std = (np.asarray(v) for v in jax_stats(jnp.asarray(x), jp, None))
    for kw in ({}, {"all_positive": True}):
        y, bits = smaq_quantize_dequantize(torch.from_numpy(x), None, tp, mean=torch.tensor(mean),
                                           std=torch.tensor(std), **kw)
        y_ref, bits_ref = jax_smaq(jnp.asarray(x), None, jp, mean=jnp.asarray(mean),
                                   std=jnp.asarray(std), **kw)
        np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))
        assert float(bits) == float(bits_ref)
    y, _ = smaq_quantize_dequantize(torch.from_numpy(x), None, tp)
    y_ref, _ = jax_smaq(jnp.asarray(x), None, jp)
    assert abs(float(torch.from_numpy(x).mean()) - float(mean)) <= 4 * np.spacing(np.float32(1e3))
    assert np.abs(y.numpy().astype(np.float64) - np.asarray(y_ref)).max() <= quantum(x, tp)


def test_ill_conditioned_kernel_plain_version_holds_the_flip_rule():
    """The kernels' plain version computes z as ``(x - mean) * a``, as
    ``csrc/smaq.cu`` does: at mean 1e3 and std 1e-2 it holds the ordinary
    flip rule against the port's plain path (the folded ``x * a + b`` put
    about 2 % of the elements a grid step away), in truncation and with
    ``all_positive``."""
    x = torch.from_numpy(ill_conditioned())
    tp, _ = both()
    for kw in ({}, {"all_positive": True}):
        y, bits = K.smaq_fused_reference(x, None, tp, **kw)
        y_ref, bits_ref = smaq_quantize_dequantize(x, None, tp, **kw)
        assert_flip_rule(y.numpy(), y_ref.numpy(), bits, bits_ref, quantum(x.numpy(), tp))


def test_kernel_plain_version_range_std_matches_plain_path():
    """The JAX kernel path ignores ``use_range_std_dev`` (ROADMAP Queue 3);
    the port's kernel honours it, so its plain version is held against the
    port's ``ops/smaq.py`` range-std path (itself held against JAX above)."""
    x = (np.random.RandomState(8).randn(50_000) * 0.7 + 0.1).astype(np.float32)
    tp, _ = both(use_range_std_dev=True)
    y, bits = K.smaq_fused_reference(torch.from_numpy(x), None, tp)
    y_ref, bits_ref = smaq_quantize_dequantize(torch.from_numpy(x), None, tp)
    std = (x.max() - x.min()) / np.sqrt(2 * np.log(x.size))
    assert_flip_rule(y.numpy(), y_ref.numpy(), bits, bits_ref, std / tp.range_main)


def test_plain_path_stochastic_unbiased():
    """Repeated-application drift stays near zero (tests/test_smaq.py:65-77)."""
    params = SmaQParams(stochastic_rounding=True)
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(np.random.RandomState(2).randn(64, 64).astype(np.float32))
    acc = torch.zeros_like(x)
    reps = 200
    for _ in range(reps):
        y, _ = smaq_quantize_dequantize(x, gen, params)
        acc += y - x
    assert float((acc / reps).abs().mean()) < 0.02


def test_kernel_plain_version_stochastic_on_grid():
    """Stochastic outputs of the kernels' plain version sit on one of the two
    grid points around each input (``u = 0`` and ``u = 1``), unbiased."""
    params = SmaQParams()
    x = torch.from_numpy(np.random.RandomState(3).randn(1 << 20).astype(np.float32))
    y, _ = K.smaq_fused_reference(x, torch.Generator().manual_seed(4), params)
    lo, _ = K.smaq_fused_reference(x, None, params, u=torch.zeros_like(x))
    hi, _ = K.smaq_fused_reference(x, None, params, u=torch.ones_like(x))
    on_grid = ((y - lo).abs() <= 1e-6) | ((y - hi).abs() <= 1e-6)
    assert bool(on_grid.all())
    err = (y - x).double()
    assert abs(float(err.mean())) <= 4 * float(err.std()) / np.sqrt(x.numel())


def test_cpu_dispatch_takes_plain_path(monkeypatch):
    """On a CPU tensor the dispatcher runs ``ops/smaq.py`` (with the same
    random stream), the kernel wrapper refuses the tensor, and neither
    importing the package nor quantizing calls ``nvcc``."""
    import smart_quantization_tpu_torch
    from smart_quantization_tpu_torch.ops.cuda import build

    def no_subprocess(*a, **k):
        raise AssertionError("nvcc must not run on the CPU")

    monkeypatch.setattr(subprocess, "run", no_subprocess)
    for mod in pkgutil.walk_packages(
        smart_quantization_tpu_torch.__path__, "smart_quantization_tpu_torch."
    ):
        importlib.import_module(mod.name)
    x = torch.from_numpy(np.random.RandomState(5).randn(4096).astype(np.float32))
    y, bits = K.smaq_fused_or_reference(x, torch.Generator().manual_seed(6), SmaQParams())
    y_ref, bits_ref = smaq_quantize_dequantize(x, torch.Generator().manual_seed(6), SmaQParams())
    assert torch.equal(y, y_ref) and float(bits) == float(bits_ref)
    with pytest.raises(ValueError):
        K.smaq_fused(x, None, SmaQParams(stochastic_rounding=False))
    assert not build.loaded()


def test_sample_stats_positions_match_pallas_kernel():
    """``use_sample_stats`` on the kernel path uses the TPU kernel's strided
    positions: with the same stats the two agree under the flip rule."""
    r = np.random.RandomState(7)
    x = (r.randn(300_000) * 2.0 + 0.5).astype(np.float32)
    tp, jp = both(use_sample_stats=True, num_samples=16)
    y, bits = K.smaq_fused_reference(torch.from_numpy(x), None, tp)
    y_ref, bits_ref = smaq_fused(jnp.asarray(x), None, jp, interpret=True)
    stats = K.sample_stats(torch.from_numpy(x), tp)
    assert_flip_rule(y.numpy(), y_ref, bits, bits_ref, float(stats[1]) / tp.range_main)

