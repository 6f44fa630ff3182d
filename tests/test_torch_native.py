"""The port's bindings of the native libraries (``smart_quantization_tpu_torch/
bdi.py``, ``smaq_golden.py``) against the JAX package's, on the same
``native/build/*.so`` and the same numpy-seeded inputs: the cases of
``tests/test_native.py`` give bitwise the JAX binding's outputs; a tensor
off the host raises; and the port's plain SmaQ statistics
(``ops/smaq.py::compute_stats``, full and range std) agree with the golden
model's modes 0 and 1 to float32's tolerance of an n-term sum (the golden
model sums in float32 in order and its mode 0 std is the biased one).
"""

import math

import numpy as np
import pytest
import torch

from smart_quantization_tpu import bdi as jbdi
from smart_quantization_tpu import smaq_golden as jgolden
from smart_quantization_tpu_torch import bdi, smaq_golden
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, compute_stats


def configs(mod, **kw):
    """tests/test_native.py's deterministic configuration in ``mod``."""
    base = kw.pop("base", [(1, 32, d, f"d{d}") for d in (4, 8, 16)])
    return mod.CompressionConfig(
        base_configs=[mod.CompressionBaseConfig(*b) for b in base],
        **{"use_stochastic_rounding": False, "use_zero_compression": False,
           "use_randomized_base_selection": False, **kw})


LINES = {
    "presentation": np.array([0xC04039C0, 0xC04039C8, 0xC04039D0, 0xC04039F8], np.uint32),
    "perl_bench": (0xC04039C0 + 8 * np.arange(8)).astype(np.uint32),
}


@pytest.mark.parametrize("name", sorted(LINES))
def test_compress_line_exact_is_the_jax_bindings(name):
    line = LINES[name]
    got = bdi.compress_line_exact(configs(bdi), torch.from_numpy(line.astype(np.int64)))
    want = jbdi.compress_line_exact(configs(jbdi), line)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


def test_uncompressible_line_raises_in_both():
    line = np.array([0x00000001, 0x40000000, 0x80000000, 0xC0000000], np.uint32)
    base = [(1, 32, 4, "d4")]
    for mod, arr in ((bdi, torch.from_numpy(line.astype(np.int64))), (jbdi, line)):
        with pytest.raises(RuntimeError):
            mod.compress_line_exact(configs(mod, base=base), arr)


def _buffers():
    """tests/test_native.py's round-trip buffers and configurations: (words,
    configuration keywords, scale, zero point)."""
    r = np.random.RandomState(0)
    quantized = (1_000_000 + r.randint(0, 200, size=256)).astype(np.uint32)
    quantized[::64] = 1_000_000
    r = np.random.RandomState(1)
    shifted = (50_000_000 + r.randint(0, 1 << 12, size=64)).astype(np.uint32)
    shifted[0] = 50_000_000
    r = np.random.RandomState(2)
    threaded = (7_000_000 + r.randint(0, 255, size=64 * 128)).astype(np.uint32)
    threaded[::64] = 7_000_000
    return {
        "quantized_int": (quantized, dict(base=[(2, 32, 8, "b2d8")], use_zero_compression=True),
                          0.5, 10),
        "zero_compression": (np.zeros(64, np.uint32),
                             dict(base=[(1, 32, 8, "d8")], use_zero_compression=True,
                                  use_randomized_base_selection=True), 1.0, 0),
        "scale_factor_shifts": (shifted, dict(base=[(1, 32, 16, "d16")], scale_factor_base=8,
                                              scale_factor_delta=8), 1.0, 0),
        "multithreaded": (threaded, dict(base=[(1, 32, 8, "d8")], use_zero_compression=True,
                                         num_threads=4), 1.0, 0),
    }


@pytest.mark.parametrize("case", sorted(_buffers()))
def test_replace_with_compressed_repr_is_the_jax_bindings(case):
    words, kw, scale, zero_point = _buffers()[case]
    dest = torch.zeros(words.size, dtype=torch.float32)
    bits, schemes, (c_ns, _) = bdi.replace_with_compressed_repr(
        configs(bdi, **kw), torch.from_numpy(words.astype(np.int64)).to(torch.uint32), dest,
        scale, zero_point)
    jdest = np.zeros(words.size, np.float32)
    jbits, jschemes, _ = jbdi.replace_with_compressed_repr(configs(jbdi, **kw), words, jdest,
                                                           scale, zero_point)
    assert bits == jbits and c_ns > 0
    np.testing.assert_array_equal(dest.numpy(), jdest)
    np.testing.assert_array_equal(schemes.numpy(), jschemes)


def _golden_inputs():
    return {
        "full": (np.random.RandomState(0).randn(1024).astype(np.float32) * 2 + 1, 0),
        "range": (np.random.RandomState(1).randn(2048).astype(np.float32), 1),
        "sixteen": (np.random.RandomState(4).randn(4096).astype(np.float32) * 3 + 1, 2),
    }


@pytest.mark.parametrize("case", sorted(_golden_inputs()))
def test_golden_stats_are_the_jax_bindings(case):
    x, mode = _golden_inputs()[case]
    assert smaq_golden.stats(torch.from_numpy(x), mode) == jgolden.stats(x, mode)


def test_golden_codecs_are_the_jax_bindings():
    """compress, decompress and their BN forms on test_native.py's inputs."""
    x = np.random.RandomState(2).randn(1024).astype(np.float32)
    mean, std = jgolden.stats(x)
    q = smaq_golden.compress(torch.from_numpy(x), mean, std)
    jq = jgolden.compress(x, mean, std)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(smaq_golden.decompress(q, mean, std).numpy(),
                                  jgolden.decompress(jq, mean, std))
    flags = np.array([0.5, -0.5, 2.0, -2.0], np.float32)
    np.testing.assert_array_equal(smaq_golden.compress(torch.from_numpy(flags), 0.0, 1.0).numpy(),
                                  jgolden.compress(flags, 0.0, 1.0))
    xb = np.random.RandomState(3).randn(512).astype(np.float32)
    mean, std = jgolden.stats(xb)
    qb = smaq_golden.compress_bn(torch.from_numpy(xb), mean, std, 2.0, 0.25)
    jqb = jgolden.compress_bn(xb, mean, std, 2.0, 0.25)
    np.testing.assert_array_equal(qb.numpy(), jqb)
    np.testing.assert_array_equal(smaq_golden.decompress_bn(qb, mean, std, 2.0, 0.25).numpy(),
                                  jgolden.decompress_bn(jqb, mean, std, 2.0, 0.25))


def test_tensors_off_the_host_raise():
    """The libraries read host memory: a tensor on another device (``meta``
    here; ``chip_smoke.py`` passes a CUDA one) raises, never copied."""
    off = torch.zeros(64, device="meta")
    with pytest.raises(ValueError, match="on meta.*CPU tensors"):
        smaq_golden.stats(off)
    with pytest.raises(ValueError, match="on meta"):
        smaq_golden.decompress(off.to(torch.int32), 0.0, 1.0)
    with pytest.raises(ValueError, match="on meta"):
        bdi.replace_with_compressed_repr(configs(bdi), off.to(torch.int64),
                                         torch.zeros(64), 1.0, 0)
    with pytest.raises(ValueError, match="on meta"):
        bdi.replace_with_compressed_repr(configs(bdi), torch.zeros(64, dtype=torch.int64),
                                         off, 1.0, 0)


def _ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(abs(v))) - 23)


def _sequential_stats(x: np.ndarray) -> tuple[float, float]:
    """The golden model's mode 0 in numpy: float32 sums of x and x * x in
    order, the biased std in float32 (``smaq_golden.cpp:72-80``)."""
    n = np.float32(x.size)
    m1 = np.float32(np.add.accumulate(x, dtype=np.float32)[-1] / n)
    m2 = np.float32(np.add.accumulate(x * x, dtype=np.float32)[-1] / n)
    return float(m1), float(np.sqrt(np.float32(m2 - m1 * m1)))


@pytest.mark.parametrize("n", [1000, 4096, 65_536])
def test_plain_smaq_stats_against_the_golden_model(n):
    """``compute_stats`` (two-pass, ddof=1) and the golden model, each
    against float64 statistics of the same float32 values: the plain mean
    and std within the error bound of a float32 pairwise sum (log2(n)
    float32 rounding units of the values' scale) plus an ulp, the range std
    within 4 ulps; the golden model's mode 0 bitwise its float32
    sequential sums emulated in numpy and within twice their measured error
    plus 2 ulps, mode 1's mean the same sums, its range std within 4 ulps."""
    x = np.random.RandomState(n).randn(n).astype(np.float32) * 3 + 1.5
    xd = x.astype(np.float64)
    mean64 = float(xd.mean())
    std1, std0 = float(xd.std(ddof=1)), float(xd.std())
    range64 = (float(xd.max()) - float(xd.min())) / math.sqrt(2.0 * math.log(n))
    pairwise = math.log2(n) * 2.0 ** -24
    mean, std = compute_stats(torch.from_numpy(x), SmaQParams(), None)
    assert abs(float(mean) - mean64) <= pairwise * np.abs(xd).mean() + _ulp(mean64)
    assert abs(float(std) - std1) <= 2 * pairwise * std1 + _ulp(std1)
    _, r_std = compute_stats(torch.from_numpy(x), SmaQParams(use_range_std_dev=True), None)
    assert abs(float(r_std) - range64) <= 4 * _ulp(range64)

    g_mean, g_std = smaq_golden.stats(torch.from_numpy(x), 0)
    e_mean, e_std = _sequential_stats(x)
    assert (g_mean, g_std) == (e_mean, e_std)
    assert abs(g_mean - mean64) <= 2 * abs(e_mean - mean64) + 2 * _ulp(mean64)
    assert abs(g_std - std0) <= 2 * abs(e_std - std0) + 2 * _ulp(std0)
    g1_mean, g1_std = smaq_golden.stats(torch.from_numpy(x), 1)
    assert g1_mean == e_mean
    assert abs(g1_std - range64) <= 4 * _ulp(range64)
