"""The port's compressed optimizer step against the JAX package's, one step
on a small tree with a BatchNorm leaf, truncation mode, the same gradients
and the same starting momentum.

Tolerance: per leaf the flip rule (tests/test_smaq.py:144-152) on the new
parameters and momentum; per tag equal original sizes and new sizes within
2 bits per flipped element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.optim import compressed as jopt
from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.optim.compressed import (
    OptimizerCompression,
    build_optimizer,
    compressed_optimizer_step,
    norm_param_mask,
)
from smart_quantization_tpu_torch.utils.config import multistep_schedule

SHAPES = {"conv": {"kernel": (3, 3, 4, 8)}, "bn": {"scale": (8,), "bias": (8,)},
          "fc": {"kernel": (8, 10), "bias": (10,)}}


def tree(r, scale=1.0, positive=False):
    out = {}
    for mod, leaves in SHAPES.items():
        out[mod] = {}
        for leaf, shape in leaves.items():
            v = r.randn(*shape).astype(np.float32) * scale
            out[mod][leaf] = np.abs(v) if positive else v
    return out


def flat(t):
    return {f"{m}.{k}": torch.from_numpy(np.array(v)) for m, d in t.items() for k, v in d.items()}


def flips(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    diff = np.abs(a - b)
    return diff, int((diff > 1e-5 + 2.5e-7 * np.abs(b)).sum())


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_compressed_step_matches_jax(kind):
    r = np.random.RandomState(0)
    params, grads = tree(r), tree(r, 0.1)
    moms = {"sgd": [tree(r, 0.05)], "adam": [tree(r, 0.05), tree(r, 1e-3, positive=True)]}[kind]

    spec_j = jopt.build_optimizer(kind, 0.1, momentum=0.9, weight_decay=5e-4)
    state_j = spec_j.tx.init(params)
    it = iter(moms)
    state_j = jopt._map_momentum_state(state_j, kind, lambda t, ap: jax.tree.map(jnp.asarray, next(it)))
    comp_j = jopt.OptimizerCompression(
        compressor=jax_build_compressor("smart", stochastic_rounding=False)
    )
    p_ref, s_ref, m_ref = jax.jit(
        lambda p, g, s: jopt.compressed_optimizer_step(
            spec_j, p, g, s, jax.random.key(0), comp_j,
            weight_exempt=jopt.norm_param_mask(p),
        )
    )(params, grads, state_j)

    spec = build_optimizer(kind, 0.1, momentum=0.9, weight_decay=5e-4)
    names = list(flat(params))
    state = {"count": 0}
    for (name, _), m in zip(spec.momentum_buffers, moms):
        state[name] = flat(m)
    comp = OptimizerCompression(compressor=build_compressor("smart", stochastic_rounding=False))
    p_new, s_new, metrics = compressed_optimizer_step(
        spec, flat(params), flat(grads), state, torch.Generator().manual_seed(0), comp,
        weight_exempt=norm_param_mask(names),
    )

    n_flip = 0
    refs = {"params": flat(jax.tree.map(np.asarray, p_ref))}
    if kind == "sgd":
        refs["trace"] = flat(jax.tree.map(np.asarray, s_ref[1].trace))
    else:
        refs["mu"] = flat(jax.tree.map(np.asarray, s_ref[1].mu))
        refs["nu"] = flat(jax.tree.map(np.asarray, s_ref[1].nu))
    for what, ref in refs.items():
        got = p_new if what == "params" else s_new[what]
        for name in names:
            diff, f = flips(got[name].numpy(), ref[name].numpy())
            quantum = float(ref[name].std()) / 15 + 1e-7
            assert f <= max(1e-4 * diff.size, 1), (what, name, f)
            assert diff.max() <= quantum * (1 + 1e-4) + 1e-6, (what, name)
            n_flip += f
    assert float(s_new["count"]) == 1
    for tag in ("optimizer_grad", "optimizer_weight", "optimizer_momentum"):
        got, ref = metrics[tag].numpy(), np.asarray(m_ref[tag])
        assert got[0] == ref[0], tag
        assert abs(got[1] - ref[1]) <= 2 * n_flip + 1e-3, tag


def test_bn_leaves_exempt_from_weight_compression():
    mask = norm_param_mask(["conv1.weight", "bn1.weight", "layer1_0.downsample_bn.bias",
                            "layer1_0.downsample_conv.weight", "fc.bias"])
    assert mask == {"conv1.weight": False, "bn1.weight": True,
                    "layer1_0.downsample_bn.bias": True,
                    "layer1_0.downsample_conv.weight": False, "fc.bias": False}


def test_multistep_schedule_matches_optax():
    ref = optax.piecewise_constant_schedule(0.1, {m * 16: 0.1 for m in (2, 5)})
    ours = multistep_schedule(0.1, 0.1, [2, 5], 16)
    for count in (0, 31, 32, 33, 79, 80, 200):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6)
