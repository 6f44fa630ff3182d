"""The port's optimizer extensions against the JAX package's, one step on a
small tree (a conv leaf, a Dense leaf and bias, an embedding table, a
BatchNorm pair), SmaQ 6/8 in truncation mode, the same parameters,
gradients and starting momentum; the JAX trees reach the port through
``convert.tree_from_jax``, so its leaves are in torch's layouts.

- one step per flag (``momentum_rowwise``, ``momentum_log_nu``,
  ``momentum_log_nu_rowwise``, the weight accumulator, ``packed_momentum``,
  ``packed_weights``) for SGD and AdamW: every new parameter, momentum
  buffer and master leaf to rtol 1e-6 (packed leaves decoded), and equal
  original and new bit totals on every tag;
- row-wise stats along JAX's leading axis for a Dense, a conv and an
  embedding leaf, and a result that differs from taking the rows along the
  other axis;
- the CLI: the ported flags build, ``--momentum_log_nu_rowwise`` implies
  ``--momentum_log_nu``, and the packed-state settings JAX refuses raise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.optim import compressed as jopt
from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.convert import jax_axes, tree_from_jax
from smart_quantization_tpu_torch.ops.codebook import SmaQCodes
from smart_quantization_tpu_torch.optim import compressed as topt

SHAPES = {"conv1": {"kernel": (3, 3, 2, 4)}, "fc": {"kernel": (8, 6)}, "bn1": {"scale": (6,)}}
FLAGS = ["momentum_rowwise", "momentum_log_nu", "momentum_log_nu_rowwise",
         "use_weight_accumulator", "packed_momentum", "packed_weights"]
HYPER = {"sgd": (0.1, dict(momentum=0.9, weight_decay=5e-4)),
         "adamw": (1e-3, dict(weight_decay=0.01))}


def tree(r, scale=1.0, positive=False):
    out = {}
    for mod, leaves in SHAPES.items():
        out[mod] = {}
        for leaf, shape in leaves.items():
            v = r.randn(*shape).astype(np.float32) * scale
            if positive:  # Adam's nu: positive, with exact zeros
                v = np.where(r.rand(*shape) < 0.1, 0.0, np.abs(v)).astype(np.float32)
            out[mod][leaf] = v
    return out


def inputs(kind):
    r = np.random.RandomState(0)
    params, grads = tree(r), tree(r, 0.1)
    moms = [tree(r, 0.05)] if kind == "sgd" else [tree(r, 0.05), tree(r, 1e-3, positive=True)]
    return params, grads, moms


def flags_of(flag):
    # --momentum_log_nu_rowwise implies --momentum_log_nu (utils/config.py)
    return {flag: True, "momentum_log_nu": True} if flag == "momentum_log_nu_rowwise" else {flag: True}


def to_port(t) -> dict:
    """A JAX tree as the port's flat dict, in torch's layouts."""
    return tree_from_jax(jax.tree.map(np.asarray, t))


@functools.cache
def jax_steps(kind):
    """JAX's step under each flag, packed leaves decoded, as port dicts:
    ``{flag: ({"params": ..., buffer: ..., "master": ...}, metrics)}``;
    one jit for the six (compiled once: JAX's CPU compile is the cost)."""
    lr, hyper = HYPER[kind]
    spec = jopt.build_optimizer(kind, lr, **hyper)
    comps = {f: jopt.OptimizerCompression(
        compressor=jax_build_compressor("smart", stochastic_rounding=False), **flags_of(f))
        for f in FLAGS}

    def steps(params, grads, moms):
        out = {}
        for flag, comp in comps.items():
            state = jopt.init_opt_state(spec, params, comp)
            wrapped = isinstance(state, jopt.CompressedOptState)
            inner = state.inner if wrapped else state
            if not comp.packed_momentum:  # packed buffers start at their encoded zeros
                it = iter(moms)
                inner = jopt._map_momentum_state(inner, kind, lambda t, ap: next(it))
            state = jopt.CompressedOptState(inner, state.master) if wrapped else inner
            p_in = jopt.decode_params(jopt.encode_params(params, comp, jax.random.key(1)), comp)
            p, s, m = jopt.compressed_optimizer_step(
                spec, p_in, grads, state, jax.random.key(0), comp,
                weight_exempt=jopt.norm_param_mask(params))
            got = {"params": jopt.decode_params(p, comp)}
            if isinstance(s, jopt.CompressedOptState):
                got["master"], s = s.master, s.inner
            packed = jopt.packed_smaq_params(comp) if comp.packed_momentum else None

            def grab(t, ap):
                name = "trace" if kind == "sgd" else ("nu" if ap else "mu")
                got[name] = jopt._decode_tree(t, packed, ap) if packed is not None else t
                return t

            jopt._map_momentum_state(s, kind, grab)
            out[flag] = (got, m)
        return out

    res = jax.jit(steps)(*inputs(kind))
    return {f: ({k: to_port(v) for k, v in got.items()},
                {t: np.asarray(v) for t, v in m.items()}) for f, (got, m) in res.items()}


def port_step(kind, flag):
    params, grads, moms = inputs(kind)
    lr, hyper = HYPER[kind]
    spec = topt.build_optimizer(kind, lr, **hyper)
    comp = topt.OptimizerCompression(
        compressor=build_compressor("smart", stochastic_rounding=False), **flags_of(flag))
    names = list(to_port(params))
    state = topt.init_opt_state(spec, to_port(params), comp, torch.Generator().manual_seed(0))
    inner = state.inner if isinstance(state, topt.CompressedOptState) else state
    if not comp.packed_momentum:
        for (name, _), m in zip(spec.momentum_buffers, moms):
            inner[name] = to_port(m)
    p_in = topt.decode_params(topt.encode_params(to_port(params), comp), comp)
    p, s, metrics = topt.compressed_optimizer_step(
        spec, p_in, to_port(grads), state, torch.Generator().manual_seed(0), comp,
        weight_exempt=topt.norm_param_mask(names))
    return spec, comp, p, s, metrics


def close(got, want, what):
    """float32 agreement: rtol 5e-6 (the log2 codec's few ulps of an
    element's log) and 1e-6 of the leaf's largest magnitude (stats summed
    in another order move ``z * std + mean`` by ulps of the leaf's scale)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
@pytest.mark.parametrize("flag", FLAGS)
def test_flag_step_matches_jax(kind, flag):
    want, m_ref = jax_steps(kind)[flag]
    spec, comp, p_new, s_new, metrics = port_step(kind, flag)
    inner = s_new.inner if isinstance(s_new, topt.CompressedOptState) else s_new
    got = {"params": topt.decode_params(p_new, comp)}
    if isinstance(s_new, topt.CompressedOptState):
        got["master"] = s_new.master
    packed = topt.packed_smaq_params(comp) if comp.packed_momentum else None
    for name, ap in spec.momentum_buffers:
        got[name] = topt._decode_tree(inner[name], packed, ap) if packed else inner[name]
    assert set(got) == set(want)
    for what, ref in want.items():
        for n, v in ref.items():
            close(got[what][n].numpy(), v, f"{what} {n}")
    if comp.packed_weights:
        assert isinstance(p_new["conv1.weight"], SmaQCodes)
        assert not isinstance(p_new["bn1.weight"], SmaQCodes)  # exempt
    if comp.packed_momentum:
        buf = inner[spec.momentum_buffers[0][0]]
        assert isinstance(buf["conv1.weight"], SmaQCodes)
        assert not isinstance(buf["bn1.weight"], SmaQCodes)  # below min_size
    assert set(metrics) == set(m_ref)
    for tag, pair in metrics.items():
        np.testing.assert_array_equal(pair.numpy(), m_ref[tag], err_msg=tag)


ROW_LEAVES = {"fc.weight": (16, 12), "conv1.weight": (3, 3, 4, 8),
              "word_embeddings.weight": (20, 16)}


@functools.cache
def jax_rows():
    """JAX's row-wise quantization of each leaf of ``ROW_LEAVES`` and of
    the same leaf with its axes the other way round (one jit)."""
    r = np.random.RandomState(1)
    leaves = {}
    for name, shape in ROW_LEAVES.items():
        leaf = (r.randn(*shape) * np.linspace(0.1, 3.0, shape[-1])).astype(np.float32)
        leaves[name] = leaf
        leaves[name + " other"] = np.ascontiguousarray(leaf.T if leaf.ndim == 2
                                                       else leaf.transpose(3, 2, 0, 1))
    comp = jax_build_compressor("smart", stochastic_rounding=False)

    def rows(tree):
        return {k: jopt._quantize_tree({"x": v}, jax.random.key(0), comp, rowwise=True)
                for k, v in tree.items()}

    out = jax.jit(rows)(leaves)
    return leaves, {k: (np.asarray(y["x"]), float(n)) for k, (y, _, n) in out.items()}


@pytest.mark.parametrize("name", list(ROW_LEAVES))
def test_rows_follow_the_jax_axis(name):
    """Rows are the JAX leaf's leading axis: a Dense kernel's input
    features, a conv kernel's 3 kernel rows, an embedding's tokens; taking
    them along the other axis gives another result, so the test sees it."""
    leaves, ref = jax_rows()
    leaf_jax = leaves[name]
    axes = jax_axes(name, leaf_jax.ndim)
    inverse = tuple(axes.index(i) for i in range(len(axes)))
    leaf = torch.from_numpy(np.ascontiguousarray(leaf_jax.transpose(inverse)))
    comp = build_compressor("smart", stochastic_rounding=False)
    y, _, n = topt._quantize_tree({name: leaf}, None, comp, rowwise=True)
    want, want_bits = ref[name]
    close(y[name].permute(axes).numpy(), want, name)
    assert float(n) == want_bits
    other, other_bits = ref[name + " other"]
    other = other.T if other.ndim == 2 else other.transpose(2, 3, 1, 0)
    assert not np.allclose(other, want, rtol=5e-6, atol=1e-6 * float(np.abs(want).max()))
    assert other_bits != want_bits


def test_layout_map_inverts_the_converter():
    """``jax_axes`` takes every leaf of a port tree back to the JAX leaf it
    was converted from (conv, Dense, embedding, norm and bias leaves)."""
    r = np.random.RandomState(2)
    jax_tree = tree(r)
    for name, leaf in tree_from_jax(jax_tree).items():
        mod, _ = name.rsplit(".", 1)
        want = next(v for k, v in jax_tree[mod].items()
                    if {"kernel": "weight", "embedding": "weight", "scale": "weight",
                        "bias": "bias"}[k] == name.rsplit(".", 1)[1])
        np.testing.assert_array_equal(leaf.permute(jax_axes(name, leaf.dim())).numpy(), want)


@pytest.mark.parametrize("argv,want", [
    ("--momentum_rowwise --momentum_log_nu", dict(momentum_rowwise=True, momentum_log_nu=True,
                                                   momentum_log_nu_rowwise=False)),
    ("--momentum_log_nu_rowwise", dict(momentum_log_nu=True, momentum_log_nu_rowwise=True)),
    ("--use_weight_accumulator", dict(use_weight_accumulator=True)),
    ("--packed_momentum --packed_weights", dict(packed_momentum=True, packed_weights=True)),
    ("--checkpoint_dir ckpt --resume_from ckpt/epoch_0000.pt", {}),
])
def test_cli_builds_the_ported_flags(argv, want):
    from smart_quantization_tpu_torch.utils.config import build_components, parse_args

    comps = build_components(parse_args(
        f"--device cpu --compress smart --optimizer_type adamw {argv}"))
    for k, v in want.items():
        assert getattr(comps["optim_comp"], k) == v, k


@pytest.mark.parametrize("argv", [
    "--compress fp8 --packed_momentum", "--compress smart --packed_momentum --momentum_rowwise",
    "--compress smart --packed_momentum --no_compress_momentum_vectors",
    "--compress smart --packed_weights --no_compress_weights",
    "--compress smart --num_bits_main 9 --packed_weights",
])
def test_cli_refuses_what_jax_refuses(argv):
    from smart_quantization_tpu_torch.utils.config import build_components, parse_args

    with pytest.raises(ValueError):
        build_components(parse_args(f"--device cpu {argv}"))
