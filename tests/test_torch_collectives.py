"""The port's quantized collectives (``parallel/collectives.py``) and shard
rule (``parallel/mesh.py``) against the JAX package's.

The port's side runs on gloo ranks that start once per module (a pool of
2 ranks and one of 4, the second also laid out as a 2 x 2 mesh); JAX's
runs ``shard_map`` on the first 2 or 4 of the conftest's virtual CPU
devices, over a mesh of the same shape, on the same inputs.  The ranks
import torch only: JAX is imported in this process alone, inside the
reference helpers.

- ``key=None``: every one of the nine functions agrees with JAX, the int8
  paths bitwise and the gather mode (a float32 sum of the ranks'
  dequantized payloads, in rank order) within 1 ulp;
- a key: a zero gradient comes back exactly zero, and the error over 64
  draws is unbiased within 4 sigma of its own spread;
- ``bits=9`` raises in every function (JAX wraps the int8 payload);
- ``fsdp_shard_axis`` is JAX's rule, and ``shard_dim`` maps it to the
  torch dim of the JAX layout (bert-base's 768 x 768 Dense shards on torch
  dim 0, flax's ``out`` axis).
"""

import functools

import numpy as np
import pytest
import torch

from smart_quantization_tpu_torch.parallel import collectives as C
from smart_quantization_tpu_torch.parallel.distributed import RankPool
from smart_quantization_tpu_torch.parallel.mesh import fsdp_shard_axis, make_mesh, shard_dim

# (dp, fsdp) of each mesh the tests use, and the pool that runs it
MESHES = {"2": (2, 1), "4": (4, 1), "2x2": (2, 2)}
SIZES = (1000, 3 * 1024 + 17)  # a leaf under one chunk, a ragged one


@pytest.fixture(scope="module")
def pools():
    made = {2: RankPool(2, "cpu", timeout_s=120.0), 4: RankPool(4, "cpu", timeout_s=120.0)}
    yield made
    for pool in made.values():
        pool.close()


def run_on(pools, mesh_name, fn, *args):
    dp, fsdp = MESHES[mesh_name]
    return pools[dp * fsdp].run(fn, dp, fsdp, *args)


# ------------------------------------------------------------- the ranks
@functools.lru_cache(maxsize=None)
def _mesh(dp, fsdp):
    return make_mesh(dp, fsdp)


def _group(mesh, axes):
    return mesh.group(tuple(axes) if isinstance(axes, list) else axes)


def _gen(seed, mesh):
    return None if seed is None else torch.Generator().manual_seed(seed * 1000 + mesh.rank)


def rank_call(dp, fsdp, name, inputs, kw, seed=None):
    """``collectives.<name>`` on this rank's inputs (a dict of arrays for
    the tree forms, else one array), groups named by ``kw``."""
    mesh = _mesh(dp, fsdp)
    kw = dict(kw)
    for k in ("group", "scatter_group", "sum_group"):
        if kw.get(k) is not None:
            kw[k] = _group(mesh, kw[k])
    x = inputs[mesh.rank]
    if isinstance(x, dict):
        x = {k: torch.from_numpy(v) for k, v in x.items()}
    else:
        x = torch.from_numpy(x)
    group = kw.pop("group", None) or kw.pop("scatter_group")
    out = getattr(C, name)(x, group, _gen(seed, mesh), **kw)
    if isinstance(out, dict):
        return {k: v.numpy() for k, v in out.items()}
    return out.numpy()


def rank_draws(dp, fsdp, name, inputs, kw, draws):
    """``draws`` stochastic calls; their outputs' mean and the mean of
    their squares (per element), as float64."""
    outs = [rank_call(dp, fsdp, name, inputs, kw, seed=s + 1) for s in range(draws)]
    if isinstance(outs[0], dict):
        outs = [np.concatenate([o[k].reshape(-1) for k in sorted(o)]) for o in outs]
    outs = [o.reshape(-1) for o in outs]
    stack = np.stack(outs).astype(np.float64)
    return stack.mean(0), (stack**2).mean(0)


# ---------------------------------------------------------- JAX's side
def jax_call(mesh_name, fn, inputs):
    """``fn`` on each device's input under ``shard_map`` on the conftest's
    virtual CPU devices; the per-device outputs stacked in rank order."""
    import jax
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    dp, fsdp = MESHES[mesh_name]
    mesh = Mesh(np.asarray(jax.devices()[:dp * fsdp]).reshape(dp, fsdp), ("data", "fsdp"))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *inputs)
    spec = P(("data", "fsdp"))
    body = shard_map(lambda x: jax.tree.map(lambda y: y[None], fn(jax.tree.map(lambda y: y[0], x))),
                     mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    out = jax.jit(body)(stacked)
    return jax.tree.map(np.asarray, out)


def tree_inputs(n, seed, zero=False):
    r = np.random.RandomState(seed)
    return [{f"leaf{i}": (np.zeros(s, np.float32) if zero else
                          (r.randn(s) * (1 + 3 * i)).astype(np.float32))
             for i, s in enumerate(SIZES)} for _ in range(n)]


def array_inputs(n, shape, seed, zero=False):
    r = np.random.RandomState(seed)
    return [np.zeros(shape, np.float32) if zero else r.randn(*shape).astype(np.float32)
            for _ in range(n)]


# name, mesh, inputs, the port's keywords, JAX's call, gather mode (1 ulp)
def _cases():
    from_jax = "smart_quantization_tpu.parallel.collectives"
    cases = []
    for mesh_name in ("2", "4"):
        n = MESHES[mesh_name][0]
        cases += [
            ("compressed_allreduce_mean", mesh_name, ("tree", n), {"group": "data"},
             (from_jax, "compressed_allreduce_mean", ("data",), {}), True),
            ("compressed_psum_mean", mesh_name, ("tree", n), {"group": "data"},
             (from_jax, "compressed_psum_mean", ("data",), {}), False),
            ("compressed_psum_mean_chunked", mesh_name, ("tree", n), {"group": "data"},
             (from_jax, "compressed_psum_mean_chunked", ("data",), {}), False),
            ("compressed_psum_mean_flat", mesh_name, ("array", n, (2500,)), {"group": "data"},
             (from_jax, "compressed_psum_mean_flat", ("data",), {}), False),
            ("compressed_all_gather_flat", mesh_name, ("array", n, (2500,)), {"group": "data"},
             (from_jax, "compressed_all_gather_flat", ("data",), {}), False),
            ("compressed_all_gather", mesh_name, ("array", n, (6, 300)),
             {"group": "data", "gather_axis": 1},
             (from_jax, "compressed_all_gather", ("data",), {"gather_axis": 1}), False),
            ("compressed_reduce_scatter_mean", mesh_name, ("array", n, (3, 4 * n, 100)),
             {"scatter_group": "data", "scatter_dimension": 1},
             (from_jax, "compressed_reduce_scatter_mean", ("data",), {"scatter_dimension": 1}),
             False),
            ("compressed_reduce_scatter_rows", mesh_name, ("array", n, (n, 2100)),
             {"scatter_group": "data"},
             (from_jax, "compressed_reduce_scatter_rows", ("data",), {}), False),
        ]
    # the 2 x 2 mesh: a sum over 'data', a scatter over 'fsdp', both axes
    cases += [
        ("compressed_reduce_scatter_rows", "2x2", ("array", 4, (2, 2100)),
         {"scatter_group": "fsdp", "sum_group": "data"},
         (from_jax, "compressed_reduce_scatter_rows", ("fsdp",), {"sum_axis_name": "data"}),
         False),
        ("compressed_reduce_scatter_mean", "2x2", ("array", 4, (5, 8, 30)),
         {"scatter_group": "fsdp", "sum_group": "data", "scatter_dimension": 1},
         (from_jax, "compressed_reduce_scatter_mean", ("fsdp",),
          {"sum_axis_name": "data", "scatter_dimension": 1}), False),
        ("compressed_psum_mean_flat", "2x2", ("array", 4, (2500,)), {"group": ["data", "fsdp"]},
         (from_jax, "compressed_psum_mean_flat", (("data", "fsdp"),), {}), False),
        ("compressed_psum_mean_chunked", "2x2", ("tree", 4), {"group": ["data", "fsdp"]},
         (from_jax, "compressed_psum_mean_chunked", (("data", "fsdp"),), {}), False),
        ("compressed_all_gather_flat", "2x2", ("array", 4, (2500,)), {"group": "fsdp"},
         (from_jax, "compressed_all_gather_flat", ("fsdp",), {}), False),
    ]
    return cases


CASES = _cases()


def make_inputs(spec, seed=0, zero=False):
    if spec[0] == "tree":
        return tree_inputs(spec[1], seed, zero)
    return array_inputs(spec[1], spec[2], seed, zero)


def reference(case, inputs):
    import importlib

    _, mesh_name, _, _, (module, fname, args, kw), _ = case
    fn = getattr(importlib.import_module(module), fname)
    return jax_call(mesh_name, lambda x: fn(x, *args, None, **kw), inputs)


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_matches_jax_without_a_key(pools, case):
    name, mesh_name, spec, kw, _, gather = case
    inputs = make_inputs(spec)
    got = run_on(pools, mesh_name, rank_call, name, inputs, kw)
    want = reference(case, inputs)
    for r, out in enumerate(got):
        pairs = ([(out[k], want[k][r]) for k in out] if isinstance(out, dict)
                 else [(out, want[r])])
        for a, b in pairs:
            assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
            if gather:
                np.testing.assert_array_max_ulp(a, b, maxulp=1)
            else:
                np.testing.assert_array_equal(a, b)


def test_quantize_leaf_matches_jax():
    from smart_quantization_tpu.parallel.collectives import _quantize_leaf as jax_quantize

    x = np.random.RandomState(3).randn(5, 700).astype(np.float32)
    x[1] = 0.0  # a zero chunk keeps scale 0
    q, s = C._quantize_leaf(torch.from_numpy(x), None, 8)
    q_ref, s_ref = jax_quantize(x, None, 8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


STOCHASTIC = [c for c in CASES if c[1] in ("2", "2x2")]


@pytest.mark.parametrize("case", STOCHASTIC, ids=[f"{c[0]}-{c[1]}" for c in STOCHASTIC])
def test_stochastic_rounding(pools, case):
    """A key: zero in, exactly zero out; over 64 draws the mean error is
    within 4 sigma of zero (sigma from the draws' own spread)."""
    name, mesh_name, spec, kw, _, _ = case
    zeros = make_inputs(spec, zero=True)
    for out in run_on(pools, mesh_name, rank_call, name, zeros, kw, 7):
        vals = out.values() if isinstance(out, dict) else [out]
        assert all(not v.any() for v in vals)
    inputs = make_inputs(spec, seed=5)
    draws = 64
    got = run_on(pools, mesh_name, rank_draws, name, inputs, kw, draws)
    truth = plain_result(case, inputs)
    for r, (mean, sq) in enumerate(got):
        t = truth[r]
        err = mean - t
        var = np.maximum(sq - mean**2, 0.0)
        sigma = np.sqrt(var.sum() / draws) / err.size  # of the mean error
        assert abs(err.mean()) <= 4 * sigma + 1e-12, (name, r)


def plain_result(case, inputs):
    """What each rank's output estimates, in float64: the mean over the
    ranks summed in, scattered or gathered as the function moves it."""
    name, mesh_name = case[:2]
    dp, fsdp = MESHES[mesh_name]
    n = dp * fsdp

    def flat(o):
        return (np.concatenate([o[k].reshape(-1) for k in sorted(o)]) if isinstance(o, dict)
                else o).astype(np.float64)

    if name in ("compressed_all_gather_flat", "compressed_all_gather"):
        return [_gathered(case, inputs, r) for r in range(n)]
    if name.startswith("compressed_reduce_scatter"):
        return [_scattered(case, inputs, r) for r in range(n)]
    return [np.mean([flat(i) for i in inputs], 0)] * n


def _gathered(case, inputs, r):
    name, mesh_name, _, kw, _, _ = case
    dp, fsdp = MESHES[mesh_name]
    members = ([d * fsdp + r % fsdp for d in range(dp)] if kw["group"] == "data"
               else [(r // fsdp) * fsdp + j for j in range(fsdp)])
    xs = [np.asarray(inputs[m], np.float64) for m in members]
    if name == "compressed_all_gather_flat":
        return np.stack(xs).reshape(-1)
    return np.concatenate(xs, axis=kw["gather_axis"]).reshape(-1)


def _scattered(case, inputs, r):
    name, mesh_name, _, kw, _, _ = case
    dp, fsdp = MESHES[mesh_name]
    total = np.mean([np.asarray(i, np.float64) for i in inputs], 0)
    if kw["scatter_group"] == "data":
        n, i = dp, r // fsdp
    else:
        n, i = fsdp, r % fsdp
    if name == "compressed_reduce_scatter_rows":
        return total[i]
    return np.split(total, n, axis=kw["scatter_dimension"])[i].reshape(-1)


NINE = ("compressed_allreduce_mean", "compressed_psum_mean", "compressed_psum_mean_chunked",
        "compressed_psum_mean_flat", "compressed_all_gather_flat", "compressed_all_gather",
        "compressed_reduce_scatter_mean", "compressed_reduce_scatter_rows", "_quantize_leaf")


@pytest.mark.parametrize("name", NINE)
def test_nine_bits_raise(name):
    """The payload is int8: 9 bits would wrap it (as in JAX), so it raises
    before any collective runs."""
    x = torch.ones(8)
    fn = getattr(C, name)
    with pytest.raises(ValueError, match="bits must lie in 2..8"):
        if name == "_quantize_leaf":
            fn(x, None, 9)
        elif name in ("compressed_allreduce_mean", "compressed_psum_mean",
                      "compressed_psum_mean_chunked"):
            fn({"w": x}, None, None, bits=9)
        elif name == "compressed_reduce_scatter_rows":
            fn(x.reshape(2, 4), None, None, bits=9)
        else:
            fn(x, None, None, bits=9)


SHAPES = [(768, 768), (768, 3072), (3072, 768), (3, 3, 64, 128), (3, 3, 3, 64), (10,), (7, 5),
          (2, 512), (30522, 768), (1,), (6, 4, 6)]


@pytest.mark.parametrize("fsdp", [1, 2, 4, 8])
def test_fsdp_shard_axis_matches_jax(fsdp):
    from smart_quantization_tpu.parallel.mesh import fsdp_shard_axis as jax_axis

    for shape in SHAPES:
        assert fsdp_shard_axis(shape, fsdp) == jax_axis(shape, fsdp), shape


def test_shard_dim_takes_the_jax_layout():
    """bert-base's 768 x 768 Dense: flax's kernel is (in, out) and shards on
    ``out`` (a tie goes to the last axis); torch's weight is (out, in), so
    the shard is torch dim 0.  A conv kernel HWIO (3, 3, 64, 128) shards on
    O, torch dim 0 of OIHW; an embedding table keeps its axes."""
    q = "bert.encoder.layer.0.attention.self.query.weight"
    assert shard_dim(q, (768, 768), 2) == 0
    assert shard_dim("bert.encoder.layer.0.intermediate.dense.weight", (3072, 768), 2) == 0
    assert shard_dim("layer1.0.conv1.weight", (128, 64, 3, 3), 2) == 0
    assert shard_dim("bert.embeddings.word_embeddings.weight", (30522, 768), 2) == 0
    assert shard_dim("bert.embeddings.word_embeddings.weight", (30522, 768), 4) == 1
    assert shard_dim("fc.bias", (10,), 4) == -1
    assert shard_dim("fc.weight", (10, 512), 4) == 1  # flax (512, 10): axis 0
