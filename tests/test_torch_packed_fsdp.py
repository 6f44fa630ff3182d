"""The FSDP layout of packed state against the JAX package's:
``encode_params`` / ``init_opt_state`` with ``fsdp_size=2`` and
``reshard_packed_state`` 2 -> 1 and 1 -> 2 (``optim/compressed.py``), on a
tree with a conv kernel, a Dense kernel whose two axes tie (bert-base's
768 x 768 case, scaled down: flax shards ``out``, torch dim 0) and a leaf
that does not divide, with the deterministic compressor: codes bitwise,
the stats in their ``(fsdp,)`` / ``(1,)`` shapes to 1e-6 of the std (the
order of a float32 sum; ``tests/test_torch_codebook.py``'s rule), and the
global layout bitwise what each shard encodes on its own.  JAX runs
eagerly here, as its trainer's init and restore run these functions.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import jax_trace, jax_tree_to_port


def packed_trees(seed=3):
    """A flax-shaped tree with a conv kernel, a Dense kernel whose two axes
    tie (bert-base's case, scaled down) and a leaf that does not divide, in
    JAX and in the port's layout."""
    r = np.random.RandomState(seed)
    tree = {"conv": {"kernel": r.randn(3, 3, 16, 32).astype(np.float32)},
            "query": {"kernel": r.randn(64, 64).astype(np.float32)},
            "odd": {"kernel": r.randn(5, 7).astype(np.float32)}}
    return tree, {k: torch.from_numpy(v) for k, v in jax_tree_to_port(tree).items()}


def assert_packed_equal(got: dict, ref_tree):
    """The port's packed tree against JAX's: codes bitwise (in the port's
    layout), the stats' shapes exactly and values to 1e-6 of the std (the
    order of a float32 sum), float32 leaves bitwise."""
    from smart_quantization_tpu.ops.codebook import SmaQCodes as JaxCodes
    from smart_quantization_tpu_torch.convert import _convert_leaf
    from smart_quantization_tpu_torch.ops.codebook import SmaQCodes

    seen = set()
    for path, leaf in _flatten_codes(ref_tree):
        if isinstance(leaf, JaxCodes):
            name, codes = _convert_leaf(path, np.asarray(leaf.codes))
            g = got[name]
            assert isinstance(g, SmaQCodes), name
            np.testing.assert_array_equal(g.codes.numpy(), codes.numpy().astype(np.uint8), name)
            # the stats to float32 summation order, as test_torch_codebook.py
            assert g.mean.shape == np.shape(leaf.mean), name
            np.testing.assert_allclose(g.mean.numpy(), np.asarray(leaf.mean), rtol=0,
                                       atol=1e-6 * np.asarray(leaf.std).max(), err_msg=name)
            np.testing.assert_allclose(g.std.numpy(), np.asarray(leaf.std), rtol=1e-6,
                                       err_msg=name)
        else:
            name, value = _convert_leaf(path, np.asarray(leaf))
            assert not isinstance(got[name], SmaQCodes), name
            np.testing.assert_array_equal(got[name].numpy(), value.numpy(), name)
        seen.add(name)
    assert seen == set(got)


def _flatten_codes(tree, prefix=()):
    """(path, leaf) of a flax-shaped tree whose leaves may be SmaQCodes."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_codes(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def deterministic_comps():
    from smart_quantization_tpu.compress import build_compressor as jax_build
    from smart_quantization_tpu.optim import compressed as jopt
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.optim.compressed import OptimizerCompression

    kw = dict(packed_momentum=True, packed_weights=True)
    return (jopt.OptimizerCompression(compressor=jax_build("smart", stochastic_rounding=False),
                                      **kw),
            OptimizerCompression(compressor=build_compressor("smart", stochastic_rounding=False),
                                 **kw))


def test_packed_fsdp_layout_matches_jax():
    """``encode_params`` and ``init_opt_state`` at ``fsdp_size=2``: codes,
    ``(2,)`` stats of the sharded leaves, ``(1,)`` of the replicated one;
    and each block of the global layout is what its shard encodes alone."""
    import jax

    from smart_quantization_tpu.optim import compressed as jopt
    from smart_quantization_tpu_torch.ops.codebook import smaq_encode
    from smart_quantization_tpu_torch.optim import compressed as topt
    from smart_quantization_tpu_torch.parallel.mesh import shard_dim

    jax_tree, port = packed_trees()
    jcomp, comp = deterministic_comps()
    ref = jopt.encode_params(jax_tree, jcomp, jax.random.key(0), fsdp_size=2)
    got = topt.encode_params(port, comp, fsdp_size=2)
    assert_packed_equal(got, jax.tree.map(np.asarray, ref))
    assert got["query.weight"].mean.shape == (2,) and got["odd.weight"].mean.shape == (1,)
    params = topt.packed_smaq_params(comp)
    for name, leaf in got.items():
        d = shard_dim(name, tuple(port[name].shape), 2)
        if d < 0:
            continue
        for i, block in enumerate(port[name].chunk(2, d)):
            own = smaq_encode(block.contiguous(), None, params)
            np.testing.assert_array_equal(own.codes.numpy(),
                                          leaf.codes.chunk(2, d)[i].numpy(), name)
            assert float(own.mean) == float(leaf.mean[i]) and float(own.std) == float(leaf.std[i])

    spec_j = jopt.build_optimizer("sgd", 0.1, momentum=0.9)
    ref_state = jopt.init_opt_state(spec_j, jax_tree, jcomp, fsdp_size=2)
    spec = topt.build_optimizer("sgd", 0.1, momentum=0.9)
    state = topt.init_opt_state(spec, port, comp, fsdp_size=2)
    assert_packed_equal(state["trace"], jax.tree.map(np.asarray, jax_trace(ref_state)))


@pytest.mark.parametrize("sizes", [(2, 1), (1, 2)], ids=["2to1", "1to2"])
def test_reshard_packed_state_matches_jax(sizes):
    import jax
    import jax.numpy as jnp

    from smart_quantization_tpu.optim import compressed as jopt
    from smart_quantization_tpu.train.state import TrainState
    from smart_quantization_tpu_torch.optim import compressed as topt

    old, new = sizes
    jax_tree, port = packed_trees(seed=4)
    jcomp, comp = deterministic_comps()
    old_j = None if old == 1 else old
    jparams = jopt.encode_params(jax_tree, jcomp, jax.random.key(0), fsdp_size=old_j)
    spec_j = jopt.build_optimizer("sgd", 0.1, momentum=0.9)
    jopt_state = jopt.init_opt_state(spec_j, jax_tree, jcomp, fsdp_size=old_j)
    ref = jopt.reshard_packed_state(TrainState(jnp.int32(0), jparams, {}, jopt_state),
                                    jax.random.key(1), jcomp, new)
    params = topt.encode_params(port, comp, fsdp_size=old)
    spec = topt.build_optimizer("sgd", 0.1, momentum=0.9)
    opt_state = topt.init_opt_state(spec, port, comp, fsdp_size=old)
    got_params, got_state = topt.reshard_packed_state(params, opt_state, None, comp, new)
    assert_packed_equal(got_params, jax.tree.map(np.asarray, ref.params))
    assert_packed_equal(got_state["trace"], jax.tree.map(np.asarray, jax_trace(ref.opt_state)))
