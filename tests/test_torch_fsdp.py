"""The fused FSDP step (``parallel/train_fsdp_q.py`` through the trainer)
against the JAX package's ``make_fsdp_q_train_step``, and its checkpoints.

The port's ranks are gloo processes that start once per module (a pool of
2 and one of 4); JAX runs ``shard_map`` on the conftest's virtual CPU
devices (``tests/test_torch_parallel.py`` has the shared helpers and the
rules).

- the step on a (1, 2) and a (2, 2) mesh with float32 exchanges, on
  TinyCNN with 5 classes (its fc weight shards on torch dim 1, flax's
  axis 0; its fc bias is replicated): the parameters and the SGD trace
  after 2 steps, by the flip rule, and every rank's gathered parameters
  bitwise equal;
- a checkpoint under FSDP with packed weights and momentum (int8
  exchanges, stochastic SmaQ): rank 0 writes the global layout with
  ``(fsdp,)`` stats; the same mesh restores its shards bitwise; one device
  restores it through ``reshard_packed_state``, its parameters within one
  grid step of the mesh's.
"""

import functools

import numpy as np
import pytest
import torch

from smart_quantization_tpu_torch.parallel.distributed import RankPool
from smart_quantization_tpu_torch.parallel.mesh import make_mesh
from test_torch_parallel import (
    _numpy,
    assert_flip_rule,
    batches,
    jax_setup,
    jax_steps,
    jax_trace,
    jax_tree_to_port,
    port_model,
    rank_steps,
)


@pytest.fixture(scope="module")
def pools():
    made = {2: RankPool(2, "cpu", timeout_s=120.0), 4: RankPool(4, "cpu", timeout_s=120.0)}
    yield made
    for pool in made.values():
        pool.close()


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_fsdp_step_matches_jax(pools, mesh_shape):
    steps = batches(2, seed=2, model="tiny")
    state_dict, ref, _ = jax_steps(mesh_shape, steps, fsdp_step=True, name="tiny")
    dp, fsdp = mesh_shape
    got = pools[dp * fsdp].run(rank_steps, dp, fsdp, "tiny", state_dict, steps, False)
    for r in got[1:]:
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, got[0]["params"][k], err_msg=k)
    assert_flip_rule(got[0]["params"], jax_tree_to_port(ref.params), "params")
    assert_flip_rule(got[0]["trace"], jax_tree_to_port(jax_trace(ref.opt_state)), "trace")


@functools.lru_cache(maxsize=None)
def _mesh(dp, fsdp):
    return make_mesh(dp, fsdp)


def packed_trainer(state_dict, mesh):
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )
    from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer

    model = port_model("tiny")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    comp = build_compressor("smart")
    return Trainer(model, None, build_optimizer("sgd", 0.1, momentum=0.9),
                   optim_comp=OptimizerCompression(compressor=comp, packed_momentum=True,
                                                   packed_weights=True),
                   config=TrainConfig(seed=5), device="cpu", mesh=mesh, grad_allreduce_bits=8,
                   param_gather_bits=8)


def rank_checkpoint(dp, fsdp, state_dict, steps, path):
    """A step or two under FSDP, a checkpoint, a restore on the same mesh;
    the shards before and after and the decoded global parameters."""
    mesh = _mesh(dp, fsdp)
    trainer = packed_trainer(state_dict, mesh)
    state = trainer.init_state()
    for x, y in steps:
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        trainer.train_step(state, trainer._rows(xt), trainer._rows(torch.from_numpy(y)))
    trainer.save_checkpoint(path, state)
    trainer._sync_model(state)
    params = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    back = packed_trainer(state_dict, mesh).load_checkpoint(path)
    return {"shards": _numpy(state.shards), "back": _numpy(back.shards),
            "mom": _numpy(state.opt_state["trace"]), "mom_back": _numpy(back.opt_state["trace"]),
            "step": back.step, "params": _numpy(params)}


def test_fsdp_checkpoint_round_trip_and_reshard(pools, tmp_path):
    _, _, state_dict = jax_setup("tiny")
    path = str(tmp_path / "fsdp.pt")
    got = pools[2].run(rank_checkpoint, 1, 2, state_dict, batches(2, seed=6, model="tiny"), path)
    ck = torch.load(path, weights_only=True)
    assert ck["fsdp_size"] == 2 and ck["step"] == 2
    packed = [v for v in ck["params"].values() if isinstance(v, dict)]
    assert packed and all(v["mean"].shape in ((2,), (1,)) for v in packed)
    assert any(v["mean"].shape == (2,) for v in packed)
    for r in got:
        assert r["step"] == 2
        for what, back in (("shards", "back"), ("mom", "mom_back")):
            for k, v in r[what].items():
                a = v if isinstance(v, dict) else {"x": v}
                b = r[back][k] if isinstance(v, dict) else {"x": r[back][k]}
                for f in a:
                    np.testing.assert_array_equal(a[f], b[f], err_msg=f"{what} {k} {f}")
    for k, v in got[0]["params"].items():
        np.testing.assert_array_equal(got[1]["params"][k], v, err_msg=k)

    one = packed_trainer(state_dict, None)
    state = one.load_checkpoint(path)
    assert state.step == 2 and all(
        np.shape(c.mean) == () for c in state.packed_params.values() if hasattr(c, "codes"))
    for k, p in one.model.named_parameters():
        ref = got[0]["params"][k]
        step = np.std(ref) / 15 + 1e-6  # a main-bucket quantum of the leaf
        assert np.abs(p.detach().numpy() - ref).max() <= 2 * step, k
