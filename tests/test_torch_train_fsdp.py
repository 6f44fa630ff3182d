"""The whole-batch FSDP step (``parallel/train_fsdp.py``) against the port's
single-device step on the whole global batch (``Trainer.train_step``) and
against the JAX package's ``make_fsdp_train_step``, and the whole-batch
statistics under it (``parallel/whole_batch.py``).

The port's ranks are gloo processes that start once per module (a pool of
2 and one of 4); JAX runs its jitted step over a dp=4, fsdp=2 mesh of the
conftest's virtual CPU devices with ``use_pallas=False``, as
``tests/test_train_parallel.py::test_fsdp_train_step`` runs it.  The
helpers and the rules are ``tests/test_torch_parallel.py``'s.  TinyCNN (5
classes: its fc weight shards on torch dim 1 at fsdp 2, its fc bias is
replicated) with SmaQ 6/8 in truncation on every structure, a global batch
of 8 unaugmented 8 x 8 images (JAX's augmentation and the port's are
replaced by the identity for the comparison), 2 steps:

- SGD momentum 0.9 on a (2, 2), a (1, 2) and a (2, 1) mesh (its
  optimizer one call on every leaf, as the trainer's), and AdamW on
  (2, 2) (and the float32 master weights on (1, 2) against one device):
  the parameters, the optimizer state and the BatchNorm running
  statistics of the mesh against the single-device step and against JAX,
  within 1e-5 of each leaf's scale but for elements a truncation flip
  moved (at most 1 %, none more than one main-bucket quantum: NCHW, NHWC
  and rank order sum the statistics in other orders), every rank's
  gathered state bitwise equal, and the loss to 1e-5;
- rows of very different scale on each of 4 ranks: a tap's output (SmaQ,
  and S2FP8) and a BatchNorm's output on the mesh equal the single
  device's on the whole tensor, where each rank's own statistics would not;
- a tensor below ``min_size`` on each rank but not in all is quantized;
- ``state_shardings`` shards on the JAX layout's axis;
- packed state and sampled statistics raise ``WholeBatchError``.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from smart_quantization_tpu_torch.parallel.distributed import RankPool
from smart_quantization_tpu_torch.parallel.mesh import make_mesh
from test_torch_parallel import _numpy, jax_setup, jax_tree_to_port

BATCH = 8
CLASSES = 5
KEY = 11
OPTIMIZERS = {"sgd": dict(learning_rate=0.1, momentum=0.9, weight_decay=5e-4),
              "adamw": dict(learning_rate=1e-3, weight_decay=0.01)}


@pytest.fixture(scope="module")
def pools():
    made = {2: RankPool(2, "cpu", timeout_s=120.0), 4: RankPool(4, "cpu", timeout_s=120.0)}
    yield made
    for pool in made.values():
        pool.close()


@functools.lru_cache(maxsize=None)
def tiny_setup():
    """``jax_setup("tiny")``'s variables with a BatchNorm scale and bias
    away from flax's 1 and 0 (``tests/test_torch_tiny.py``'s): with a zero
    bias the BatchNorm output's mean is float noise, the truncation tap
    puts its zero bucket on that mean, and ReLU's mask of the whole bucket
    follows the noise's sign, on one device as in JAX.  Returns JAX's
    variables and the port's state dict."""
    import copy

    from smart_quantization_tpu_torch.convert import params_from_jax

    _, variables, _ = jax_setup("tiny")
    variables = copy.deepcopy(variables)
    r = np.random.RandomState(7)
    bn = variables["params"]["bn1"]["bn"]
    bn["scale"] = (1 + 0.1 * r.randn(*bn["scale"].shape)).astype(np.float32)
    bn["bias"] = (0.1 * r.randn(*bn["bias"].shape)).astype(np.float32)
    state_dict = {k: v.numpy() for k, v in
                  params_from_jax(variables["params"], variables["batch_stats"]).items()}
    return variables, state_dict


def batches(n, seed=3):
    r = np.random.RandomState(seed)
    return [(r.randint(0, 256, (BATCH, 8, 8, 3)).astype(np.uint8),
             r.randint(0, CLASSES, BATCH).astype(np.int32)) for _ in range(n)]


# ------------------------------------------------------------- the port
@functools.lru_cache(maxsize=None)
def _mesh(dp, fsdp):
    return make_mesh(dp, fsdp)


@contextlib.contextmanager
def _unaugmented():
    """The port's augmentation replaced by the identity (the batch as the
    model takes it: normalized, NCHW)."""
    from smart_quantization_tpu_torch.data import cifar

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cifar, "augment", lambda images_u8, gen: images_u8)
        yield


def _port_build(state_dict, optimizer, master):
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.inject.tap import TapConfig
    from smart_quantization_tpu_torch.models.tiny import TinyCNN
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )

    comp = build_compressor("smart", stochastic_rounding=False)
    model = TinyCNN(num_classes=CLASSES, tap=TapConfig(compressor=comp))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return (model, build_optimizer(optimizer, **OPTIMIZERS[optimizer]),
            OptimizerCompression(compressor=comp, use_weight_accumulator=master))


def _port_result(metrics, params, opt, model, master):
    if master:
        opt = {**opt.inner, "master": opt.master}
    return {"metrics": _numpy(metrics), "params": _numpy(params),
            "opt": {k: _numpy(v) for k, v in opt.items() if k != "count"},
            "buffers": _numpy(dict(model.named_buffers()))}


def port_steps(mesh_shape, state_dict, steps, optimizer, master=False):
    """The port's whole-batch step, ``len(steps)`` times, on a mesh of
    ``mesh_shape``, with float32 master weights if ``master``; the last
    metrics and the global parameters, optimizer state (its buffers, and
    the master weights as ``master``) and BatchNorm statistics."""
    from smart_quantization_tpu_torch.parallel.train_fsdp import make_fsdp_train_step

    model, spec, optim_comp = _port_build(state_dict, optimizer, master)
    step = make_fsdp_train_step(model, spec, optim_comp, _mesh(*mesh_shape))
    state = step.init_state()
    with _unaugmented():
        for x, y in steps:
            metrics = step(state, torch.from_numpy(x), torch.from_numpy(y), KEY)
    return _port_result(metrics, step.global_params(state), step.global_opt_state(state),
                        model, master)


def trainer_steps(state_dict, steps, optimizer, master=False):
    """The port's single-device step (``Trainer.train_step``) on the same
    global batches, the input ``global_inputs`` gives; ``port_steps``'
    result."""
    from smart_quantization_tpu_torch.parallel.train_fsdp import global_inputs
    from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer

    model, spec, optim_comp = _port_build(state_dict, optimizer, master)
    trainer = Trainer(model, None, spec, optim_comp=optim_comp, device="cpu",
                      config=TrainConfig(measure_compression_ratio=True))
    state = trainer.init_state()
    with _unaugmented():
        for x, y in steps:
            metrics = trainer.train_step(state, global_inputs(torch.from_numpy(x), KEY),
                                         torch.from_numpy(y).long())
    params = {n: p.detach() for n, p in model.named_parameters()}
    return _port_result(metrics, params, state.opt_state, model, master)


# ---------------------------------------------------------- JAX's side
@functools.lru_cache(maxsize=None)
def jax_whole_batch(optimizer):
    """JAX's ``make_fsdp_train_step`` (dp=4, fsdp=2) on ``batches(2)``,
    its augmentation replaced by the identity: the parameters, the
    optimizer's buffers and the batch statistics in the port's names."""
    import types

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from smart_quantization_tpu.compress import build_compressor
    from smart_quantization_tpu.data import cifar as jcifar
    from smart_quantization_tpu.inject.tap import TapConfig
    from smart_quantization_tpu.models.tiny import TinyCNN
    from smart_quantization_tpu.optim import compressed as jopt
    from smart_quantization_tpu.parallel import train_fsdp as jfsdp
    from smart_quantization_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from smart_quantization_tpu.train.state import TrainState

    variables, _ = tiny_setup()
    comp = build_compressor("smart", use_pallas=False, stochastic_rounding=False)
    model = TinyCNN(num_classes=CLASSES, tap=TapConfig(compressor=comp))
    kw = dict(OPTIMIZERS[optimizer])
    spec = jopt.build_optimizer(optimizer, kw.pop("learning_rate"), **kw)
    mesh = jax_make_mesh(dp=4, fsdp=2, devices=jax.devices()[:8])
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(jnp.int32(0), params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       spec.tx.init(params))
    state = jfsdp.place_state(mesh, state)
    rows = NamedSharding(mesh, P("data"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfsdp, "cifar_data",
                   types.SimpleNamespace(augment=lambda x, key: x, normalize=jcifar.normalize))
        step = jfsdp.make_fsdp_train_step(model, spec, jopt.OptimizerCompression(compressor=comp),
                                          mesh)(state)
        for x, y in batches(2):
            state, metrics = step(state, jax.device_put(jnp.asarray(x), rows),
                                  jax.device_put(jnp.asarray(y), rows), jax.random.key(KEY))
    state = jax.tree.map(np.asarray, state)
    opt = {}
    for s in state.opt_state:
        for name in ("trace", "mu", "nu"):
            if hasattr(s, name):
                opt[name] = jax_tree_to_port(getattr(s, name))
    return {"loss": float(metrics["train_loss"]), "params": jax_tree_to_port(state.params),
            "opt": opt, "buffers": jax_tree_to_port(state.batch_stats)}


# ---------------------------------------------------------------- rules
def assert_close_or_flipped(got: dict, ref: dict, what: str, rtol=1e-5):
    """Each leaf within ``rtol`` of its largest value, but for elements a
    truncation flip moved: at most 1 % of a leaf, none more than one
    main-bucket quantum (the leaf's std / 15) apart."""
    assert set(got) == set(ref), what
    for name, b in ref.items():
        a = np.asarray(got[name], np.float64)
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape and np.isfinite(a).all(), (what, name)
        diff = np.abs(a - b)
        wiggle = rtol * np.abs(b).max() + 1e-9
        assert (diff > wiggle).mean() <= 0.01, (what, name, diff.max())
        assert diff.max() <= np.std(b) / 15 * (1 + 1e-4) + wiggle, (what, name, diff.max())


CASES = [("sgd", (2, 2)), ("sgd", (1, 2)), ("sgd", (2, 1)), ("adamw", (2, 2))]


@pytest.mark.parametrize("optimizer,mesh_shape", CASES,
                         ids=["sgd-2x2", "sgd-1x2", "sgd-2x1", "adamw-2x2"])
def test_mesh_step_is_the_single_device_step_and_jax(pools, optimizer, mesh_shape):
    _, state_dict = tiny_setup()
    steps = batches(2)
    got = pools[mesh_shape[0] * mesh_shape[1]].run(port_steps, mesh_shape, state_dict, steps,
                                                   optimizer)
    for r in got[1:]:  # every rank holds the same state
        for what in ("params", "buffers"):
            for k, v in r[what].items():
                np.testing.assert_array_equal(v, got[0][what][k], err_msg=f"{what} {k}")
        for b, tree in r["opt"].items():
            for k, v in tree.items():
                np.testing.assert_array_equal(v, got[0]["opt"][b][k], err_msg=f"{b} {k}")
    one = trainer_steps(state_dict, steps, optimizer)
    ref = jax_whole_batch(optimizer)
    mesh = got[0]
    assert set(mesh["opt"]) == set(ref["opt"]) == set(one["opt"])
    for other, name in ((one, "single device"), (ref, "JAX")):
        assert_close_or_flipped(mesh["params"], other["params"], f"params vs {name}")
        for b in ref["opt"]:
            assert_close_or_flipped(mesh["opt"][b], other["opt"][b], f"{b} vs {name}")
        buffers = {k: v for k, v in other["buffers"].items() if not k.endswith("batches_tracked")}
        assert_close_or_flipped({k: mesh["buffers"][k] for k in buffers}, buffers,
                                f"BatchNorm statistics vs {name}")
    loss = float(mesh["metrics"]["train_loss"])
    assert loss == pytest.approx(float(one["metrics"]["train_loss"]), rel=1e-5)
    assert loss == pytest.approx(ref["loss"], rel=1e-5)
    # the taps' sizes are the whole tensors': the original bits of the batch
    for tag in ("forward_autograd", "backward_autograd"):
        np.testing.assert_array_equal(mesh["metrics"][f"_ratio/{tag}"][0],
                                      one["metrics"][f"_ratio/{tag}"][0])


def test_master_weights_on_the_mesh(pools):
    """``use_weight_accumulator``: the float32 master weights are gathered
    whole a leaf at a time and stored as blocks like the momentum; the
    (1, 2) mesh's after 2 steps are the single device's (the trainer's)."""
    _, state_dict = tiny_setup()
    steps = batches(2)
    got = pools[2].run(port_steps, (1, 2), state_dict, steps, "sgd", True)
    one = trainer_steps(state_dict, steps, "sgd", True)
    assert set(got[0]["opt"]) == {"trace", "master"}
    for b in ("trace", "master"):
        np.testing.assert_array_equal(got[0]["opt"][b]["fc.weight"], got[1]["opt"][b]["fc.weight"])
        assert_close_or_flipped(got[0]["opt"][b], one["opt"][b], b)
    assert_close_or_flipped(got[0]["params"], one["params"], "params")


# ---------------------------------------------- statistics of the batch
def _scaled_rows(seed=5):
    """A (8, 4, 3, 3) map whose rows r*2, r*2+1 (rank r's of 4) are scaled
    by 10^r and shifted by 3r: each rank's own statistics are far from the
    whole tensor's."""
    r = np.random.RandomState(seed)
    x = r.randn(8, 4, 3, 3).astype(np.float32)
    scale = np.repeat(10.0 ** np.arange(4), 2).astype(np.float32)[:, None, None, None]
    shift = np.repeat(3.0 * np.arange(4), 2).astype(np.float32)[:, None, None, None]
    return x * scale + shift


def rank_whole_batch_stats(x):
    """On each rank of a 4-rank world: SmaQ (truncation) of its rows of
    ``x`` with the whole tensor's statistics and with its own, the
    training BatchNorm of its rows (output, input gradient, running
    statistics), and SmaQ of a 4-element tensor (the world's 16 reach
    ``min_size`` 8)."""
    import torch.distributed as dist

    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.models.resnet import TappedBatchNorm
    from smart_quantization_tpu_torch.parallel.whole_batch import StatsGroup

    world = dist.get_world_size()
    rank = dist.get_rank()
    group = StatsGroup(dist.group.WORLD, world)
    comp = build_compressor("smart", stochastic_rounding=False)
    rows = torch.from_numpy(x).chunk(world)[rank].contiguous()
    gen = torch.Generator().manual_seed(0)
    whole, sizes = group.compress(comp, rows, gen)
    own, _ = comp(rows, gen)
    bn = TappedBatchNorm(4, None)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 2.0, 4))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, 4))
    xin = rows.clone().requires_grad_()
    y = group.batch_norm(bn, xin)
    (y * torch.arange(y.numel(), dtype=torch.float32).view_as(y)).sum().backward()
    tiny = torch.arange(4, dtype=torch.float32) + 4 * rank
    tiny_whole, _ = group.compress(comp, tiny, gen)
    tiny_own, _ = comp(tiny, gen)
    s2fp8 = build_compressor("s2fp8", stochastic=False)
    s2_whole, _ = group.compress(s2fp8, rows, gen)
    s2_own, _ = s2fp8(rows, gen)
    return {"whole": whole.numpy(), "own": own.numpy(), "size": sizes.new_bits.numpy(),
            "s2fp8": s2_whole.numpy(), "s2fp8_own": s2_own.numpy(),
            "bn": y.detach().numpy(), "bn_grad": xin.grad.numpy(),
            "running": np.stack([bn.running_mean.numpy(), bn.running_var.numpy()]),
            "tiny": tiny.numpy(), "tiny_whole": tiny_whole.numpy(),
            "tiny_own": tiny_own.numpy()}


def test_statistics_cover_the_whole_batch(pools):
    """Rows of very different scale on each of 4 ranks: the mesh's tap
    output and BatchNorm output (and its input gradient and running
    statistics) equal the single device's on the whole tensor; each rank's
    own statistics give another tap output and another normalization."""
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.models.resnet import TappedBatchNorm
    from smart_quantization_tpu_torch.parallel.whole_batch import StatsGroup

    x = _scaled_rows()
    got = pools[4].run(rank_whole_batch_stats, x)
    comp = build_compressor("smart", stochastic_rounding=False)
    want, want_size = comp(torch.from_numpy(x), torch.Generator().manual_seed(0))
    mesh = np.concatenate([r["whole"] for r in got])
    own = np.concatenate([r["own"] for r in got])
    quantum = float(np.std(x)) / 15
    diff = np.abs(mesh - want.numpy())
    assert (diff > 1e-5 * np.abs(x).max()).mean() <= 0.01 and diff.max() <= quantum * 1.001
    assert sum(float(r["size"]) for r in got) == float(want_size.new_bits)
    # each rank's own statistics: most elements land elsewhere
    assert (np.abs(own - want.numpy()) > 1e-5 * np.abs(x).max()).mean() > 0.5

    bn = TappedBatchNorm(4, None)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 2.0, 4))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, 4))
    with torch.no_grad():
        y = StatsGroup().batch_norm(bn, torch.from_numpy(x))
    np.testing.assert_allclose(np.concatenate([r["bn"] for r in got]), y.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for r in got:
        np.testing.assert_allclose(r["running"], np.stack([bn.running_mean.numpy(),
                                                           bn.running_var.numpy()]), rtol=1e-6)
    plain = torch.nn.functional.batch_norm(torch.from_numpy(x), None, None, bn.weight.detach(),
                                           bn.bias.detach(), True, 0.0, bn.eps)
    np.testing.assert_allclose(y.detach().numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    per_rank = np.concatenate([torch.nn.functional.batch_norm(
        torch.from_numpy(c), None, None, bn.weight.detach(), bn.bias.detach(), True, 0.0,
        bn.eps).numpy() for c in np.split(x, 4)])
    assert np.abs(per_rank - plain.numpy()).max() > 0.1  # per-rank stats: another output

    # S2FP8 (nearest): the whole tensor's mean and max of log2|x|, one
    # e5m2 step at most from one device's (the float64 sum's order)
    s2fp8 = build_compressor("s2fp8", stochastic=False)
    want_s2, _ = s2fp8(torch.from_numpy(x), torch.Generator().manual_seed(0))
    mesh_s2 = np.concatenate([r["s2fp8"] for r in got])
    np.testing.assert_allclose(mesh_s2, want_s2.numpy(), rtol=2.0 ** -2, atol=0)
    assert (mesh_s2 == want_s2.numpy()).mean() >= 0.99
    own_s2 = np.concatenate([r["s2fp8_own"] for r in got])
    assert (own_s2 != want_s2.numpy()).mean() > 0.5  # per-rank stats: another squeeze

    for r in got:  # 4 elements a rank, below min_size 8; 16 in all
        np.testing.assert_array_equal(r["tiny_own"], r["tiny"])
    tiny_all = np.concatenate([r["tiny"] for r in got])
    want_tiny, _ = comp(torch.from_numpy(tiny_all), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(np.concatenate([r["tiny_whole"] for r in got]),
                               want_tiny.numpy(), rtol=1e-6)
    assert (want_tiny.numpy() != tiny_all).any()


def test_bn_backward_is_the_whole_batch_gradient(pools):
    """The gradient through the mesh's BatchNorm (its sums all-reduced
    backward) is the single device's on the whole batch, row for row."""
    x = _scaled_rows()
    got = pools[4].run(rank_whole_batch_stats, x)
    xin = torch.from_numpy(x).requires_grad_()
    from smart_quantization_tpu_torch.models.resnet import TappedBatchNorm

    bn = TappedBatchNorm(4, None)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 2.0, 4))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, 4))
    y = torch.nn.functional.batch_norm(xin, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    # each rank weighted its own rows by arange over their elements
    w = np.concatenate([np.arange(2 * 4 * 3 * 3, dtype=np.float32).reshape(2, 4, 3, 3)] * 4)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(np.concatenate([r["bn_grad"] for r in got]), xin.grad.numpy(),
                               rtol=1e-4, atol=1e-4 * float(xin.grad.abs().max()))


class _Sizes:
    """A mesh's sizes alone."""

    def __init__(self, data, fsdp):
        self.shape = {"data": data, "fsdp": fsdp}


def test_state_shardings_take_the_jax_layout():
    """JAX's ``state_shardings`` on TinyCNN at fsdp 2: the fc weight on
    flax's axis 0 (torch dim 1), its 5-element bias replicated, the
    BatchNorm leaves sharded (16 channels)."""
    from smart_quantization_tpu_torch.models.tiny import TinyCNN
    from smart_quantization_tpu_torch.parallel.train_fsdp import state_shardings

    dims = state_shardings(_Sizes(2, 2), TinyCNN(num_classes=CLASSES))
    assert dims == {"conv1.weight": 0, "bn1.weight": 0, "bn1.bias": 0, "conv2.weight": 0,
                    "fc.weight": 1, "fc.bias": -1}
    assert set(state_shardings(_Sizes(1, 1), TinyCNN()).values()) == {-1}


def test_packed_state_and_sampled_stats_raise():
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.models.tiny import TinyCNN
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )
    from smart_quantization_tpu_torch.parallel.train_fsdp import make_fsdp_train_step
    from smart_quantization_tpu_torch.parallel.whole_batch import StatsGroup, WholeBatchError

    comp = build_compressor("smart")
    with pytest.raises(WholeBatchError, match="packed state"):
        make_fsdp_train_step(TinyCNN(), build_optimizer("sgd"),
                             OptimizerCompression(compressor=comp, packed_momentum=True),
                             _Sizes(1, 1))
    with pytest.raises(ValueError, match="make_mesh"):
        make_fsdp_train_step(TinyCNN(), build_optimizer("sgd"),
                             OptimizerCompression(compressor=comp), None)
    sampled = build_compressor("smart", use_sample_stats=True)
    with pytest.raises(WholeBatchError, match="use_sample_stats"):
        StatsGroup().compress(sampled, torch.randn(64), torch.Generator().manual_seed(0))
