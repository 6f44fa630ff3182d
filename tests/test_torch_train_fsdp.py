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
- ``state_shardings`` shards on the JAX layout's axis; no mesh raises;
- random draws as one device's: a stochastic step (SmaQ 6/8 stochastic on
  every structure) on a (2, 2), a (1, 2) and a (2, 1) mesh, and with
  ``--use_sample_stats`` (64 samples) on a (2, 2) mesh, against the (1, 1)
  step with the same key by the same rule, ranks bitwise equal
  (JAX's step, whose draws do not depend on the mesh either, agrees with
  itself across meshes to about 1e-5 with sampled statistics); the plain
  versions of the quantize functions on a tensor cut into parts, each at
  its element offset (``ops/keys.py::PartKey``), bitwise the whole
  tensor's call under the same statistics, from a host generator and
  from a step key; the sampled statistics of ``StatsGroup.compress`` on 4
  ranks bitwise one device's on the whole tensor, a sample element on a
  rank boundary;
- packed state (``--packed_momentum --packed_weights``) in truncation on a
  (2, 2) and a (1, 2) mesh against ``Trainer.train_step`` with packed
  state, and packed momentum against JAX's step too, decoded values by
  the same rule.
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
SAMPLES = 64  # --num_samples of the sampled-statistics cases
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


def _port_build(state_dict, optimizer, master, stochastic=False, packed=False, sample=False):
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.inject.tap import TapConfig
    from smart_quantization_tpu_torch.models.tiny import TinyCNN
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )

    comp = build_compressor("smart", stochastic_rounding=stochastic, use_sample_stats=sample,
                            num_samples=SAMPLES)
    model = TinyCNN(num_classes=CLASSES, tap=TapConfig(compressor=comp))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    return (model, build_optimizer(optimizer, **OPTIMIZERS[optimizer]),
            OptimizerCompression(compressor=comp, use_weight_accumulator=master,
                                 packed_momentum=packed in ("momentum", "both"),
                                 packed_weights=packed == "both"))


def _port_result(metrics, params, opt, model, master, spec, optim_comp):
    """The step's results as numpy, packed leaves decoded."""
    from smart_quantization_tpu_torch.optim.compressed import (
        _decode_tree,
        decode_params,
        packed_smaq_params,
    )

    if master:
        opt = {**opt.inner, "master": opt.master}
    if optim_comp.packed_momentum:
        p = packed_smaq_params(optim_comp)
        opt = {**opt, **{b: _decode_tree(opt[b], p, ap) for b, ap in spec.momentum_buffers}}
    return {"metrics": _numpy(metrics), "params": _numpy(decode_params(params, optim_comp)),
            "opt": {k: _numpy(v) for k, v in opt.items() if k != "count"},
            "buffers": _numpy(dict(model.named_buffers()))}


def port_steps(mesh_shape, state_dict, steps, optimizer, master=False, stochastic=False,
               packed=False, sample=False):
    """The port's whole-batch step, ``len(steps)`` times, on a mesh of
    ``mesh_shape`` ((1, 1): one device, no process group), with float32
    master weights if ``master``, stochastic rounding if ``stochastic``,
    ``packed`` state ("momentum", or "both" with the weights) and sampled
    statistics (``--use_sample_stats``) if ``sample``; the last
    metrics and the global parameters, optimizer state (its buffers, and
    the master weights as ``master``) and BatchNorm statistics."""
    from smart_quantization_tpu_torch.parallel.train_fsdp import make_fsdp_train_step

    model, spec, optim_comp = _port_build(state_dict, optimizer, master, stochastic, packed,
                                          sample)
    step = make_fsdp_train_step(model, spec, optim_comp, _mesh(*mesh_shape))
    state = step.init_state()
    with _unaugmented():
        for x, y in steps:
            metrics = step(state, torch.from_numpy(x), torch.from_numpy(y), KEY)
    return _port_result(metrics, step.global_params(state), step.global_opt_state(state),
                        model, master, spec, optim_comp)


def trainer_steps(state_dict, steps, optimizer, master=False, packed=False):
    """The port's single-device step (``Trainer.train_step``) on the same
    global batches, the input ``global_inputs`` gives; ``port_steps``'
    result."""
    from smart_quantization_tpu_torch.parallel.train_fsdp import global_inputs
    from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer

    model, spec, optim_comp = _port_build(state_dict, optimizer, master, packed=packed)
    trainer = Trainer(model, None, spec, optim_comp=optim_comp, device="cpu",
                      config=TrainConfig(measure_compression_ratio=True))
    state = trainer.init_state()
    with _unaugmented():
        for x, y in steps:
            metrics = trainer.train_step(state, global_inputs(torch.from_numpy(x), KEY),
                                         torch.from_numpy(y).long())
    params = state.packed_params or {n: p.detach() for n, p in model.named_parameters()}
    return _port_result(metrics, params, state.opt_state, model, master, spec, optim_comp)


# ---------------------------------------------------------- JAX's side
@functools.lru_cache(maxsize=None)
def jax_whole_batch(optimizer, packed_momentum=False):
    """JAX's ``make_fsdp_train_step`` (dp=4, fsdp=2) on ``batches(2)``,
    its augmentation replaced by the identity: the parameters, the
    optimizer's buffers (packed momentum decoded) and the batch statistics
    in the port's names."""
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
    optim_comp = jopt.OptimizerCompression(compressor=comp, packed_momentum=packed_momentum)
    state = TrainState(jnp.int32(0), params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       jopt.init_opt_state(spec, params, optim_comp))
    state = jfsdp.place_state(mesh, state)
    rows = NamedSharding(mesh, P("data"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfsdp, "cifar_data",
                   types.SimpleNamespace(augment=lambda x, key: x, normalize=jcifar.normalize))
        step = jfsdp.make_fsdp_train_step(model, spec, optim_comp, mesh)(state)
        for x, y in batches(2):
            state, metrics = step(state, jax.device_put(jnp.asarray(x), rows),
                                  jax.device_put(jnp.asarray(y), rows), jax.random.key(KEY))
    opt = {}
    for s in state.opt_state:
        for name in ("trace", "mu", "nu"):
            if hasattr(s, name):
                tree = getattr(s, name)
                if packed_momentum:
                    tree = jopt._decode_tree(tree, jopt.packed_smaq_params(optim_comp),
                                             name == "nu")
                opt[name] = jax_tree_to_port(jax.tree.map(np.asarray, tree))
    state = jax.tree.map(np.asarray, state)
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


def test_no_mesh_raises():
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.models.tiny import TinyCNN
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )
    from smart_quantization_tpu_torch.parallel.train_fsdp import make_fsdp_train_step

    with pytest.raises(ValueError, match="make_mesh"):
        make_fsdp_train_step(TinyCNN(), build_optimizer("sgd"),
                             OptimizerCompression(compressor=build_compressor("smart")), None)
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2, 1)  # no process group in this process


def _assert_ranks_equal(got):
    """Every rank's gathered state bitwise equal to rank 0's."""
    for r in got[1:]:
        for what in ("params", "buffers"):
            for k, v in r[what].items():
                np.testing.assert_array_equal(v, got[0][what][k], err_msg=f"{what} {k}")
        for b, tree in r["opt"].items():
            for k, v in tree.items():
                np.testing.assert_array_equal(v, got[0]["opt"][b][k], err_msg=f"{b} {k}")


def _assert_steps_agree(mesh, other, name, rtol=1e-5):
    """The flip rule on the parameters, the optimizer's buffers and the
    BatchNorm statistics; the loss within ``rtol``."""
    assert set(mesh["opt"]) == set(other["opt"]), name
    assert_close_or_flipped(mesh["params"], other["params"], f"params vs {name}")
    for b in other["opt"]:
        assert_close_or_flipped(mesh["opt"][b], other["opt"][b], f"{b} vs {name}")
    buffers = {k: v for k, v in other["buffers"].items() if not k.endswith("batches_tracked")}
    assert_close_or_flipped({k: mesh["buffers"][k] for k in buffers}, buffers,
                            f"BatchNorm statistics vs {name}")
    loss = float(mesh["metrics"]["train_loss"])
    assert loss == pytest.approx(float(other["metrics"]["train_loss"]), rel=rtol), name


# ------------------------------------------------- one device's draws
@functools.lru_cache(maxsize=None)
def one_device_stochastic(optimizer, sample=False):
    """The (1, 1) whole-batch step, stochastic, in this process."""
    _, state_dict = tiny_setup()
    return port_steps((1, 1), state_dict, batches(2), optimizer, stochastic=True, sample=sample)


@pytest.mark.parametrize("mesh_shape,sample", [((2, 2), False), ((1, 2), False), ((2, 1), False),
                                               ((2, 2), True)],
                         ids=["2x2", "1x2", "2x1", "2x2-sampled"])
def test_stochastic_mesh_step_draws_as_one_device(pools, mesh_shape, sample):
    """SmaQ 6/8 with stochastic rounding on every structure, with full or
    sampled statistics (``--use_sample_stats``, 64 samples): the mesh's
    step is the (1, 1) step with the same key, by the flip rule, and every
    rank holds the same state.  The taps' calls on a rank's rows take their
    noise at the rows' offset in the whole tensor, and under sampled
    statistics the whole tensor's sample; the optimizer's calls on one
    leaf take the whole tree's keys for it."""
    _, state_dict = tiny_setup()
    got = pools[mesh_shape[0] * mesh_shape[1]].run(port_steps, mesh_shape, state_dict,
                                                   batches(2), "sgd", False, True, False, sample)
    _assert_ranks_equal(got)
    one = one_device_stochastic("sgd", sample)
    _assert_steps_agree(got[0], one, "the (1, 1) step")
    for tag in ("forward_autograd", "backward_autograd"):
        np.testing.assert_array_equal(got[0]["metrics"][f"_ratio/{tag}"][0],
                                      one["metrics"][f"_ratio/{tag}"][0])


PART_SIZES = (37, 64, 9, 90)  # 200 elements; offsets 0, 37, 101, 110
BN_ROWS = (1, 3, 2, 2)  # of an (8, 3, 5, 5) map: offsets 0, 75, 300, 450
KEYS = ("host generator", "step key")


def _fresh_key(kind, seed=5):
    from smart_quantization_tpu_torch.ops.keys import DeviceKey, key_tensor, step_key

    if kind == "host generator":
        return torch.Generator().manual_seed(seed)
    return DeviceKey(key_tensor(step_key(0, seed), "cpu"))


def _quantize_fns():
    """name -> (x, fn(x, key) -> (y, size or None)), the statistics given."""
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.s2fp8 import log2_stats

    r = np.random.RandomState(2)
    flat = torch.from_numpy((r.randn(200) * 1.3 + 0.2).astype(np.float32))
    nchw = torch.from_numpy((r.randn(8, 3, 5, 5) * 0.7 - 0.1).astype(np.float32))
    gamma = torch.from_numpy((1 + 0.2 * r.randn(3)).astype(np.float32))
    beta = torch.from_numpy((0.1 * r.randn(3)).astype(np.float32))
    smaq = build_compressor("smart")
    bn = build_compressor("smart", use_batch_norm=True)
    m_flat, s_flat = flat.mean(), flat.std()
    m_bn, s_bn = nchw.mean(), nchw.std()
    a = flat.abs()
    lg = log2_stats(torch.where(a == 0, a, torch.log2(a)))
    def bits(out):
        return out[0], out[1].new_bits

    return {
        "smaq": (flat, lambda x, k: bits(smaq(x, k, mean=m_flat, std=s_flat))),
        "smaq kernels' plain version": (flat, lambda x, k: K.smaq_fused_reference(
            x, k, smaq.params, mean=m_flat, std=s_flat)),
        "bn": (nchw, lambda x, k: bits(bn(x, k, gamma=gamma, beta=beta, mean=m_bn, std=s_bn))),
        "bn kernel's plain version": (nchw, lambda x, k: K.smaq_fused_bn_reference(
            x, k, gamma, beta, bn.params, mean=m_bn, std=s_bn)),
        "fp8": (flat, lambda x, k: (build_compressor("fp8")(x, k)[0], None)),
        "bf16": (flat, lambda x, k: (build_compressor("bf16")(x, k)[0], None)),
        "s2fp8": (flat, lambda x, k: (build_compressor("s2fp8")(x, k, log2_stats=lg)[0], None)),
    }


@pytest.mark.parametrize("key_kind", KEYS)
@pytest.mark.parametrize("name", ["smaq", "smaq kernels' plain version", "bn",
                                  "bn kernel's plain version", "fp8", "bf16", "s2fp8"])
def test_parts_at_their_offsets_are_the_whole_call(name, key_kind):
    """A tensor cut into 4 parts (offsets not all multiples of 4), each
    quantized stochastically at its element offset under the whole
    tensor's statistics, is bitwise the whole tensor's call with the same
    key, and its sizes add up to the whole's."""
    from smart_quantization_tpu_torch.ops.keys import PartKey

    x, fn = _quantize_fns()[name]
    whole, size = fn(x, _fresh_key(key_kind))
    if x.dim() == 4:
        parts = torch.split(x, BN_ROWS)
    else:
        parts = torch.split(x, PART_SIZES)
    outs, sizes, at = [], [], 0
    for part in parts:
        y, s = fn(part.contiguous(), PartKey(_fresh_key(key_kind), at, x.numel()))
        outs.append(y)
        sizes.append(s)
        at += part.numel()
    assert any(p.numel() % 4 for p in parts[:-1])
    np.testing.assert_array_equal(torch.cat(outs).numpy(), whole.numpy())
    assert not torch.equal(whole, x)
    if size is not None:
        assert float(sum(float(s) for s in sizes)) == float(size)
    assert not torch.equal(fn(x, _fresh_key(key_kind, 6))[0], whole)  # another key


def rank_sampled_stats(x, key_kind, seed, num_samples):
    """On each rank of a 4-rank world: the sampled statistics of its rows of
    ``x`` over the world (``StatsGroup.sample``) and ``StatsGroup.compress``
    of them (SmaQ 6/8 stochastic, sampled statistics), with the key
    ``seed`` gives."""
    import torch.distributed as dist

    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.parallel.whole_batch import StatsGroup

    world, rank = dist.get_world_size(), dist.get_rank()
    group = StatsGroup(dist.group.WORLD, world, rank)
    comp = build_compressor("smart", use_sample_stats=True, num_samples=num_samples)
    rows = torch.from_numpy(x).chunk(world)[rank].contiguous()
    mean, std = group.sample(rows, comp.params, _seeded_key(key_kind, seed))
    y, sizes = group.compress(comp, rows, _seeded_key(key_kind, seed))
    return {"stats": torch.stack([mean, std]).numpy(), "y": y.numpy(),
            "size": sizes.new_bits.numpy()}


def _seeded_key(kind, seed):
    from smart_quantization_tpu_torch.ops.keys import DeviceKey, key_tensor

    if kind == "host generator":
        return torch.Generator().manual_seed(seed)
    return DeviceKey(key_tensor(seed, "cpu"))


@pytest.mark.parametrize("key_kind", KEYS)
def test_sampled_stats_over_ranks_are_one_devices(pools, key_kind):
    """``--use_sample_stats`` on 4 ranks: the stratified sample of the
    whole tensor (``ops/smaq.py::compute_stats``), one of its elements the
    first or the last of a rank's rows; the mean and std bitwise one
    device's, and the stochastic call's output bitwise one device's on the
    whole tensor with the same key."""
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.ops.smaq import compute_stats, stratum_offset

    x = (_scaled_rows()[:, :, :3, :] * 0.1).astype(np.float32)  # (8, 4, 3, 3): 72 a rank
    n, k = x.size // 4, 16
    m = x.size // k  # 18: sample i*18 + j
    edges = {r * n + d for r in range(1, 4) for d in (-1, 0)}
    for seed in range(200):
        j = int(stratum_offset(_seeded_key(key_kind, seed), m, "cpu"))
        if any(i * m + j in edges for i in range(k)):
            break
    else:
        raise AssertionError("no seed puts a sample on a rank boundary")
    got = pools[4].run(rank_sampled_stats, x, key_kind, seed, k)
    comp = build_compressor("smart", use_sample_stats=True, num_samples=k)
    mean, std = compute_stats(torch.from_numpy(x), comp.params, _seeded_key(key_kind, seed))
    for r in got:
        np.testing.assert_array_equal(r["stats"], torch.stack([mean, std]).numpy())
    want, size = comp(torch.from_numpy(x), _seeded_key(key_kind, seed))
    np.testing.assert_array_equal(np.concatenate([r["y"] for r in got]), want.numpy())
    assert sum(float(r["size"]) for r in got) == float(size.new_bits)
    full = build_compressor("smart")(torch.from_numpy(x), _seeded_key(key_kind, seed))[0]
    assert not np.array_equal(full.numpy(), want.numpy())  # the sample's own statistics


# ------------------------------------------------------- packed state
@pytest.mark.parametrize("mesh_shape,packed", [((2, 2), "both"), ((1, 2), "both"),
                                               ((2, 2), "momentum")],
                         ids=["2x2-weights", "1x2-weights", "2x2-momentum"])
def test_packed_state_on_the_mesh(pools, mesh_shape, packed):
    """``--packed_momentum`` (and ``--packed_weights``) in truncation: each
    rank stores its block of a packed leaf's codes, the leaf's statistics
    replicated; the decoded parameters and momentum after 2 steps against
    ``Trainer.train_step`` with the same packed state and, for packed
    momentum, against JAX's ``make_fsdp_train_step``, by the flip rule;
    every rank bitwise equal."""
    _, state_dict = tiny_setup()
    steps = batches(2)
    got = pools[mesh_shape[0] * mesh_shape[1]].run(port_steps, mesh_shape, state_dict, steps,
                                                   "sgd", False, False, packed)
    _assert_ranks_equal(got)
    _assert_steps_agree(got[0], trainer_steps(state_dict, steps, "sgd", packed=packed),
                        "the trainer's step")
    if packed == "momentum":
        ref = jax_whole_batch("sgd", True)
        assert_close_or_flipped(got[0]["params"], ref["params"], "params vs JAX")
        assert_close_or_flipped(got[0]["opt"]["trace"], ref["opt"]["trace"], "trace vs JAX")
        assert float(got[0]["metrics"]["train_loss"]) == pytest.approx(ref["loss"], rel=1e-5)
    # the optimizer's packed sizes: 8 bits an element and 64 a leaf
    for tag in ("optimizer_momentum",) + (("optimizer_weight",) if packed == "both" else ()):
        orig, new = got[0]["metrics"][f"_ratio/{tag}"]
        assert 0.25 < new / orig < 0.26, tag
