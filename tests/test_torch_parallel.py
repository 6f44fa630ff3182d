"""The port's data-parallel step (``train/loop.py`` on a mesh,
``parallel/``) against the JAX package's ``make_dp_train_step``, and the
``--dp``/``--fsdp`` command line.  The fused FSDP step is in
``test_torch_fsdp.py``, the FSDP layout of packed state in
``test_torch_packed_fsdp.py``; both take their helpers from here.

The port's ranks are gloo processes that start once per module (a pool of
2 here; ``test_torch_fsdp.py`` adds one of 4); JAX runs ``shard_map`` on the conftest's virtual CPU
devices, over a mesh of the same shape, on the same inputs and parameters
(carried across with ``convert.params_from_jax``).  The ranks import
torch only.  SmaQ runs in truncation mode wherever the port is held
against JAX, on the tiny ResNet (stage sizes (1, 1), 8 x 8 inputs,
global batch 8) with taps off, so that the updated weights are comparable
element by element (``tests/test_torch_train.py``'s ``optimizer`` case:
at most 1 % of a leaf's elements one main-bucket quantum apart, the rest
within 1e-4 of the leaf's scale).  The JAX steps take their batch as
prepared (a task without augmentation, defined here).

- DP step, 2 ranks, float32 exchange: the loss, parameters, SGD trace,
  BatchNorm running statistics and the optimizer's size pairs;
- DP step at 8 bits, gather and psum modes, stochastic SmaQ: every rank
  ends bitwise equal (the shared optimizer and payload keys);
- fused FSDP step on a (1, 2) and a (2, 2) mesh, float32 exchanges: the
  parameters and trace after 2 steps;
- the FSDP layout of packed state (``encode_params`` / ``init_opt_state``
  with ``fsdp_size=2``) and ``reshard_packed_state`` 2 -> 1 and 1 -> 2
  against JAX's, with the deterministic compressor: codes bitwise, stats
  in their ``(fsdp,)`` shape to 1e-6 of the std (the order of a float32
  sum); and the
  global layout bitwise what each shard encodes on its own;
- a tiny BERT DP step at 2 ranks (int8 psum exchange): finite, ranks equal;
- the CLI: ``--dp 2 --device cpu`` on two joined ranks (as torchrun
  starts them; the CLI's own spawn is the slow test) trains, and rank 0
  alone writes the metrics log and the checkpoint;
  ``--grad_allreduce_bits 9`` raises before any rank starts;
- evaluation split over the ranks gives the whole batch's outputs;
- a rank that stops fails the pool's call at once (the CLI's spawn).
"""

import functools
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smart_quantization_tpu_torch.parallel.distributed import RankPool
from smart_quantization_tpu_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8


@pytest.fixture(scope="module")
def pools():
    made = {2: RankPool(2, "cpu", timeout_s=120.0)}
    yield made
    for pool in made.values():
        pool.close()


# the models the steps train: the tiny ResNet of tests/test_torch_train.py,
# and TinyCNN with 5 classes (its fc weight shards on torch dim 1, flax's
# axis 0, and its fc bias is replicated at fsdp 2)
CLASSES = {"resnet": 10, "tiny": 5}


def batches(n, seed=0, model="resnet"):
    r = np.random.RandomState(seed)
    return [(r.randn(BATCH, 8, 8, 3).astype(np.float32),
             r.randint(0, CLASSES[model], BATCH).astype(np.int32)) for _ in range(n)]


def port_model(name):
    from smart_quantization_tpu_torch.models.resnet import BasicBlock, ResNet
    from smart_quantization_tpu_torch.models.tiny import TinyCNN

    if name == "tiny":
        return TinyCNN(num_classes=CLASSES[name])
    return ResNet((1, 1), BasicBlock, num_classes=CLASSES[name])


# ------------------------------------------------------------- the ranks
@functools.lru_cache(maxsize=None)
def _mesh(dp, fsdp):
    return make_mesh(dp, fsdp)


def _numpy(tree):
    from smart_quantization_tpu_torch.ops.codebook import SmaQCodes

    if isinstance(tree, SmaQCodes):
        return {"codes": tree.codes.numpy(), "mean": tree.mean.numpy(), "std": tree.std.numpy()}
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return tree


def rank_steps(dp, fsdp, model_name, state_dict, steps, stochastic, bits=None, mode="auto"):
    """Train the model ``len(steps)`` steps on this rank's rows; returns
    the last metrics, the global parameters, the trace and the BatchNorm
    statistics."""
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )
    from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer

    mesh = _mesh(dp, fsdp)
    model = port_model(model_name)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    comp = build_compressor("smart", stochastic_rounding=stochastic)
    trainer = Trainer(model, None, build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=5e-4),
                      optim_comp=OptimizerCompression(compressor=comp),
                      config=TrainConfig(measure_compression_ratio=True), device="cpu",
                      mesh=mesh, grad_allreduce_bits=bits, grad_allreduce_mode=mode)
    state = trainer.init_state()
    for x, y in steps:
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        metrics = trainer.train_step(state, trainer._rows(xt), trainer._rows(torch.from_numpy(y)))
    if state.shards is not None:
        group = mesh.group("fsdp")
        params = trainer._fsdp.layout.gather(state.shards, group)
        opt = trainer._fsdp.layout.gather_opt_state(state.opt_state, group)
    else:
        params, opt = dict(model.named_parameters()), state.opt_state
    return {"metrics": _numpy(metrics), "params": _numpy(params), "trace": _numpy(opt["trace"]),
            "buffers": _numpy(dict(model.named_buffers()))}


# ---------------------------------------------------------- JAX's side
def jax_model(name):
    from smart_quantization_tpu.models.resnet import BasicBlock, ResNet
    from smart_quantization_tpu.models.tiny import TinyCNN

    if name == "tiny":
        return TinyCNN(num_classes=CLASSES[name])
    return ResNet(stage_sizes=(1, 1), block_cls=BasicBlock, num_classes=CLASSES[name])


@functools.lru_cache(maxsize=None)
def jax_setup(name="resnet", seed=0):
    """The model's variables in JAX and as the port's state dict."""
    import jax
    import jax.numpy as jnp

    from smart_quantization_tpu_torch.convert import params_from_jax

    model = jax_model(name)
    variables = jax.jit(lambda k: model.init({"params": k, "compress": k},
                                             jnp.zeros((2, 8, 8, 3)), train=True))(
        jax.random.key(seed))
    np_vars = jax.tree.map(np.asarray, variables)
    state_dict = {k: v.numpy() for k, v in
                  params_from_jax(np_vars["params"], np_vars["batch_stats"]).items()}
    # numpy, so that a step that donates its state leaves these alone
    return model, np_vars, state_dict


def jax_task():
    import dataclasses

    from smart_quantization_tpu.train.task import ImageClassificationTask

    @dataclasses.dataclass(frozen=True)
    class PreparedTask(ImageClassificationTask):
        """The batch arrives prepared: no augmentation, no normalization."""

        def prepare_train(self, inputs, key):
            return inputs

    return PreparedTask()


def jax_steps(mesh_shape, steps, fsdp_step, name="resnet"):
    """The JAX package's DP (or fused FSDP) step on ``steps``; the final
    state as numpy and the last metrics."""
    import jax
    import jax.numpy as jnp

    from smart_quantization_tpu.compress import build_compressor
    from smart_quantization_tpu.optim import compressed as jopt
    from smart_quantization_tpu.parallel import train_dp, train_fsdp_q
    from smart_quantization_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from smart_quantization_tpu.train.state import TrainState

    model, variables, state_dict = jax_setup(name)
    dp, fsdp = mesh_shape
    mesh = jax_make_mesh(dp=dp, fsdp=fsdp, devices=jax.devices()[:dp * fsdp])
    spec = jopt.build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=5e-4)
    comp = jopt.OptimizerCompression(compressor=build_compressor("smart",
                                                                 stochastic_rounding=False))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(jnp.int32(0), params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       spec.tx.init(params))
    if fsdp_step:
        step = train_fsdp_q.make_fsdp_q_train_step(model, spec, comp, mesh, state,
                                                   task=jax_task(), grad_bits=None)
        state, place = train_fsdp_q.place_state(mesh, state), train_fsdp_q.shard_batch
    else:
        step = train_dp.make_dp_train_step(model, spec, comp, mesh, task=jax_task(),
                                           grad_allreduce_bits=None, measure_ratio=True)
        state, place = train_dp.replicate_state(mesh, state), train_dp.shard_batch
    for x, y in steps:
        state, metrics = step(state, *place(mesh, jnp.asarray(x), jnp.asarray(y)),
                              jax.random.key(1))
    return state_dict, jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, metrics)


def jax_trace(opt_state):
    """SGD's trace in an optax chain state."""
    return next(s.trace for s in opt_state if hasattr(s, "trace"))


def assert_flip_rule(got: dict, ref: dict, what: str):
    """tests/test_torch_train.py's rule for a leaf after the optimizer's
    truncation SmaQ: at most 1 % of the elements beyond float32's wiggle,
    none more than one main-bucket quantum apart."""
    assert set(got) == set(ref), what
    for name, b in ref.items():
        a = np.asarray(got[name], np.float64)
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape and np.isfinite(a).all(), (what, name)
        diff = np.abs(a - b)
        quantum = np.std(b) / 15
        wiggle = 1e-4 * np.abs(b).max() + 1e-6
        assert (diff > wiggle).mean() <= 0.01, (what, name)
        assert diff.max() <= quantum * (1 + 1e-4) + wiggle, (what, name)


def jax_tree_to_port(tree):
    from smart_quantization_tpu_torch.convert import tree_from_jax

    return {k: v.numpy() for k, v in tree_from_jax(tree).items()}


def test_dp_step_matches_jax(pools):
    steps = batches(1)
    state_dict, ref, ref_metrics = jax_steps((2, 1), steps, fsdp_step=False)
    got = pools[2].run(rank_steps, 2, 1, "resnet", state_dict, steps, False)
    for r in got[1:]:  # replicas bitwise equal
        for what in ("params", "trace", "buffers"):
            for k, v in r[what].items():
                np.testing.assert_array_equal(v, got[0][what][k], err_msg=f"{what} {k}")
    m = got[0]["metrics"]
    assert abs(float(m["train_loss"]) - float(ref_metrics["train_loss"])) <= 1e-5 * float(
        ref_metrics["train_loss"])
    assert_flip_rule(got[0]["params"], jax_tree_to_port(ref.params), "params")
    assert_flip_rule(got[0]["trace"], jax_tree_to_port(jax_trace(ref.opt_state)), "trace")
    stats = jax_tree_to_port(ref.batch_stats)
    for k, v in stats.items():
        np.testing.assert_allclose(got[0]["buffers"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    for tag in ("optimizer_grad", "optimizer_weight", "optimizer_momentum"):
        a, b = m[f"_ratio/{tag}"], np.asarray(ref_metrics[f"_ratio/{tag}"])
        assert a[0] == b[0], tag
        assert abs(a[1] - b[1]) <= 0.01 * b[1], tag


@pytest.mark.parametrize("mode", ["gather", "psum"])
def test_dp_step_at_8_bits_keeps_ranks_equal(pools, mode):
    """Stochastic SmaQ and int8 payloads: the optimizer's and the payload's
    keys are shared, so both ranks hold the same parameters bitwise, and
    the exchange moved them (not the float32 mean's)."""
    _, _, state_dict = jax_setup("tiny")
    steps = batches(2, seed=1, model="tiny")
    got = pools[2].run(rank_steps, 2, 1, "tiny", state_dict, steps, True, 8, mode)
    plain = pools[2].run(rank_steps, 2, 1, "tiny", state_dict, steps, True, None)
    for what in ("params", "trace", "buffers"):
        for k, v in got[0][what].items():
            np.testing.assert_array_equal(got[1][what][k], v, err_msg=f"{what} {k}")
    assert np.isfinite(got[0]["metrics"]["train_loss"])
    assert any((got[0]["params"][k] != v).any() for k, v in plain[0]["params"].items())


# ----------------------------------------------------------------- BERT
def rank_bert_step(dp, fsdp, seed):
    from smart_quantization_tpu_torch.compress import SizeTotals, build_compressor
    from smart_quantization_tpu_torch.inject.tap import TapConfig, TapContext
    from smart_quantization_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )
    from smart_quantization_tpu_torch.train.bert_loop import BertTrainer
    from smart_quantization_tpu_torch.train.loop import TrainConfig

    mesh = _mesh(dp, fsdp)
    comp = build_compressor("smart")
    model = BertForSequenceClassification(BertConfig.tiny(), num_labels=1,
                                          tap=TapConfig(compressor=comp), seed=seed)
    trainer = BertTrainer(model, None, build_optimizer("adamw", 2e-5, weight_decay=0.01),
                          optim_comp=OptimizerCompression(compressor=comp),
                          config=TrainConfig(measure_compression_ratio=True), device="cpu",
                          mesh=mesh, grad_allreduce_bits=8, grad_allreduce_mode="psum")
    r = np.random.RandomState(seed)
    inputs = {"input_ids": torch.from_numpy(r.randint(0, 100, (4, 16))),
              "attention_mask": torch.ones(4, 16, dtype=torch.int64),
              "token_type_ids": torch.zeros(4, 16, dtype=torch.int64)}
    labels = torch.from_numpy(r.rand(4).astype(np.float32) * 5)
    state = trainer.init_state()
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    x, y = trainer._rows(inputs), trainer._rows(labels)
    local = SizeTotals()  # this rank's own forward sizes, before the step
    model.eval()
    with torch.no_grad():
        model(*trainer.task.model_args(x), TapContext(torch.Generator().manual_seed(0), local))
    metrics = trainer.train_step(state, x, y)
    moved = sum(bool((p != before[k]).any()) for k, p in model.named_parameters())
    return {"loss": float(metrics["train_loss"]), "moved": moved,
            "params": _numpy(dict(model.named_parameters())),
            "forward": metrics["_ratio/forward_autograd"].numpy(),
            "local_forward": local.totals["forward_autograd"].numpy()}


def test_bert_dp_step(pools):
    """A tiny BERT step at 2 ranks: finite, every parameter bitwise equal
    on both ranks, and the taps' sizes summed over the ranks (the original
    size exactly twice a rank's own, as for the global batch)."""
    got = pools[2].run(rank_bert_step, 2, 1, 0)
    assert np.isfinite(got[0]["loss"]) and got[0]["loss"] == got[1]["loss"]
    assert got[0]["moved"] > 0
    np.testing.assert_array_equal(got[0]["forward"], got[1]["forward"])
    assert got[0]["forward"][0] == got[0]["local_forward"][0] + got[1]["local_forward"][0]
    for k, v in got[0]["params"].items():
        np.testing.assert_array_equal(got[1]["params"][k], v, err_msg=k)


# ----------------------------------------------------------------- eval
def rank_eval(dp, fsdp, state_dict, x, y):
    """``eval_step`` on a batch the mesh divides (split, logits gathered)
    and on one it does not (whole on every rank), beside the model on the
    whole batch."""
    from smart_quantization_tpu_torch.optim.compressed import build_optimizer
    from smart_quantization_tpu_torch.train.loop import Trainer

    model = port_model("tiny")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    trainer = Trainer(model, None, build_optimizer("sgd", 0.1), device="cpu",
                      mesh=_mesh(dp, fsdp), grad_allreduce_bits=None)
    xt, yt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(y)
    out = {}
    for n in (8, 7):
        got = trainer.eval_step(xt[:n], yt[:n])
        model.eval()
        with torch.no_grad():
            want = trainer.task.eval_outputs(model(xt[:n]), yt[:n])
        out[n] = (_numpy(got), _numpy(want))
    return out


def test_eval_splits_the_batch_over_the_ranks(pools):
    _, _, state_dict = jax_setup("tiny")
    x, y = batches(1, seed=9, model="tiny")[0]
    for rank_out in pools[2].run(rank_eval, 2, 1, state_dict, x, y):
        for got, want in rank_out.values():
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


# ------------------------------------------------------------------ CLI
CLI_ENV = {"SMAQ_DISABLE_TB": "1", "SMAQ_SYNTH_TRAIN_N": "32", "SMAQ_SYNTH_TEST_N": "8"}


def cli_argv(tmp_path, *extra):
    return ["--device", "cpu", "--resnet_model", "resnet18", "--max_epochs", "1",
            "--limit_train_batches", "2", "--limit_val_batches", "1", "--batch_size", "4",
            "--logdir", str(tmp_path / "logs"), "--checkpoint_dir", str(tmp_path / "ck"),
            "--name", "dp", *extra]


def rank_cli(dp, fsdp, argv, env):
    """The command line's ``main`` on a joined rank (as under torchrun)."""
    import os

    from smart_quantization_tpu_torch.train.__main__ import main

    os.environ.update(env)
    return main(argv)


def check_rank0_wrote(tmp_path, step):
    assert sorted(os.listdir(tmp_path / "logs")) == ["dp.metrics.jsonl"]
    assert sorted(os.listdir(tmp_path / "ck")) == ["epoch_0000.pt"]
    ck = torch.load(tmp_path / "ck" / "epoch_0000.pt", weights_only=True)
    assert ck["step"] == step and ck["fsdp_size"] == 1 and len(ck["data_gens"]) == 2
    assert not glob.glob(str(tmp_path / "lightning_logs"))


def test_cli_dp_on_joined_ranks(pools, tmp_path):
    """``main`` on two joined gloo ranks, as ``torchrun`` would start it:
    the same final metrics on both, and rank 0 alone writes the metrics
    log and the checkpoint."""
    finals = pools[2].run(rank_cli, 2, 1, cli_argv(tmp_path, "--dp", "2",
                                                   "--grad_allreduce_bits", "8"), CLI_ENV)
    assert finals[0] == finals[1] and np.isfinite(finals[0]["val_loss"])
    check_rank0_wrote(tmp_path, 2)


@pytest.mark.slow  # three processes start (the CLI's own spawn), about 12 s
def test_cli_dp_spawns_its_ranks(tmp_path):
    # the spawned ranks take cores / world threads each (distributed.py's
    # _threads_for); the CLI's own process two, beside the suite's workers
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2", **CLI_ENV)
    out = subprocess.run(
        [sys.executable, "-m", "smart_quantization_tpu_torch.train",
         *cli_argv(tmp_path, "--dp", "2", "--grad_allreduce_bits", "8")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("final:") == 1 and out.stdout.count("run name:") == 1
    assert "mesh: dp=2 x fsdp=1; grad bits: 8" in out.stdout
    check_rank0_wrote(tmp_path, 2)


def test_cli_refuses_nine_bits(tmp_path):
    """``--grad_allreduce_bits 9`` (and ``--param_gather_bits 9``) stop the
    command line before any rank starts: the payload is int8."""
    from smart_quantization_tpu_torch.train.__main__ import main

    for flag in ("--grad_allreduce_bits", "--param_gather_bits"):
        with pytest.raises(ValueError, match="2..8 bits"):
            main(cli_argv(tmp_path, "--dp", "2", flag, "9"))
    assert not (tmp_path / "ck").exists()


def rank_one_stops():
    """Rank 1 leaves as a command line does (``SystemExit``) while rank 0
    waits for it in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise SystemExit("rank 1 stops")
    dist.barrier()


def test_pool_fails_at_once_when_a_rank_stops(pools):
    """A rank that stops fails the call at once, whichever rank it is, and
    not when the waiting rank's collective times out (120 s here): the
    CLI's spawn is such a call.  Last in the file: it closes the pool."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*SystemExit: rank 1 stops"):
        pools[2].run(rank_one_stops)
    assert time.monotonic() - t0 < 60
