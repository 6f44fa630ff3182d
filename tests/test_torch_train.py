"""The port's training step and CLI against the JAX package.

``test_trainer_step_matches_jax``: one ``Trainer.train_step`` on a prepared
batch against the JAX composition ``model.apply`` + ``value_and_grad`` +
``compressed_optimizer_step`` on the tiny ResNet (stage sizes (1, 1), full
channel widths, batch 4, 8x8), SmaQ 6/8 in truncation mode on every
structure, the same parameters.  Two cases:

- ``optimizer``: taps off, SmaQ on gradients, weights and momentum.  The
  gradients agree to float32 summation order (1e-4), so each updated leaf
  obeys the flip rule of tests/test_smaq.py:144-152 (at most 1 % of its
  elements apart, none by more than one main-bucket quantum plus that 1e-4
  wiggle) and the optimizer sizes agree to 1 %;
- ``full``: taps on as well.  Truncation is discontinuous: a last-ulp
  difference in a convolution moves a tapped element across a grid
  boundary, the flip changes the logits by up to 1e-2 of their scale
  (test_torch_resnet.py) and the backward taps then re-quantize gradients
  that differ by a fraction of a quantum, so the updated weights are not
  comparable element by element.  Held: the loss to 1e-2 relative, every
  tag's original size exactly and new size to 1 %, and finite updates.

``test_cli_reports_every_tag``: ``python -m smart_quantization_tpu_torch.train``
on the CPU at full ResNet-18 width reports all five
``compression_ratio_{tag}`` keys and an overall ratio of 4.5-5.5.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_quantization_tpu.compress import build_compressor as jax_build_compressor
from smart_quantization_tpu.inject.tap import TapConfig as JaxTapConfig
from smart_quantization_tpu.models.resnet import BasicBlock as JaxBasicBlock
from smart_quantization_tpu.models.resnet import ResNet as JaxResNet
from smart_quantization_tpu.optim import compressed as jopt
from smart_quantization_tpu.train.metrics import fold_sown_stats
from smart_quantization_tpu.train.task import cross_entropy as jax_cross_entropy
from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.convert import params_from_jax, tree_from_jax
from smart_quantization_tpu_torch.inject.tap import TapConfig
from smart_quantization_tpu_torch.models.resnet import BasicBlock, ResNet
from smart_quantization_tpu_torch.optim.compressed import OptimizerCompression, build_optimizer
from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = ("forward_autograd", "backward_autograd", "optimizer_grad",
        "optimizer_weight", "optimizer_momentum")
# a CLI subprocess's thread pools: the suite runs beside it on the same
# cores, and a full pool of them stalls when the other workers are busy
SUBPROCESS_THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}


def run_both_steps(jcomp, comp, taps):
    """One training step of the tiny ResNet in JAX and in the port, with
    the same parameters and batch; returns the port's metrics, state and
    model and JAX's loss, parameters, trace and sizes."""
    r = np.random.RandomState(0)
    x = r.randn(4, 8, 8, 3).astype(np.float32)
    labels = np.array([1, 4, 7, 9], np.int32)

    jmodel = JaxResNet(stage_sizes=(1, 1), block_cls=JaxBasicBlock, num_classes=10,
                       tap=JaxTapConfig(compressor=jcomp) if taps else None)
    variables = jax.jit(
        lambda k: jmodel.init({"params": k, "compress": k}, jnp.asarray(x), train=True)
    )(jax.random.key(0))
    spec_j = jopt.build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=5e-4)
    comp_j = jopt.OptimizerCompression(compressor=jcomp)

    def jax_step(params, stats, tel):
        def loss_fn(p, t):
            logits, mut = jmodel.apply(
                {"params": p, "batch_stats": stats, "telemetry": t}, jnp.asarray(x),
                train=True, rngs={"compress": jax.random.key(1)},
                mutable=["batch_stats", "compression_stats"],
            )
            return jax_cross_entropy(logits, jnp.asarray(labels)), mut

        (loss, mut), (grads, tel_g) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(params, tel or {})
        new_p, opt, om = jopt.compressed_optimizer_step(
            spec_j, params, grads, spec_j.tx.init(params), jax.random.key(2), comp_j,
            weight_exempt=jopt.norm_param_mask(params),
        )
        sizes = dict(fold_sown_stats(mut.get("compression_stats", {})), **om)
        if taps:
            sizes["backward_autograd"] = sum(jax.tree.leaves(tel_g))
        return loss, new_p, opt[1].trace, sizes

    loss_ref, p_ref, trace_ref, sizes_ref = jax.jit(jax_step)(
        variables["params"], variables["batch_stats"], variables.get("telemetry")
    )

    model = ResNet((1, 1), BasicBlock, num_classes=10,
                   tap=TapConfig(compressor=comp) if taps else None)
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]),
    ))
    trainer = Trainer(
        model, None, build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=5e-4),
        optim_comp=OptimizerCompression(compressor=comp),
        config=TrainConfig(measure_compression_ratio=True), device="cpu",
    )
    state = trainer.init_state()
    metrics = trainer.train_step(
        state, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(labels),
    )
    return metrics, state, model, (loss_ref, p_ref, trace_ref, sizes_ref)


@pytest.mark.parametrize("coverage", ["optimizer", "full"])
def test_trainer_step_matches_jax(coverage):
    taps = coverage == "full"
    jcomp = jax_build_compressor("smart", stochastic_rounding=False)
    comp = build_compressor("smart", stochastic_rounding=False)
    metrics, state, model, (loss_ref, p_ref, trace_ref, sizes_ref) = run_both_steps(
        jcomp, comp, taps)

    assert state.step == 1
    loss_tol = 1e-2 if taps else 1e-5
    assert abs(float(metrics["train_loss"]) - float(loss_ref)) <= loss_tol * float(loss_ref)
    got = {"params": dict(model.named_parameters()), "trace": state.opt_state["trace"]}
    refs = {"params": tree_from_jax(jax.tree.map(np.asarray, p_ref)),
            "trace": tree_from_jax(jax.tree.map(np.asarray, trace_ref))}
    for what in got:
        assert set(got[what]) == set(refs[what])
        for name, ref in refs[what].items():
            a = got[what][name].detach().numpy().astype(np.float64)
            b = ref.numpy().astype(np.float64)
            assert a.shape == b.shape and np.isfinite(a).all(), (what, name)
            if taps:
                continue
            diff = np.abs(a - b)
            quantum = np.std(b) / 15
            wiggle = 1e-4 * np.abs(b).max() + 1e-6
            assert (diff > wiggle).mean() <= 0.01, (what, name)
            assert diff.max() <= quantum * (1 + 1e-4) + wiggle, (what, name)
    for tag in TAGS if taps else TAGS[2:]:
        a, b = metrics[f"_ratio/{tag}"].numpy(), np.asarray(sizes_ref[tag])
        assert a[0] == b[0], tag
        assert abs(a[1] - b[1]) <= 0.01 * b[1], tag


@pytest.mark.parametrize("name", ["fp8", "fp16", "bf16"])
def test_float_encoder_step_matches_jax(name):
    """A full-coverage step with a float encoder in nearest mode: the loss
    to 1e-2 relative (a last-ulp convolution difference can move a tapped
    value across a rounding midpoint), every size exactly (n * bits), and
    finite parameters."""
    metrics, state, model, (loss_ref, _, _, sizes_ref) = run_both_steps(
        jax_build_compressor(name, stochastic=False), build_compressor(name, stochastic=False),
        taps=True)
    assert abs(float(metrics["train_loss"]) - float(loss_ref)) <= 1e-2 * float(loss_ref)
    for tag in TAGS:
        np.testing.assert_array_equal(metrics[f"_ratio/{tag}"].numpy(),
                                      np.asarray(sizes_ref[tag]), err_msg=tag)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_bn_folded_training_step_on_cpu():
    """``--use_batch_norm`` from the command line: the taps fold each BN's
    gamma and beta into the forward compress, gamma and beta still get
    gradients (from the BatchNorm; the JAX package's training step cannot
    run here, ROADMAP Queue 3), and a trainer step gives a finite loss."""
    from smart_quantization_tpu_torch.compress import SizeTotals
    from smart_quantization_tpu_torch.inject.tap import TapContext
    from smart_quantization_tpu_torch.utils.config import build_components, parse_args

    args = parse_args("--device cpu --compress smart --use_batch_norm "
                      "--measure_compression_ratio")
    comps = build_components(args)
    assert comps["tap_cfg"].use_batch_norm and comps["compressor"].use_batch_norm
    torch.manual_seed(0)
    model = ResNet((1, 1), BasicBlock, num_classes=10, tap=comps["tap_cfg"])
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 3, 8, 8).astype(np.float32))
    labels = torch.tensor([1, 4, 7, 9])
    logits = model(x, TapContext(torch.Generator().manual_seed(0), SizeTotals()))
    torch.nn.functional.cross_entropy(logits, labels).backward()
    bn = {n: p for n, p in model.named_parameters() if n.split(".")[-2].endswith("bn")}
    assert bn and all(torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
                      for p in bn.values())
    trainer = Trainer(model, None, comps["optimizer_spec"], optim_comp=comps["optim_comp"],
                      config=TrainConfig(measure_compression_ratio=True), device="cpu")
    metrics = trainer.train_step(trainer.init_state(), x, labels)
    assert np.isfinite(float(metrics["train_loss"]))
    assert "_ratio/forward_autograd" in metrics


@pytest.mark.parametrize("argv", [
    "--compress fp8", "--compress fp16 --precision 16", "--compress bf16",
    "--compress s2fp8 --no_float_quantize_check_inf", "--compress smart --use_batch_norm",
    "--compress smart --use_batch_norm --bn_scalar_params", "--compress fp32",
])
def test_cli_builds_every_encoder(argv):
    from smart_quantization_tpu_torch.utils.config import build_components, parse_args

    args = parse_args(f"--device cpu {argv}")
    comps = build_components(args)
    comp = comps["compressor"]
    assert comp.name == args.compress
    assert comps["optim_comp"].compressor is comp and comps["tap_cfg"].compressor is comp
    if args.compress in ("fp8", "fp16", "bf16", "s2fp8"):
        assert comp.check_inf == ("--no_float_quantize_check_inf" not in argv)
        assert comp.precision == args.precision
    assert comps["tap_cfg"].use_batch_norm == ("--use_batch_norm" in argv)
    if args.compress == "smart":
        assert comp.use_batch_norm and comp.bn_scalar_params == ("--bn_scalar_params" in argv)


@pytest.mark.parametrize("argv", ["--dp 2 --fsdp 2", "--dp 2", "--fsdp 2"])
def test_cli_mesh_flags_build(argv):
    """``--dp``/``--fsdp`` (once deferred, ROADMAP Queue 1 item 15) parse,
    build, and plan a mesh of dp x fsdp ranks (``--fsdp`` alone: dp 1
    without a launcher), with JAX's defaults for the payload flags."""
    from smart_quantization_tpu_torch.utils.config import build_components, mesh_plan, parse_args

    args = parse_args(f"--device cpu --compress fp8 {argv}")
    build_components(args)
    plan = mesh_plan(args)
    want = {"--dp 2 --fsdp 2": (2, 2), "--dp 2": (2, 1), "--fsdp 2": (1, 2)}[argv]
    assert (plan.dp, plan.fsdp) == want and plan.size == want[0] * want[1]
    assert (args.grad_allreduce_bits, args.grad_allreduce_mode, args.param_gather_bits) == (
        None, "auto", None)
    assert mesh_plan(parse_args("--device cpu --dp 1")) is None


PARSER_PAIRS = [("resnet", "cifar10"), ("resnet", "cifar100"), ("bert", "glue"), ("bert", "imdb")]


@pytest.mark.parametrize("model,dataset", PARSER_PAIRS, ids=[f"{m}-{d}" for m, d in PARSER_PAIRS])
def test_parsers_differ_only_in_the_ports_own_flags(model, dataset):
    """On each model/dataset pair the port's parser and the JAX package's
    give the same flags with the same defaults, but ``--no_pallas`` (JAX's
    only; ``use_pallas``, under SmaQ) and the port's ``--device`` and
    ``--checkpoint_every_epochs``."""
    from smart_quantization_tpu.utils.config import parse_args as jax_parse
    from smart_quantization_tpu_torch.utils.config import parse_args

    for compress in ("fp32", "smart", "fp8"):
        argv = f"--model {model} --dataset {dataset} --compress {compress}"
        a, b = vars(jax_parse(argv)), vars(parse_args(argv))
        assert set(a) - set(b) == ({"use_pallas"} if compress == "smart" else set())
        assert set(b) - set(a) == {"device", "checkpoint_every_epochs"}
        assert {k: v for k, v in a.items() if k in b and k != "name"} == {
            k: v for k, v in b.items() if k in a and k != "name"}


@pytest.mark.parametrize("argv", ["--model inception --dataset cifar100", "--model inception"])
def test_cli_inception_builds(argv, tmp_path, monkeypatch):
    """``--model inception`` (once deferred, ROADMAP Queue 1 item 13) builds
    the CIFAR Inception-v3 with the dataset's classes and the taps."""
    from smart_quantization_tpu_torch.models.inception import Inception3
    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    monkeypatch.setenv("SMAQ_DISABLE_TB", "1")

    trainer = build_trainer(parse_args(f"--device cpu --compress fp8 --logdir {tmp_path} {argv}"))
    assert isinstance(trainer.model, Inception3)
    assert trainer.model.fc.out_features == (100 if "cifar100" in argv else 10)
    assert trainer.model.tap is not None and trainer.model.Mixed_7c.branch_pool.bn.tap is not None


@pytest.mark.parametrize("argv", ["--model inception --dataset glue",
                                  "--model inception --dataset imdb"])
def test_cli_inception_refuses_text_datasets(argv):
    from smart_quantization_tpu_torch.utils.config import parse_args

    with pytest.raises(SystemExit, match="incompatible"):
        parse_args(f"--device cpu {argv}")


LOSS_ENCODERS = [("smart", {}), ("fp8", {"stochastic": False}), ("s2fp8", {"stochastic": False}),
                 ("fp16", {"stochastic": False}), ("bf16", {"stochastic": False}), ("fp32", {})]


@pytest.mark.parametrize("name,kw", LOSS_ENCODERS, ids=[n for n, _ in LOSS_ENCODERS])
def test_compress_loss_matches_jax(name, kw):
    """``--compress_loss``: the loss through the encoder and its gradient, as
    JAX's autodiff gives them through ``compressor(loss[None], key)[0]``:
    the identity for SmaQ (one element is below ``min_size``), S2FP8 (its
    value follows the loss through its statistics) and FP32; zero for FP8,
    FP16 and BF16 (bit arithmetic).  The value bitwise, S2FP8's to float32's
    log2/exp2 (1e-6); the gradient to 1e-6 of the raw one."""
    from smart_quantization_tpu_torch.inject.tap import compress_loss

    r = np.random.RandomState(3)
    w0, x = r.randn(6).astype(np.float32), r.randn(6).astype(np.float32)
    jcomp = jax_build_compressor(name, **kw)

    def jax_loss(w):
        loss = jnp.sum((w * x + 0.3) ** 2)
        loss_q, _ = jcomp(loss[None], jax.random.key(4))
        return loss_q[0]

    value_ref, grad_ref = jax.value_and_grad(jax_loss)(jnp.asarray(w0))
    w = torch.from_numpy(w0.copy()).requires_grad_()
    loss = compress_loss(((w * torch.from_numpy(x) + 0.3) ** 2).sum(), build_compressor(name, **kw),
                         torch.Generator().manual_seed(4))
    loss.backward()
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(value_ref),
                               rtol=1e-6 if name == "s2fp8" else 0)
    raw = np.abs(np.asarray(jax.grad(lambda w: jnp.sum((w * x + 0.3) ** 2))(jnp.asarray(w0))))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(grad_ref), rtol=0, atol=1e-6 * raw.max())
    assert (np.asarray(grad_ref) == 0).all() == (name in ("fp8", "fp16", "bf16"))


def test_compress_loss_and_grad_norm_in_a_step():
    """A trainer step with ``compress_loss`` (FP8, nearest) logs the rounded
    loss and steps on zero gradients (the weight decay alone); with
    ``measure_average_grad_norm`` it logs the mean of the raw gradients'
    per-leaf L2 norms as JAX computes it (``jnp.linalg.norm`` of each leaf,
    ``loop.py:342-346``) on the same gradients, to 1e-6."""
    from smart_quantization_tpu_torch.models.tiny import TinyCNN
    from smart_quantization_tpu_torch.ops.float_format import FP8_FORMAT, float_quantize
    from smart_quantization_tpu_torch.train.task import cross_entropy

    x = torch.from_numpy(np.random.RandomState(1).randn(4, 3, 16, 16).astype(np.float32))
    labels = torch.tensor([1, 4, 7, 9])

    def trainer_of(**cfg):
        torch.manual_seed(0)
        model = TinyCNN(num_classes=10)
        comp = build_compressor("fp8", stochastic=False)
        return Trainer(model, None, build_optimizer("sgd", 0.1, momentum=0.9, weight_decay=1e-2),
                       loss_compressor=comp, config=TrainConfig(**cfg), device="cpu")

    t = trainer_of(compress_loss=True)
    w0 = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    plain = cross_entropy(t.model(x), labels).detach()
    metrics = t.train_step(t.init_state(), x, labels)
    assert float(metrics["train_loss"]) == float(float_quantize(plain, FP8_FORMAT, stochastic=False))
    for n, p in t.model.named_parameters():
        torch.testing.assert_close(p.detach(), w0[n] - 0.1 * 1e-2 * w0[n], rtol=0, atol=1e-7)

    t = trainer_of(measure_average_grad_norm=True)
    ref = trainer_of()
    ref.model.train()
    cross_entropy(ref.model(x), labels).backward()
    norms = [jnp.linalg.norm(jnp.asarray(p.grad.numpy())) for p in ref.model.parameters()]
    metrics = t.train_step(t.init_state(), x, labels)
    assert "avg_grad_norm" not in ref.train_step(ref.init_state(), x, labels)
    np.testing.assert_allclose(float(metrics["avg_grad_norm"]), float(jnp.mean(jnp.stack(norms))),
                               rtol=1e-6)


def test_git_tags_the_run_and_writes_the_header(tmp_path, monkeypatch):
    """``--git`` in a git repository: the commit comes back, ``run/<name>``
    is tagged, and the run's metrics file starts with the header line;
    outside a repository there is no commit.  ``--no_add_tags`` parses as
    the JAX package's (``add_tags``, read by nothing)."""
    from smart_quantization_tpu_torch.train.metrics import run_logger
    from smart_quantization_tpu_torch.utils.config import git_run_tag, parse_args

    monkeypatch.setenv("SMAQ_DISABLE_TB", "1")  # the JSONL header alone
    repo = tmp_path / "repo"
    repo.mkdir()
    git = ["git", "-c", "user.name=t", "-c", "user.email=t@example.com"]
    for cmd in (["init", "-q"], ["commit", "-q", "--allow-empty", "-m", "first"]):
        subprocess.run(git + cmd, cwd=repo, check=True, capture_output=True)
    head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=repo, check=True,
                          capture_output=True, text=True).stdout.strip()
    monkeypatch.chdir(repo)
    args = parse_args(
        f"--device cpu --git --no_add_tags --name probe --logdir {tmp_path / 'logs'}")
    assert args.git and not args.add_tags
    args.git_commit = git_run_tag(args.name)
    assert args.git_commit == head
    tags = subprocess.run(["git", "tag"], cwd=repo, check=True, capture_output=True, text=True)
    assert tags.stdout.split() == ["run/probe"]
    run_logger(args).close()
    with open(tmp_path / "logs" / "probe.metrics.jsonl") as f:
        assert json.loads(f.readline()) == {"header": {"git_commit": head, "name": "probe"}}
    monkeypatch.chdir(tmp_path)
    assert git_run_tag("outside", create_tag=False) is None
    assert parse_args("--device cpu").add_tags


def test_cli_reports_every_tag(tmp_path):
    # a small synthetic test split: --limit_val_batches 1 means the whole
    # split (Lightning's float semantics) at a validation batch of 1; two
    # threads, as on a machine shared with the suite's other workers
    env = dict(os.environ, SMAQ_SYNTH_TEST_N="8", SMAQ_DISABLE_TB="1", **SUBPROCESS_THREADS)
    out = subprocess.run(
        [sys.executable, "-m", "smart_quantization_tpu_torch.train", "--device", "cpu",
         "--resnet_model", "resnet18", "--compress", "smart", "--measure_compression_ratio",
         "--limit_train_batches", "2", "--limit_val_batches", "1", "--batch_size", "4",
         "--logdir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    final = json.loads(out.stdout.split("final:", 1)[1])
    for tag in TAGS:
        assert f"compression_ratio_{tag}" in final, tag
    assert 4.5 <= final["compression_ratio"] <= 5.5
    assert np.isfinite(final["val_loss"])
    assert list(tmp_path.glob("*.metrics.jsonl"))


def test_bert_flags_take_the_jax_defaults():
    """``--model bert`` with GLUE or IMDB: batch 32, length 512, STSB,
    bert-base with pretrained weights asked for; a model and a dataset that
    do not go together exit."""
    from smart_quantization_tpu_torch.utils.config import check_ported, parse_args

    for dataset in ("glue", "imdb"):
        args = parse_args(f"--device cpu --model bert --dataset {dataset}")
        check_ported(args)
        assert (args.batch_size, args.max_input_length, args.bert_size) == (32, 512, "base")
        assert args.pretrained and not args.freeze_bert_encoder
        assert args.bert_model == "bert-base-uncased"
    assert parse_args("--device cpu --model bert --dataset glue").glue_task == "stsb"
    assert parse_args("--device cpu").batch_size == 8  # CIFAR's stays
    for argv in ("--model bert --dataset cifar10", "--model resnet --dataset glue"):
        with pytest.raises(SystemExit):
            parse_args(f"--device cpu {argv}")


@pytest.mark.parametrize("dataset,metrics", [
    ("glue", ("val_pearson", "val_spearmanr")), ("imdb", ("val_accuracy",))])
def test_bert_cli_runs_on_cpu(tmp_path, dataset, metrics):
    """``--model bert --bert_size tiny`` through the CLI with SmaQ on every
    structure and AdamW: the task's metrics, the five ratio tags, an
    overall ratio of 4.5-5.5 and a finite loss."""
    out = subprocess.run(
        [sys.executable, "-m", "smart_quantization_tpu_torch.train", "--device", "cpu",
         "--model", "bert", "--bert_size", "tiny", "--dataset", dataset, "--compress", "smart",
         "--optimizer_type", "adamw", "--learning_rate", "2e-5", "--max_input_length", "32",
         "--measure_compression_ratio", "--limit_train_batches", "2", "--limit_val_batches", "4",
         "--batch_size", "8", "--logdir", str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, SMAQ_DISABLE_TB="1", **SUBPROCESS_THREADS),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    final = json.loads(out.stdout.split("final:", 1)[1])
    for key in metrics:
        assert np.isfinite(final[key]), key
    for tag in TAGS:
        assert f"compression_ratio_{tag}" in final, tag
    assert 4.5 <= final["compression_ratio"] <= 5.5
    assert np.isfinite(final["val_loss"])


def test_step_generators_keep_their_seeds():
    """The dropout generator is a third word of the step's seed sequence:
    the taps' and the optimizer's seeds are the two words they were before
    it, so a ResNet step draws what it drew without dropout."""
    trainer = Trainer(torch.nn.Linear(2, 2), None, build_optimizer("sgd", 0.1),
                      config=TrainConfig(seed=3), device="cpu")
    want = np.random.SeedSequence([3, 5]).generate_state(2, np.uint64)
    g_fwd, g_opt, g_drop = trainer._step_generators(5)
    assert (g_fwd.initial_seed(), g_opt.initial_seed()) == tuple(int(w) for w in want)
    assert g_drop.device == torch.device("cpu")
    assert g_drop.initial_seed() not in (g_fwd.initial_seed(), g_opt.initial_seed())
