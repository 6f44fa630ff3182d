"""Two-phase CLI composition + experiment wiring.

Counterpart of ``smart_quantization_tpu/utils/config.py`` (``parse_args``
and ``build_components``): ResNet and Inception-v3 on CIFAR-10/100 and BERT
on GLUE and IMDB, with any of the six encoders, on one device or on a
``--dp``/``--fsdp`` mesh of ranks.  Phase 1 parses the class selectors and
the per-structure toggles; phase 2 re-parses with the selected encoder's,
model's and dataset's own flags (the JAX package's defaults: batch 8 on
CIFAR, 32 and length 512 on text).  ``--no_pallas`` is gone (the port has
no Pallas), ``--device`` and ``--checkpoint_every_epochs`` are new, and
collective payload bits outside 2..8 raise (:func:`check_ported`).
"""

from __future__ import annotations

import argparse
import time
from typing import Any

DATA_STRUCTURES = (
    "forward",
    "backward",
    "weights",
    "gradients",
    "momentum_vectors",
    "loss",
)


def add_compression_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--measure_compression_ratio", action="store_true")


def add_smart_args(parser: argparse.ArgumentParser) -> None:
    add_compression_args(parser)
    parser.add_argument("--num_samples", type=int, default=16)
    parser.add_argument("--use_sample_stats", action="store_true")
    parser.add_argument(
        "--no_stochastic_rounding", action="store_false", dest="stochastic_rounding"
    )
    parser.add_argument("--num_bits_main", type=int, default=6)
    parser.add_argument("--num_bits_outlier", type=int, default=8)
    parser.add_argument("--main_std_dev_threshold", type=float, default=1.0)
    parser.add_argument("--outlier_std_dev_threshold", type=float, default=2.5)
    parser.add_argument("--min_size", type=int, default=8)
    parser.add_argument("--use_range_std_dev", action="store_true")
    parser.add_argument("--use_batch_norm", action="store_true")
    parser.add_argument("--bn_scalar_params", action="store_true")


def add_float_args(parser: argparse.ArgumentParser) -> None:
    # the JAX package's add_float_args (utils/config.py:52-59)
    add_compression_args(parser)
    parser.add_argument(
        "--no_float_quantize_check_inf",
        action="store_false",
        dest="float_quantize_check_inf",
    )


def add_model_base_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--optimizer_type", choices=("sgd", "adam", "adamw"), default="sgd")
    parser.add_argument("--scheduler_type", choices=("multi_step", "none"), default="none")
    parser.add_argument("--scheduler_gamma", type=float, default=0.1)
    parser.add_argument("--scheduler_milestones", type=int, nargs="+", default=[100, 150, 200])
    parser.add_argument("--learning_rate", type=float, default=0.1)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--beta1", type=float)
    parser.add_argument("--beta2", type=float)
    parser.add_argument("--epsilon", type=float)
    parser.add_argument("--measure_average_grad_norm", action="store_true",
                        help="log avg_grad_norm, the mean of the per-leaf L2 norms of the raw "
                             "gradients")


def add_resnet_args(parser: argparse.ArgumentParser) -> None:
    add_model_base_args(parser)
    parser.add_argument(
        "--resnet_model", choices=("resnet18", "resnet34", "resnet50"), default="resnet34"
    )


def add_bert_args(parser: argparse.ArgumentParser) -> None:
    add_model_base_args(parser)
    parser.add_argument("--bert_model", type=str, default="bert-base-uncased",
                        help="HF name of the pretrained weights and tokenizer (local cache only)")
    parser.add_argument("--no_pretrained", action="store_false", dest="pretrained")
    parser.add_argument("--freeze_bert_encoder", action="store_true")
    parser.add_argument("--bert_size", choices=("base", "tiny"), default="base",
                        help="tiny = the 2-layer test config")


def add_cifar_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--val_batch_size", type=int)


def add_imdb_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--val_batch_size", type=int)
    parser.add_argument("--max_input_length", type=int, default=512)


def add_glue_args(parser: argparse.ArgumentParser) -> None:
    add_imdb_args(parser)
    parser.add_argument("--glue_task", type=str, default="stsb")


def add_trainer_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--max_epochs", type=int, default=1)
    parser.add_argument(
        "--max_time", type=parse_max_time, default=None,
        help="wall-clock training budget as DD:HH:MM:SS or plain seconds",
    )
    parser.add_argument(
        "--limit_train_batches", type=float,
        help="cap train batches per epoch: an int count, or a 0<f<=1 fraction",
    )
    parser.add_argument("--limit_val_batches", type=float)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--no_terminate_on_nan", action="store_false", dest="terminate_on_nan")
    parser.add_argument("--precision", type=int, default=32, choices=(16, 32))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint_dir", type=str,
                        help="write a checkpoint (epoch_NNNN.pt) here at epoch ends")
    parser.add_argument("--checkpoint_every_epochs", type=int, default=1)
    parser.add_argument("--resume_from", type=str,
                        help="restore a checkpoint written under --checkpoint_dir first")
    parser.add_argument("--use_weight_accumulator", action="store_true",
                        help="keep float32 master weights; expose the quantized view")
    parser.add_argument("--packed_momentum", action="store_true",
                        help="store SGD's trace / Adam's mu and nu as uint8 SmaQ codebook "
                             "codes (--compress smart)")
    parser.add_argument("--packed_weights", action="store_true",
                        help="store the non-BatchNorm weights as uint8 SmaQ codebook codes, "
                             "decoded at each step (--compress smart)")
    parser.add_argument("--momentum_log_nu", action="store_true",
                        help="quantize Adam's second moment in the log2 domain")
    parser.add_argument("--momentum_rowwise", action="store_true",
                        help="quantize momentum with per-row stats (64 bits a row, counted)")
    parser.add_argument("--momentum_log_nu_rowwise", action="store_true",
                        help="per-row log2 stats for Adam's second moment (implies "
                             "--momentum_log_nu)")
    parser.add_argument(
        "--steps_per_call", type=int, default=1,
        help="train (and evaluate) K steps per host dispatch: on the card one CUDA "
             "graph of K steps, captured after the first group (run eagerly on the "
             "capture stream) and replayed for every later group of K batches; a "
             "leftover group runs as single steps; on the CPU the same grouping, "
             "eager.  A NaN is caught at the drain after its group")
    parser.add_argument(
        "--profile_dir", type=str,
        help="write a torch.profiler trace of the first --profile_steps training "
             "steps into this directory, with the regions compress/forward, "
             "compress/backward and compress/optimizer_{grad,weight,momentum}; under "
             "--steps_per_call K > 1 the replayed steps show as graph launches, not "
             "regions")
    parser.add_argument("--profile_steps", type=int, default=10)
    parser.add_argument(
        "--compute_dtype", default="float32", choices=("float32", "bfloat16"),
        help="the models' compute dtype: convolutions, matmuls, activations and the "
             "feature and gradient maps the taps compress (parameters, BatchNorm and "
             "LayerNorm statistics, the softmax, the loss and the optimizer stay float32)")
    parser.add_argument("--auto_lr_find", action="store_true",
                        help="run the learning-rate range test first (50 steps, 1e-6 to 1) "
                             "and train at its suggestion")
    parser.add_argument("--auto_scale_batch_size", action="store_true",
                        help="double the batch size from --batch_size until a step runs out "
                             "of memory, and train at the largest that fit")
    parser.add_argument(
        "--dp", type=int,
        help="data-parallel mesh size (ranks): without torchrun the CLI starts dp x fsdp "
             "ranks itself; NCCL on the card (one card a rank), gloo with --device cpu")
    parser.add_argument(
        "--fsdp", type=int, default=1,
        help="FSDP mesh size: shard params/optimizer state over this many ranks (fused "
             "with the quantized collectives)")
    parser.add_argument(
        "--param_gather_bits", type=int, default=None,
        help="quantize FSDP parameter all-gather payloads to N bits (2-8; the payload "
             "stays one byte an element: below 8 bits, precision only)")
    parser.add_argument(
        "--grad_allreduce_bits", type=int, default=None,
        help="quantize gradient all-reduce payloads to N bits (2-8; below 8, precision "
             "only)")
    parser.add_argument(
        "--grad_allreduce_mode", default="auto", choices=["auto", "gather", "psum"],
        help="quantized all-reduce variant: gather = full per-rank precision, (n-1) B/elem; "
             "psum = headroom-grid int8 ring, ~2 B/elem at any mesh size; auto = gather "
             "below 8 ranks, psum at 8+ (traffic table in parallel/train_dp.py)")


COMPRESSORS = ("bf16", "fp16", "fp32", "fp8", "s2fp8", "smart")
FLOAT_COMPRESSORS = ("fp8", "s2fp8", "fp16", "bf16")
# the inception model's flags are the base ones
MODEL_ARGS = {"bert": add_bert_args, "inception": add_model_base_args,
              "resnet": add_resnet_args}
DATASET_ARGS = {"cifar10": add_cifar_args, "cifar100": add_cifar_args,
                "glue": add_glue_args, "imdb": add_imdb_args}
MODEL_DATASETS = {"bert": ("glue", "imdb"), "inception": ("cifar10", "cifar100"),
                  "resnet": ("cifar10", "cifar100")}

def default_name(args: argparse.Namespace) -> str:
    tags = ",".join(
        ds for ds in DATA_STRUCTURES
        if args.compress_enabled and getattr(args, f"compress_{ds}", False)
    )
    return "-".join(
        (args.compress, args.model, args.dataset, tags, args.tags or "",
         time.strftime("%Y%m%d_%H%M%S"))
    ).lower()


def parse_args(argv: list[str] | str | None = None) -> argparse.Namespace:
    if isinstance(argv, str):
        argv = argv.split(" ")

    phase1 = argparse.ArgumentParser(add_help=False)
    phase1.add_argument("--model", choices=sorted(MODEL_ARGS), default="resnet")
    phase1.add_argument("--dataset", choices=sorted(DATASET_ARGS), default="cifar10")
    phase1.add_argument("--no_compress", action="store_false", dest="compress_enabled")
    phase1.add_argument("--compress", choices=COMPRESSORS, default="fp32")
    phase1.add_argument(
        "--compression_hook_fn", choices=("autograd", "global_hook"), default="autograd"
    )
    phase1.add_argument("--no_compress_forward", action="store_false", dest="compress_forward")
    phase1.add_argument("--no_compress_backward", action="store_false", dest="compress_backward")
    phase1.add_argument("--no_compress_weights", action="store_false", dest="compress_weights")
    phase1.add_argument(
        "--no_compress_gradients", action="store_false", dest="compress_gradients"
    )
    phase1.add_argument(
        "--no_compress_momentum_vectors", action="store_false",
        dest="compress_momentum_vectors",
    )
    phase1.add_argument("--compress_loss", action="store_true")
    phase1.add_argument(
        "--git", action="store_true",
        help="tag the repository with run/<name> and record the commit hash in the "
             "run's metrics header")
    # parsed as the JAX package parses it; nothing reads it there either
    phase1.add_argument("--no_add_tags", action="store_false", dest="add_tags")
    phase1.add_argument("--name", type=str)
    phase1.add_argument("--logdir", type=str, default="lightning_logs")
    phase1.add_argument("--tags", type=str)
    args1, _ = phase1.parse_known_args(argv)
    if args1.dataset not in MODEL_DATASETS[args1.model]:
        raise SystemExit(f"--model {args1.model} is incompatible with --dataset {args1.dataset}")

    phase2 = argparse.ArgumentParser(parents=[phase1])
    if args1.compress == "smart":
        add_smart_args(phase2)
    elif args1.compress in FLOAT_COMPRESSORS:
        add_float_args(phase2)
    else:
        add_compression_args(phase2)
    MODEL_ARGS[args1.model](phase2)
    DATASET_ARGS[args1.dataset](phase2)
    add_trainer_args(phase2)
    args = phase2.parse_args(argv)

    if not args.name:
        args.name = default_name(args)
    elif args.tags:
        args.name += f"-{args.tags}"
    return args


def parse_max_time(s: str) -> float:
    """``DD:HH:MM:SS`` or plain seconds -> seconds."""
    parts = s.split(":")
    if len(parts) == 1:
        return float(s)
    if len(parts) != 4:
        raise argparse.ArgumentTypeError(f"--max_time wants DD:HH:MM:SS or seconds, got {s!r}")
    d, h, m, sec = (int(p) for p in parts)
    return float(((d * 24 + h) * 60 + m) * 60 + sec)


def git_run_tag(name: str, create_tag: bool = True) -> str | None:
    """The current commit of the repository a run starts in, tagged
    ``run/<name>`` unless ``create_tag`` is False (the JAX package's
    ``git_run_tag``); None outside a git checkout."""
    import subprocess

    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, check=True,
            timeout=10,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    if create_tag:
        subprocess.run(["git", "tag", "-f", f"run/{name}"], capture_output=True, timeout=10)
    return commit or None


def compute_dtype(args: argparse.Namespace):
    """``--compute_dtype`` as a torch dtype."""
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.compute_dtype]


def check_ported(args: argparse.Namespace) -> None:
    """Raise for what the port refuses and the JAX package does not:
    collective payload bits outside the int8 payload's 2..8 (JAX wraps
    them)."""
    for flag in ("grad_allreduce_bits", "param_gather_bits"):
        bits = getattr(args, flag, None)
        if bits is not None and not 2 <= bits <= 8:
            raise ValueError(f"--{flag} {bits}: the payload is int8, so 2..8 bits")


def mesh_kwargs(args: argparse.Namespace, mesh, batch_size: int) -> dict:
    """The trainer's mesh arguments from a command line, and the JAX
    package's checks and mesh line: ``--batch_size`` must divide over the
    mesh (each rank takes batch_size / mesh rows)."""
    if mesh is None:
        return {}
    print(f"mesh: dp={mesh.shape['data']} x fsdp={mesh.shape['fsdp']}; "
          f"grad bits: {args.grad_allreduce_bits or 'fp32'}; "
          f"param-gather bits: {args.param_gather_bits or 'fp32'}", flush=True)
    if batch_size % mesh.size:
        raise SystemExit(
            f"--batch_size {batch_size} must be divisible by the mesh size ({mesh.size}): "
            "each device takes batch_size/mesh rows")
    return dict(mesh=mesh, grad_allreduce_bits=args.grad_allreduce_bits,
                grad_allreduce_mode=args.grad_allreduce_mode,
                param_gather_bits=args.param_gather_bits)


def mesh_plan(args: argparse.Namespace):
    """The mesh ``--dp``/``--fsdp`` ask for (``parallel/mesh.py::
    MeshShape``), or None: ``--dp 1`` (or none) with ``--fsdp 1`` is no
    mesh, as in the JAX package."""
    from smart_quantization_tpu_torch.parallel.mesh import plan_mesh

    return plan_mesh(args.dp, args.fsdp)


def check_packed(optim_comp) -> None:
    """Refuse the packed-state settings the JAX package refuses: a
    compressor other than SmaQ, bit widths beyond the uint8 codebook,
    packed momentum with a row-wise or log2 codec or without momentum
    compression, packed weights without weight compression."""
    from smart_quantization_tpu_torch.optim.compressed import packed_smaq_params

    packed_smaq_params(optim_comp)
    if optim_comp.packed_momentum and (optim_comp.momentum_rowwise or optim_comp.momentum_log_nu):
        raise ValueError(
            "--packed_momentum stores per-tensor linear uint8 codebooks and cannot honor "
            "--momentum_rowwise/--momentum_log_nu; pick one momentum representation")
    if optim_comp.packed_momentum and not optim_comp.compress_momentum:
        raise ValueError("--packed_momentum requires momentum compression; drop "
                         "--no_compress_momentum_vectors")
    if optim_comp.packed_weights and not optim_comp.compress_weights:
        raise ValueError("--packed_weights requires weight compression; drop "
                         "--no_compress_weights")


def multistep_schedule(base_lr: float, gamma: float, milestones, steps_per_epoch: int):
    """The epoch-indexed MultiStepLR as a function of the optimizer step:
    ``gamma`` applies once the count reaches each ``milestone * spe``."""
    bounds = sorted(m * steps_per_epoch for m in milestones)

    def schedule(count: int) -> float:
        return base_lr * gamma ** sum(count >= b for b in bounds)

    return schedule


def build_components(
    args: argparse.Namespace, steps_per_epoch: int | None = None
) -> dict[str, Any]:
    """Instantiate compressor / tap config / optimizer from parsed args."""
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.inject.tap import TapConfig
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )

    check_ported(args)
    compressor = None
    if args.compress_enabled:
        opts: dict[str, Any] = {"precision": args.precision}
        if args.compress == "smart":
            opts.update(
                num_samples=args.num_samples,
                use_sample_stats=args.use_sample_stats,
                stochastic_rounding=args.stochastic_rounding,
                num_bits_main=args.num_bits_main,
                num_bits_outlier=args.num_bits_outlier,
                main_std_dev_threshold=args.main_std_dev_threshold,
                outlier_std_dev_threshold=args.outlier_std_dev_threshold,
                min_size=args.min_size,
                use_range_std_dev=args.use_range_std_dev,
                use_batch_norm=args.use_batch_norm,
                bn_scalar_params=args.bn_scalar_params,
                # skip the kernel's size accounting when the ratio is not logged
                measure_sizes=args.measure_compression_ratio,
            )
        elif args.compress in FLOAT_COMPRESSORS:
            opts.update(check_inf=args.float_quantize_check_inf)
        compressor = build_compressor(args.compress, **opts)

    tap_cfg = None
    if compressor is not None:
        tap_cfg = TapConfig(
            compressor=compressor,
            compress_forward=args.compress_forward,
            compress_backward=args.compress_backward,
            use_batch_norm=getattr(args, "use_batch_norm", False),
        )
        if args.compression_hook_fn == "global_hook":
            tap_cfg = tap_cfg.as_global_hook()

    optim_comp = OptimizerCompression()
    if compressor is not None:
        optim_comp = OptimizerCompression(
            compressor=compressor,
            compress_weights=args.compress_weights,
            compress_gradients=args.compress_gradients,
            compress_momentum=args.compress_momentum_vectors,
            use_weight_accumulator=args.use_weight_accumulator,
            packed_momentum=args.packed_momentum,
            packed_weights=args.packed_weights,
            momentum_rowwise=args.momentum_rowwise,
            momentum_log_nu=args.momentum_log_nu or args.momentum_log_nu_rowwise,
            momentum_log_nu_rowwise=args.momentum_log_nu_rowwise,
        )
    if optim_comp.packed_momentum or optim_comp.packed_weights:
        check_packed(optim_comp)

    lr = args.learning_rate
    if args.scheduler_type == "multi_step":
        lr = multistep_schedule(
            args.learning_rate, args.scheduler_gamma, args.scheduler_milestones,
            steps_per_epoch or 1,
        )
    spec = build_optimizer(
        args.optimizer_type,
        lr,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        beta1=args.beta1,
        beta2=args.beta2,
        epsilon=args.epsilon,
    )
    return dict(
        compressor=compressor,
        tap_cfg=tap_cfg,
        optim_comp=optim_comp,
        optimizer_spec=spec,
    )
