"""Train entry point of the port (the counterpart of the repo's ``train.py``).

Examples:
  python -m smart_quantization_tpu_torch.train --model resnet \\
      --resnet_model resnet18 --dataset cifar10 --compress smart \\
      --measure_compression_ratio --max_epochs 5 --batch_size 128
  python -m smart_quantization_tpu_torch.train --model bert --dataset glue \\
      --glue_task stsb --compress smart --optimizer_type adamw \\
      --learning_rate 2e-5 --weight_decay 0.01 --measure_compression_ratio
  python -m smart_quantization_tpu_torch.train --model inception --dataset cifar10 \\
      --compress smart --measure_compression_ratio --batch_size 128
  python -m smart_quantization_tpu_torch.train --device cpu --compress fp32 \\
      --limit_train_batches 10
  python -m smart_quantization_tpu_torch.train --model bert --bert_size tiny \\
      --device cpu --compress smart --optimizer_type adamw --max_input_length 32 \\
      --momentum_rowwise --momentum_log_nu --limit_train_batches 4
  python -m smart_quantization_tpu_torch.train --compress smart --packed_momentum \\
      --packed_weights --checkpoint_dir ckpt   # then --resume_from ckpt/epoch_0000.pt
  python -m smart_quantization_tpu_torch.train --resnet_model resnet18 --compress smart \\
      --compute_dtype bfloat16 --batch_size 128 --auto_lr_find --git
  python -m smart_quantization_tpu_torch.train --dp 2 --grad_allreduce_bits 8 --device cpu
  torchrun --nproc_per_node 4 -m smart_quantization_tpu_torch.train --dp 2 --fsdp 2 \\
      --compress smart --param_gather_bits 8 --packed_momentum --packed_weights
"""

from __future__ import annotations

import contextlib
import os
import sys

# the CLI's own ranks are joined with this timeout, beyond --max_time (a
# collective that waits for a hung rank raises sooner, after
# parallel/distributed.py's DEFAULT_TIMEOUT_S)
SPAWN_TIMEOUT_S = 3 * 24 * 3600.0


def build_trainer(args, mesh=None):
    """The trainer a parsed command line asks for, on ``mesh`` if given
    (``parallel/mesh.py``; rank 0 alone logs)."""
    if args.model == "bert":
        from smart_quantization_tpu_torch.train.bert_loop import build_bert_trainer

        return build_bert_trainer(args, mesh)
    from smart_quantization_tpu_torch.data.cifar import CIFAR10Data, CIFAR100Data
    from smart_quantization_tpu_torch.models.inception import inception_v3
    from smart_quantization_tpu_torch.models.resnet import resnet18, resnet34, resnet50
    from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer
    from smart_quantization_tpu_torch.train.metrics import rank_logger
    from smart_quantization_tpu_torch.utils.config import (
        build_components,
        check_ported,
        compute_dtype,
        mesh_kwargs,
    )

    check_ported(args)
    data_cls = {"cifar10": CIFAR10Data, "cifar100": CIFAR100Data}[args.dataset]
    data = data_cls(batch_size=args.batch_size, val_batch_size=args.val_batch_size)
    comps = build_components(args, steps_per_epoch=data.steps_per_epoch)
    if data.synthetic:
        print("NOTE: CIFAR archives not found under $SMAQ_DATA_DIR; "
              "using the synthetic stand-in dataset.")
    if args.model == "inception":
        model_fn = inception_v3
    else:
        model_fn = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}[
            args.resnet_model]
    model = model_fn(num_classes=data.num_classes, tap=comps["tap_cfg"],
                     dtype=compute_dtype(args))
    cfg = TrainConfig.from_args(args)
    return Trainer(
        model,
        data,
        comps["optimizer_spec"],
        optim_comp=comps["optim_comp"],
        loss_compressor=comps["compressor"],
        config=cfg,
        logger=rank_logger(args, mesh),
        device=args.device,
        **mesh_kwargs(args, mesh, args.batch_size),
    )


def join_mesh(args):
    """This process's place on the mesh ``--dp``/``--fsdp`` ask for (None
    for no mesh): join the process group (``torchrun``'s environment or the
    CLI's own spawn) and take the rank's device."""
    from smart_quantization_tpu_torch.parallel.distributed import init_distributed
    from smart_quantization_tpu_torch.parallel.mesh import make_mesh, plan_mesh
    from smart_quantization_tpu_torch.utils.config import mesh_plan

    if mesh_plan(args) is None:
        return None
    info = init_distributed(args.device)
    try:  # --dp left out fills the launcher's ranks, as in the JAX package
        plan = plan_mesh(args.dp, args.fsdp, info["world_size"])
    except ValueError as e:
        raise SystemExit(f"{e}: the launcher started {info['world_size']} ranks") from e
    args.device = str(info["device"])
    return make_mesh(plan.dp, plan.fsdp)


def train(args, mesh) -> dict:
    """Build, tune, resume, fit and evaluate what ``args`` asks for."""
    import torch

    from smart_quantization_tpu_torch.train.bert_loop import run_bert
    from smart_quantization_tpu_torch.train.loop import run
    from smart_quantization_tpu_torch.train.tune import tune_from_args
    from smart_quantization_tpu_torch.utils.config import git_run_tag

    print(f"run name: {args.name}")
    if args.git:
        args.git_commit = git_run_tag(args.name)
        if args.git_commit:
            print(f"git: tagged run/{args.name} at {args.git_commit[:12]}")
    if args.model == "bert":
        return run_bert(args, mesh)  # its weights come from a generator of --seed
    torch.manual_seed(args.seed)  # the model's initial weights, the same on every rank
    trainer = build_trainer(args, mesh)
    tune_from_args(trainer, args)
    return run(trainer, args.resume_from)


def main(argv=None) -> dict:
    # cuBLAS reads this at its first call: set it before torch touches the
    # card, for the trainer's deterministic kernels
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from smart_quantization_tpu_torch.parallel.distributed import STORE_ENV, is_primary, spawn
    from smart_quantization_tpu_torch.utils.config import check_ported, mesh_plan, parse_args

    args = parse_args(argv)
    check_ported(args)
    plan = mesh_plan(args)
    if (plan is not None and int(os.environ.get("WORLD_SIZE", 1)) <= 1
            and STORE_ENV not in os.environ):
        # no launcher: start the mesh's ranks here, as Lightning's DDP spawn did
        spawn("smart_quantization_tpu_torch.train.__main__",
              sys.argv[1:] if argv is None else argv, plan.size,
              "cpu" if args.device == "cpu" else "cuda",
              SPAWN_TIMEOUT_S + (args.max_time or 0.0))
        return {}
    mesh = join_mesh(args)
    if not is_primary():
        # rank 0 alone speaks (and tags the repository under --git)
        args.git = False
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            return train(args, mesh)
    return train(args, mesh)


if __name__ == "__main__":
    main()
