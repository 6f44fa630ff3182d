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
"""

from __future__ import annotations


def build_trainer(args):
    """The trainer a parsed command line asks for."""
    if args.model == "bert":
        from smart_quantization_tpu_torch.train.bert_loop import build_bert_trainer

        return build_bert_trainer(args)
    from smart_quantization_tpu_torch.data.cifar import CIFAR10Data, CIFAR100Data
    from smart_quantization_tpu_torch.models.inception import inception_v3
    from smart_quantization_tpu_torch.models.resnet import resnet18, resnet34, resnet50
    from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer
    from smart_quantization_tpu_torch.train.metrics import run_logger
    from smart_quantization_tpu_torch.utils.config import (
        build_components,
        check_ported,
        compute_dtype,
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
        logger=run_logger(args),
        device=args.device,
    )


def main(argv=None) -> dict:
    import os

    # cuBLAS reads this at its first call: set it before torch touches the
    # card, for the trainer's deterministic kernels
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from smart_quantization_tpu_torch.train.bert_loop import run_bert
    from smart_quantization_tpu_torch.train.loop import run
    from smart_quantization_tpu_torch.train.tune import tune_from_args
    from smart_quantization_tpu_torch.utils.config import git_run_tag, parse_args

    args = parse_args(argv)
    print(f"run name: {args.name}")
    if args.git:
        args.git_commit = git_run_tag(args.name)
        if args.git_commit:
            print(f"git: tagged run/{args.name} at {args.git_commit[:12]}")
    if args.model == "bert":
        return run_bert(args)  # its weights come from a generator of --seed
    torch.manual_seed(args.seed)  # the model's initial weights
    trainer = build_trainer(args)
    tune_from_args(trainer, args)
    return run(trainer, args.resume_from)


if __name__ == "__main__":
    main()
