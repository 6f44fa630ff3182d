"""BERT fine-tuning on GLUE and IMDB: the trainer with the
sequence-classification task.

Counterpart of ``smart_quantization_tpu/train/bert_loop.py``
(``BertTrainer`` and ``run_bert``, the CLI path of ``--model bert``): the
regression head for STSB and cross-entropy otherwise, GLUE metrics on the
validation split, compression, ``--compute_dtype``, ``--auto_lr_find`` and
``--auto_scale_batch_size`` wired exactly as on the image path, and the
same ``--dp``/``--fsdp`` mesh.
"""

from __future__ import annotations

from smart_quantization_tpu_torch.train.loop import Trainer, run
from smart_quantization_tpu_torch.train.task import SequenceClassificationTask


class BertTrainer(Trainer):
    """The trainer with a ``SequenceClassificationTask`` for ``task``."""

    def __init__(self, model, data, spec, *, task: str = "stsb", **kw):
        seq_task = SequenceClassificationTask(
            task_name=task, is_regression=getattr(data, "is_regression", task == "stsb"))
        super().__init__(model, data, spec, task=seq_task, **kw)


def build_bert_trainer(args, mesh=None) -> BertTrainer:
    """The trainer ``--model bert`` asks for: GLUE (``--glue_task``) or
    IMDB data, bert-base or the tiny config, pretrained weights from a
    local HF cache (bert-base only) or a fresh init from ``--seed``; on
    ``mesh`` if given (``--batch_size`` must divide over it)."""
    from smart_quantization_tpu_torch.convert import load_pretrained
    from smart_quantization_tpu_torch.data.glue import GLUEData, IMDBData
    from smart_quantization_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
    from smart_quantization_tpu_torch.train.loop import TrainConfig
    from smart_quantization_tpu_torch.train.metrics import rank_logger
    from smart_quantization_tpu_torch.utils.config import (
        build_components,
        check_ported,
        compute_dtype,
        mesh_kwargs,
    )

    check_ported(args)
    kw = dict(batch_size=args.batch_size, val_batch_size=args.val_batch_size,
              max_input_length=args.max_input_length, tokenizer_name=args.bert_model)
    if args.dataset == "glue":
        data, task = GLUEData(task=args.glue_task, **kw), args.glue_task
    else:
        data, task = IMDBData(**kw), "imdb"
    if data.synthetic:
        print("NOTE: HF datasets unavailable offline; using synthetic text data.")
    comps = build_components(args, steps_per_epoch=data.steps_per_epoch)
    cfg = BertConfig.tiny() if args.bert_size == "tiny" else BertConfig()
    model = BertForSequenceClassification(
        cfg, num_labels=data.num_labels, tap=comps["tap_cfg"],
        freeze_encoder=args.freeze_bert_encoder, seed=args.seed, dtype=compute_dtype(args),
    )
    if args.pretrained and args.bert_size == "base":
        state = load_pretrained(args.bert_model, cfg.num_layers, data.num_labels)
        if state is not None:
            model.load_state_dict(state)
    config = TrainConfig.from_args(args)
    return BertTrainer(
        model, data, comps["optimizer_spec"], task=task,
        optim_comp=comps["optim_comp"], loss_compressor=comps["compressor"], config=config,
        logger=rank_logger(args, mesh), device=args.device,
        **mesh_kwargs(args, mesh, args.batch_size),
    )


def run_bert(args, mesh=None) -> dict:
    """The CLI path of ``--model bert``: tune (``--auto_scale_batch_size``,
    ``--auto_lr_find``), resume, fit, evaluate, print ``final:``."""
    from smart_quantization_tpu_torch.train.tune import tune_from_args

    trainer = build_bert_trainer(args, mesh)
    tune_from_args(trainer, args)
    return run(trainer, args.resume_from)
