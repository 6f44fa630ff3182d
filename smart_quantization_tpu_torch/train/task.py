"""Task adapters: what the trainer's step and evaluation take from the
model family (counterparts of ``smart_quantization_tpu/train/task.py``'s
``ImageClassificationTask`` and ``SequenceClassificationTask``).

A task prepares a batch on the device, turns it into the model's
positional arguments (``model(*task.model_args(inputs), tap_ctx)``), and
supplies the loss, the training metrics (device tensors) and the eval
reduction, which runs on the host once at the end of the split.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from smart_quantization_tpu_torch.data import cifar
from smart_quantization_tpu_torch.data.glue import INPUT_KEYS


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


@dataclasses.dataclass(frozen=True)
class ImageClassificationTask:
    """ResNet or Inception-v3 on CIFAR: batches are ``(images_u8_nhwc,
    labels_i32)``; train prep is the on-device crop + flip + normalization,
    then the one transpose to the model's NCHW."""

    def prepare_train(self, images_u8: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return self._to_nchw(cifar.normalize(cifar.augment(images_u8, gen)))

    def prepare_eval(self, images_u8: torch.Tensor) -> torch.Tensor:
        return self._to_nchw(cifar.normalize(images_u8))

    @staticmethod
    def _to_nchw(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2).contiguous()

    def model_args(self, x: torch.Tensor) -> tuple:
        return (x,)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return cross_entropy(logits, labels)

    def train_metrics(self, logits: torch.Tensor, labels: torch.Tensor) -> dict:
        acc = (logits.argmax(-1) == labels).float().mean()
        return {"train_accuracy": acc}

    def eval_outputs(self, logits: torch.Tensor, labels: torch.Tensor) -> dict:
        correct = (logits.argmax(-1) == labels).float().sum()
        return {"loss": self.loss(logits, labels), "correct": correct}

    def eval_summary(self, outs: dict, labels: np.ndarray, count: int) -> dict:
        return {
            "val_loss": float(np.mean(outs["loss"])),
            "val_accuracy": float(np.sum(outs["correct"])) / count,
        }


@dataclasses.dataclass(frozen=True)
class SequenceClassificationTask:
    """BERT fine-tuning on GLUE/IMDB: batches are ``(inputs, labels)`` with
    ``inputs`` a dict of ``input_ids``, ``attention_mask`` and
    ``token_type_ids``; STSB takes the regression head (MSE on
    ``logits[:, 0]``), every other task cross-entropy; eval collects the
    predictions and computes the GLUE metrics on the host."""

    task_name: str = "stsb"
    is_regression: bool = True

    def prepare_train(self, inputs: dict, gen: torch.Generator) -> dict:
        return inputs

    def prepare_eval(self, inputs: dict) -> dict:
        return inputs

    def model_args(self, inputs: dict) -> tuple:
        return tuple(inputs[k] for k in INPUT_KEYS)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if self.is_regression:
            return torch.mean((logits[:, 0] - labels) ** 2)
        return cross_entropy(logits, labels)

    def train_metrics(self, logits: torch.Tensor, labels: torch.Tensor) -> dict:
        return {}

    def eval_outputs(self, logits: torch.Tensor, labels: torch.Tensor) -> dict:
        preds = logits[:, 0] if self.is_regression else logits.argmax(-1)
        return {"pred": preds, "loss": self.loss(logits, labels)}

    def eval_summary(self, outs: dict, labels: np.ndarray, count: int) -> dict:
        from smart_quantization_tpu_torch.train.glue_metrics import glue_metrics

        preds = np.asarray(outs["pred"]).reshape(-1)
        out = {"val_loss": float(np.mean(outs["loss"]))}
        out.update({f"val_{k}": v for k, v in glue_metrics(self.task_name, preds, labels).items()})
        return out
