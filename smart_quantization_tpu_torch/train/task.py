"""Task adapter for image classification (counterpart of
``smart_quantization_tpu/train/task.py::ImageClassificationTask``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from smart_quantization_tpu_torch.data import cifar


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


@dataclasses.dataclass(frozen=True)
class ImageClassificationTask:
    """ResNet on CIFAR: batches are ``(images_u8_nhwc, labels_i32)``; train
    prep is the on-device crop + flip + normalization, then the one
    transpose to the model's NCHW."""

    def prepare_train(self, images_u8: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return self._to_nchw(cifar.normalize(cifar.augment(images_u8, gen)))

    def prepare_eval(self, images_u8: torch.Tensor) -> torch.Tensor:
        return self._to_nchw(cifar.normalize(images_u8))

    @staticmethod
    def _to_nchw(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 3, 1, 2).contiguous()

    def loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return cross_entropy(logits, labels)

    def train_metrics(self, logits: torch.Tensor, labels: torch.Tensor) -> dict:
        acc = (logits.argmax(-1) == labels).float().mean()
        return {"train_accuracy": acc}

    def eval_outputs(self, logits: torch.Tensor, labels: torch.Tensor) -> dict:
        correct = (logits.argmax(-1) == labels).float().sum()
        return {"loss": self.loss(logits, labels), "correct": correct}

    def eval_summary(self, outs: dict, count: int) -> dict:
        return {
            "val_loss": float(np.mean(outs["loss"])),
            "val_accuracy": float(np.sum(outs["correct"])) / count,
        }
