"""Train state (counterpart of ``smart_quantization_tpu/train/state.py``).

The model (an ``nn.Module``) holds the parameters and BatchNorm statistics;
the state holds what the step owns besides them: the step count, the
optimizer state and, under ``--packed_weights``, the packed parameter tree
(``SmaQCodes`` for the packed leaves, float32 for the rest) that the
trainer decodes into the model at each step's entry; under FSDP (a mesh
with ``fsdp`` > 1) the rank's shards of the parameters, which the step
gathers into the model.

:func:`to_saved` and :func:`from_saved` turn a state's trees into plain
dicts of tensors for ``torch.save`` (``torch.load(weights_only=True)``
reads them back): a ``SmaQCodes`` leaf becomes ``{"smaq_codes": uint8
codes, "mean", "std"}``, a ``CompressedOptState`` ``{"inner", "master"}``.
"""

from __future__ import annotations

import dataclasses

from smart_quantization_tpu_torch.ops.codebook import SmaQCodes
from smart_quantization_tpu_torch.optim.compressed import CompressedOptState


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: dict | CompressedOptState
    packed_params: dict | None = None
    # under FSDP: this rank's shard of every parameter (packed leaves as
    # SmaQCodes with (1,) stats); the optimizer state holds shards too
    shards: dict | None = None


def to_saved(tree):
    """``tree`` with every ``SmaQCodes`` and ``CompressedOptState`` as a
    plain dict."""
    if isinstance(tree, SmaQCodes):
        return {"smaq_codes": tree.codes, "mean": tree.mean, "std": tree.std}
    if isinstance(tree, CompressedOptState):
        return {"compressed_opt_state": True, "inner": to_saved(tree.inner),
                "master": to_saved(tree.master)}
    if isinstance(tree, dict):
        return {k: to_saved(v) for k, v in tree.items()}
    return tree


def from_saved(tree):
    """The inverse of :func:`to_saved`."""
    if isinstance(tree, dict):
        if "smaq_codes" in tree:
            return SmaQCodes(tree["smaq_codes"], tree["mean"], tree["std"])
        if tree.get("compressed_opt_state"):
            return CompressedOptState(from_saved(tree["inner"]), from_saved(tree["master"]))
        return {k: from_saved(v) for k, v in tree.items()}
    return tree
