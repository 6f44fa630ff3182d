"""Train state (counterpart of ``smart_quantization_tpu/train/state.py``).

The model (an ``nn.Module``) holds the parameters and BatchNorm statistics;
the state holds what the step owns besides them."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: dict
