"""Layer-type taxonomy: which layer outputs get compression taps.

Counterpart of ``smart_quantization_tpu/inject/policy.py``: every model
calls ``module_tap(x, kind, ...)`` at layer boundaries and the policy
decides per *kind*.  The default covers conv, linear, pool and
normalization, plus activations, containers and block outputs.
"""

from __future__ import annotations

import dataclasses
import enum


class LayerKind(enum.Enum):
    CONV = "conv"
    LINEAR = "linear"
    POOL = "pool"
    PAD = "pad"
    ACTIVATION = "activation"
    NORM = "normalization"
    DROPOUT = "dropout"
    LOSS = "loss"
    CONTAINER = "container"
    BLOCK = "block"
    EMBED = "embed"
    ATTENTION = "attention"


_DEFAULT = {LayerKind.CONV, LayerKind.LINEAR, LayerKind.POOL, LayerKind.NORM}
_FALLBACK = {LayerKind.ACTIVATION, LayerKind.CONTAINER, LayerKind.BLOCK}


@dataclasses.dataclass(frozen=True)
class TapPolicy:
    kinds: frozenset = frozenset(k.value for k in (_DEFAULT | _FALLBACK))

    @staticmethod
    def of(*kinds: LayerKind | str) -> "TapPolicy":
        return TapPolicy(
            frozenset(k.value if isinstance(k, LayerKind) else k for k in kinds)
        )

    def should_tap(self, kind: LayerKind | str) -> bool:
        kind = kind.value if isinstance(kind, LayerKind) else kind
        return kind in self.kinds


DEFAULT_POLICY = TapPolicy()
