"""Encoder registry (counterpart of ``smart_quantization_tpu/compress``)."""

from __future__ import annotations

from smart_quantization_tpu_torch.compress.base import (  # noqa: F401
    TAGS,
    CompressorBase,
    SizeStats,
    SizeTotals,
)
from smart_quantization_tpu_torch.compress.encoders import (  # noqa: F401
    BF16,
    FP8,
    FP16,
    FP32,
    S2FP8,
    FloatEncoder,
    SmaQ,
)
from smart_quantization_tpu_torch.ops.smaq import SmaQParams

COMPRESSORS = {
    "smart": SmaQ,
    "fp8": FP8,
    "s2fp8": S2FP8,
    "fp16": FP16,
    "bf16": BF16,
    "fp32": FP32,
}


def build_compressor(name: str, **options) -> CompressorBase:
    """Build a compressor by registry name.

    SmaQ options that belong to :class:`SmaQParams` may be passed flat
    (e.g. ``num_bits_main=6``); the fp16-mode std clamp is derived from
    ``precision``."""
    if name not in COMPRESSORS:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(COMPRESSORS)}")
    cls = COMPRESSORS[name]
    if cls is SmaQ:
        param_fields = set(SmaQParams.__dataclass_fields__)
        flat = {k: options.pop(k) for k in list(options) if k in param_fields}
        if options.get("precision", 32) == 16:
            flat.setdefault("std_clamp_lo", 1e-4)
            flat.setdefault("std_clamp_hi", 1e4)
        params = options.pop("params", None)
        if params is None:
            params = SmaQParams(**flat)
        elif flat:
            raise ValueError("pass either params= or flat SmaQParams fields, not both")
        return SmaQ(params=params, **options)
    return cls(**options)
