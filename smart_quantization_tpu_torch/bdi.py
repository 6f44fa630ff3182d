"""ctypes binding of the native NNW-BDI library (``native/bdi/``) on torch
tensors.

Counterpart of ``smart_quantization_tpu/bdi.py``, over the same
``native/build/libbdi.so``, with its API: ``CompressionBaseConfig``,
``CompressionConfig``, ``replace_with_compressed_repr(config, buffer,
dest, scale, zero_point)`` (compress the 32-bit words of ``buffer``,
decompress at once, write the dequantized floats into ``dest``) and
``compress_line_exact`` (one line, deterministic: ``[bases..., deltas...]``).
Words are a CPU tensor of ``torch.uint32`` (or an integer tensor holding
them); ``dest`` a float32 CPU tensor, written in place.  The library runs
on the host: a tensor on another device raises (``utils/native.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from smart_quantization_tpu_torch.utils.native import host, load, pointer

_lib = None


class _ConfigC(ctypes.Structure):
    _fields_ = [("num_bases", ctypes.c_size_t), ("base_size", ctypes.c_size_t),
                ("delta_size", ctypes.c_size_t)]


class _OptionsC(ctypes.Structure):
    _fields_ = [
        ("batch_size", ctypes.c_size_t),
        ("scale_factor_init", ctypes.c_size_t),
        ("scale_factor_base", ctypes.c_size_t),
        ("scale_factor_delta", ctypes.c_size_t),
        ("use_stochastic_rounding", ctypes.c_int),
        ("use_zero_compression", ctypes.c_int),
        ("use_randomized_base_selection", ctypes.c_int),
        ("seed", ctypes.c_uint64),
        ("num_threads", ctypes.c_int),
    ]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("libbdi.so")
        opt, cfg = ctypes.POINTER(_OptionsC), ctypes.POINTER(_ConfigC)
        n, u32p = ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint32)
        lib.bdi_replace_with_compressed_repr.restype = n
        lib.bdi_replace_with_compressed_repr.argtypes = [
            opt, cfg, n, u32p, n, ctypes.POINTER(ctypes.c_float), ctypes.c_float, n,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.bdi_compress_line_exact.restype = n
        lib.bdi_compress_line_exact.argtypes = [opt, cfg, n, u32p, n, u32p, n]
        _lib = lib
    return _lib


@dataclasses.dataclass
class CompressionBaseConfig:
    num_bases: int
    base_size: int
    delta_size: int
    name: str = ""


@dataclasses.dataclass
class CompressionConfig:
    base_configs: list
    batch_size: int = 64
    scale_factor_init: int = 0
    scale_factor_base: int = 0
    scale_factor_delta: int = 0
    use_randomized_base_selection: bool = True
    use_stochastic_rounding: bool = True
    use_zero_compression: bool = True
    seed: int = 0
    num_threads: int = 0


def _pack(config: CompressionConfig):
    opt = _OptionsC(config.batch_size, config.scale_factor_init, config.scale_factor_base,
                    config.scale_factor_delta, int(config.use_stochastic_rounding),
                    int(config.use_zero_compression), int(config.use_randomized_base_selection),
                    config.seed, config.num_threads)
    cfgs = (_ConfigC * len(config.base_configs))(
        *[_ConfigC(c.num_bases, c.base_size, c.delta_size) for c in config.base_configs])
    return opt, cfgs, len(config.base_configs)


def _words(t: torch.Tensor, what: str) -> torch.Tensor:
    """32-bit words as a uint32 CPU tensor: uint32 as it is, another
    integer dtype by its low 32 bits."""
    if t.dtype == torch.uint32:
        return host(t, torch.uint32, what)
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise TypeError(f"{what} holds 32-bit words: an integer tensor, got {t.dtype}")
    return host(t, torch.int64, what).bitwise_and(0xFFFFFFFF).to(torch.uint32)


def replace_with_compressed_repr(config: CompressionConfig, buffer: torch.Tensor,
                                 dest: torch.Tensor, scale: float, zero_point: int):
    """Compress ``buffer``'s words and write the dequantized floats into
    ``dest`` (float32, as many elements, contiguous); returns
    ``(compressed_bits, scheme_ids, (comp_ns, decomp_ns))``, the scheme ids
    an int32 tensor, one a line."""
    lib = _load()
    words = _words(buffer, "buffer")
    if dest.dtype != torch.float32 or dest.numel() != words.numel() or not dest.is_contiguous():
        raise ValueError("dest must be a contiguous float32 tensor of as many elements as buffer")
    host(dest, torch.float32, "dest")
    opt, cfgs, n_cfg = _pack(config)
    n = words.numel()
    scheme_ids = torch.zeros(-(-n // (config.batch_size or 64)), dtype=torch.int32)
    comp_ns, decomp_ns = ctypes.c_uint64(), ctypes.c_uint64()
    bits = lib.bdi_replace_with_compressed_repr(
        ctypes.byref(opt), cfgs, n_cfg, pointer(words, ctypes.c_uint32), n,
        pointer(dest, ctypes.c_float), scale, zero_point, pointer(scheme_ids, ctypes.c_int32),
        ctypes.byref(comp_ns), ctypes.byref(decomp_ns))
    if bits == 0:
        raise RuntimeError("BDI compression failed")
    return int(bits), scheme_ids, (comp_ns.value, decomp_ns.value)


def compress_line_exact(config: CompressionConfig, line: torch.Tensor) -> torch.Tensor:
    """One line compressed deterministically (no stochastic rounding,
    first-fit base): ``[bases..., deltas...]`` as a uint32 tensor."""
    lib = _load()
    words = _words(line, "line")
    opt, cfgs, n_cfg = _pack(config)
    out = torch.zeros(words.numel() * 2 + 16, dtype=torch.uint32)
    written = lib.bdi_compress_line_exact(ctypes.byref(opt), cfgs, n_cfg,
                                          pointer(words, ctypes.c_uint32), words.numel(),
                                          pointer(out, ctypes.c_uint32), out.numel())
    if written == 0:
        raise RuntimeError("BDI compression failed")
    return out[:written].clone()
