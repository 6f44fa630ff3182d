"""ctypes binding of the C++ SmaQ HLS golden model (``native/smaq_golden/``)
on torch tensors.

Counterpart of ``smart_quantization_tpu/smaq_golden.py``, over the same
``native/build/libsmaq_golden.so``: ``stats`` in its three modes (0 the
one-pass sum and sum of squares, biased; 1 the range std (max - min) /
sqrt(2 ln N); 2 sixteen strided samples), ``compress``/``decompress``
(flag-bit LSB packing, scale 2^(bits-1)/3) and their BatchNorm-folded
forms.  The model runs on the host: it takes CPU tensors and refuses
others (``utils/native.py``); arrays come back as CPU tensors (int32 codes,
float32 values), statistics as floats.
"""

from __future__ import annotations

import ctypes

import torch

from smart_quantization_tpu_torch.utils.native import host, load, pointer

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("libsmaq_golden.so")
        f, fp, ip, n = (ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                        ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t)
        lib.smaq_golden_stats.argtypes = [fp, n, ctypes.c_int, fp, fp]
        lib.smaq_golden_compress.argtypes = [fp, n, f, f, ip]
        lib.smaq_golden_decompress.argtypes = [ip, n, f, f, fp]
        lib.smaq_golden_compress_bn.argtypes = [fp, n, f, f, f, f, ip]
        lib.smaq_golden_decompress_bn.argtypes = [ip, n, f, f, f, f, fp]
        for fn in (lib.smaq_golden_stats, lib.smaq_golden_compress, lib.smaq_golden_decompress,
                   lib.smaq_golden_compress_bn, lib.smaq_golden_decompress_bn):
            fn.restype = None
        _lib = lib
    return _lib


def stats(data: torch.Tensor, mode: int = 0) -> tuple[float, float]:
    """(mean, std) of ``data``: mode 0 full one-pass, 1 range std, 2
    sixteen-sample."""
    lib = _load()
    x = host(data, torch.float32, "data")
    mean, std = ctypes.c_float(), ctypes.c_float()
    lib.smaq_golden_stats(pointer(x, ctypes.c_float), x.numel(), mode, ctypes.byref(mean),
                          ctypes.byref(std))
    return mean.value, std.value


def compress(data: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    lib = _load()
    x = host(data, torch.float32, "data")
    out = torch.zeros(x.numel(), dtype=torch.int32)
    lib.smaq_golden_compress(pointer(x, ctypes.c_float), x.numel(), mean, std,
                             pointer(out, ctypes.c_int32))
    return out


def decompress(q: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    lib = _load()
    codes = host(q, torch.int32, "q")
    out = torch.zeros(codes.numel(), dtype=torch.float32)
    lib.smaq_golden_decompress(pointer(codes, ctypes.c_int32), codes.numel(), mean, std,
                               pointer(out, ctypes.c_float))
    return out


def compress_bn(data: torch.Tensor, mean: float, std: float, bn_scalar: float,
                bn_shift: float) -> torch.Tensor:
    lib = _load()
    x = host(data, torch.float32, "data")
    out = torch.zeros(x.numel(), dtype=torch.int32)
    lib.smaq_golden_compress_bn(pointer(x, ctypes.c_float), x.numel(), mean, std, bn_scalar,
                                bn_shift, pointer(out, ctypes.c_int32))
    return out


def decompress_bn(q: torch.Tensor, mean: float, std: float, bn_scalar: float,
                  bn_shift: float) -> torch.Tensor:
    lib = _load()
    codes = host(q, torch.int32, "q")
    out = torch.zeros(codes.numel(), dtype=torch.float32)
    lib.smaq_golden_decompress_bn(pointer(codes, ctypes.c_int32), codes.numel(), mean, std,
                                  bn_scalar, bn_shift, pointer(out, ctypes.c_float))
    return out
