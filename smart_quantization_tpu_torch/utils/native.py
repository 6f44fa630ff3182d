"""What the port's bindings of the repo's host C++ libraries share
(``native/``: NNW-BDI and the SmaQ HLS golden model, built by
``native/Makefile`` into ``native/build/``): loading a library and taking
a tensor's host memory.

The libraries are host code, as the reference's Rust and HLS models are:
a binding takes CPU tensors and refuses a tensor on another device, so
that it never moves one off the card unasked.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def load(name: str) -> ctypes.CDLL:
    """``native/build/<name>``, made by ``make -C native`` if it is not
    there."""
    path = os.path.join(NATIVE_DIR, "build", name)
    if not os.path.exists(path):
        subprocess.run(["make", "-C", NATIVE_DIR], check=True, capture_output=True)
    return ctypes.CDLL(path)


def host(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    """``t`` flat, contiguous and of ``dtype`` in host memory; a tensor on
    another device raises (the C++ reads host memory: copy it with
    ``.cpu()`` first if that is meant)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch tensor, got {type(t).__name__}")
    if t.device.type != "cpu":
        raise ValueError(f"{what} is on {t.device}: the native library runs on the host and "
                         "takes CPU tensors (pass t.cpu())")
    return t.reshape(-1).to(dtype).contiguous()


def pointer(t: torch.Tensor, ctype):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctype))
