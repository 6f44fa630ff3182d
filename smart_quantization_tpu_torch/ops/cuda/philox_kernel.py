"""Random words from a step key in device memory: the wrapper of
``csrc/philox_fill.cu``, its plain PyTorch version, and the dispatcher.

Not the port of a TPU kernel (the JAX package draws its tensor-op noise with
``jax.random``): the fill gives the port's tensor-op noise on the card (the
codebook, the row-wise and log2 codecs, the packer, the float formats' plain
path, BERT's dropout and the sampled-stats offset) the key scheme of the
quantize kernels, so that a CUDA graph of a step draws what an eager step
draws (``ops/keys.py``).  Here:

- ``philox_fill`` launches the kernel on PyTorch's current stream and counts
  its launches in ``LAUNCHES``;
- ``philox_fill_reference`` is its plain version: Philox4x32-10 and the key
  mix in int64 tensor arithmetic, on any device, reading the key from the
  tensor (no host sync); the card's words are its words, bit for bit;
- ``philox_fill_or_reference`` sends a CUDA key to the kernel and a CPU key
  to the plain version.

Word ``e`` of a fill is the word a quantize kernel gives element ``e`` for
the same (key, call) and element offset (``offset``: the fill of a part of
a larger tensor, from its element ``offset`` on); ``uniform=True`` turns it
into ``(w >> 8) * 2^-24``.
"""

from __future__ import annotations

import torch

from smart_quantization_tpu_torch.ops.cuda import build
from smart_quantization_tpu_torch.ops.cuda.launch import (
    THREADS,
    check_offset,
    quant_blocks,
    raise_on,
    stream,
)
from smart_quantization_tpu_torch.ops.keys import MIX_GAMMA, MIX_M1, MIX_M2, MIX_SHIFTS

# Launches of the kernel since the last reset (one per launch, nowhere else).
LAUNCHES = {"philox_fill": 0}

# Philox4x32-10's multipliers and Weyl increments (csrc/philox.cuh)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_key(key: torch.Tensor) -> None:
    if key.dtype != torch.int64 or key.numel() != 1:
        raise ValueError(f"a step key is one int64 word, got {key.dtype} x {key.numel()}")


def philox_fill(n: int, key: torch.Tensor, call: int, *, uniform: bool,
                offset: int = 0) -> torch.Tensor:
    """Launch the fill: ``n`` words of (``key``, ``call``) on ``key``'s
    card from element ``offset`` on, int32 bit patterns or float32
    uniforms in [0, 1)."""
    _check_key(key)
    check_offset(offset)
    if not key.is_cuda:
        raise ValueError(f"philox_fill takes a key on the card, got {key.device}")
    out = torch.empty(n, dtype=torch.float32 if uniform else torch.int32, device=key.device)
    if n == 0:
        return out
    rc = build.library().philox_fill(
        out.data_ptr(), n, key.data_ptr(), call, offset, int(uniform), quant_blocks(n), THREADS,
        stream(out),
    )
    raise_on(rc, "philox_fill")
    LAUNCHES["philox_fill"] += 1
    return out


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 words holding 64-bit values."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def mix_reference(key: torch.Tensor, call: int) -> torch.Tensor:
    """``keys.mix`` in int64 tensor arithmetic (wrapping, as uint64 does):
    the Philox key as a 1-element int64 tensor on ``key``'s device."""
    s1, s2, s3 = MIX_SHIFTS
    z = key.reshape(1) + _signed(((call + 1) * MIX_GAMMA) & (2**64 - 1))
    z = (z ^ _srl(z, s1)) * _signed(MIX_M1)
    z = (z ^ _srl(z, s2)) * _signed(MIX_M2)
    return z ^ _srl(z, s3)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``m * x`` for 32-bit values held in
    int64, through 16-bit halves of ``x`` (no product exceeds 2^49)."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _U32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr: tuple, key: tuple) -> tuple:
    """Philox4x32-10 on int64 tensors of 32-bit values: four counter words,
    two key words (tensors that broadcast against them)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _U32
        k1 = (k1 + _W1) & _U32
    return c0, c1, c2, c3


def philox_fill_reference(n: int, key: torch.Tensor, call: int, *, uniform: bool,
                          offset: int = 0) -> torch.Tensor:
    """The fill's plain version on ``key``'s device: the same words."""
    _check_key(key)
    check_offset(offset)
    dev = key.device
    k = mix_reference(key, call)
    k0, k1 = k & _U32, _srl(k, 32)
    g = torch.arange(offset // 4, (offset + n + 3) // 4, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(g)
    words = torch.stack(philox4x32_10((g & _U32, _srl(g, 32), zero, zero), (k0, k1)), 1)
    words = words.reshape(-1)[offset % 4:offset % 4 + n]
    if uniform:
        return (words >> 8).to(torch.float32) * 2.0**-24
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def philox_fill_or_reference(n: int, key: torch.Tensor, call: int, *, uniform: bool,
                             offset: int = 0) -> torch.Tensor:
    """A key on the card goes to the kernel, a CPU key to the plain version."""
    if key.is_cuda:
        return philox_fill(n, key, call, uniform=uniform, offset=offset)
    if key.device.type == "cpu":
        return philox_fill_reference(n, key, call, uniform=uniform, offset=offset)
    raise ValueError(f"no Philox fill for device {key.device}")
