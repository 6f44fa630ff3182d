"""Rounding primitives shared by the quantizers.

Randomness comes from an explicit key (the JAX package threads PRNG keys,
``smart_quantization_tpu/ops/rounding.py``), one of two kinds:

- a host ``torch.Generator`` (the CPU trainer, initialization, tests): a
  draw from it is a host-side operation that never waits on the card, and
  noise for a tensor on another device comes from a generator on that
  device, seeded by one such draw;
- a :class:`~smart_quantization_tpu_torch.ops.keys.DeviceKey` (a training
  step on the card): each draw takes the next call index of the step key
  and fills its noise through the Philox fill (``ops/cuda/
  philox_kernel.py``), so that a CUDA graph of the step replays it with
  each replay's key.

Either may come as a :class:`~smart_quantization_tpu_torch.ops.keys.
PartKey`: the draw of a part of a larger tensor is the whole's, cut to the
part (the fill from the part's offset; a host draw of the whole, sliced).
"""

from __future__ import annotations

import math

import torch

from smart_quantization_tpu_torch.ops.cuda.philox_kernel import philox_fill_or_reference
from smart_quantization_tpu_torch.ops.keys import DeviceKey, check_part, draw_seed, split_key


def _fill(shape, key: DeviceKey, device, uniform: bool, offset: int = 0) -> torch.Tensor:
    if key.device != torch.device(device):
        raise ValueError(f"step key on {key.device}, noise asked for on {device}")
    n = math.prod(shape)
    return philox_fill_or_reference(n, key.key, key.take(), uniform=uniform,
                                    offset=offset).view(shape)


def _words(shape, key: DeviceKey, device, offset: int = 0) -> torch.Tensor:
    """The fill's 32-bit words as int64 in ``[0, 2^32)``."""
    return _fill(shape, key, device, False, offset).to(torch.int64) & 0xFFFFFFFF


def _host_draw(draw, shape, gen: torch.Generator, device, offset: int, total: int | None):
    """``draw(shape, generator)`` from a host generator (through a child
    generator on ``device``), or of a part: the whole's ``total`` elements
    drawn, the part's ``[offset, offset + n)`` kept."""
    if gen.device.type != torch.device(device).type:
        gen = child_generator(gen, device)
    if total is None:
        return draw(shape, gen)
    n = math.prod(shape)
    return draw((total,), gen)[offset:offset + n].view(shape)


def child_generator(gen: torch.Generator, device: torch.device | str = "cpu"):
    """A fresh generator on ``device`` seeded by one draw from ``gen``."""
    child = torch.Generator(device=device)
    child.manual_seed(draw_seed(gen))
    return child


def uniform(shape, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """``U[0, 1)`` float32 noise of ``shape`` on ``device`` from ``gen``."""
    gen, offset, total = split_key(gen)
    check_part(math.prod(shape), offset, total)
    if isinstance(gen, DeviceKey):
        return _fill(shape, gen, device, True, offset)
    return _host_draw(lambda s, g: torch.rand(s, generator=g, device=device, dtype=torch.float32),
                      shape, gen, device, offset, total)


def randint(high: int, shape, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """Integers in ``[0, high)`` of ``shape`` on ``device`` from ``gen``
    (from a step key: ``(w * high) >> 32`` of a 32-bit word ``w``)."""
    gen, offset, total = split_key(gen)
    check_part(math.prod(shape), offset, total)
    if isinstance(gen, DeviceKey):
        if not 0 < high < 2**31:
            raise ValueError(f"randint from a step key takes 0 < high < 2^31, got {high}")
        return (_words(shape, gen, device, offset) * high) >> 32
    return _host_draw(lambda s, g: torch.randint(0, high, s, generator=g, device=device),
                      shape, gen, device, offset, total)


def random_bits(shape, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """Uniform 32-bit words (int64 in ``[0, 2^32)``) of ``shape`` on
    ``device`` from ``gen``."""
    gen, offset, total = split_key(gen)
    check_part(math.prod(shape), offset, total)
    if isinstance(gen, DeviceKey):
        return _words(shape, gen, device, offset)
    return _host_draw(lambda s, g: torch.randint(0, 2**32, s, generator=g, device=device,
                                                 dtype=torch.int64),
                      shape, gen, device, offset, total)


def stochastic_round(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``floor(x) + (frac(x) > u)`` with ``u ~ U[0, 1)``: E[result] == x."""
    floored = torch.floor(x)
    frac = x - floored
    u = uniform(x.shape, gen, x.device)
    return floored + (frac > u).to(x.dtype)


def round_trunc(x: torch.Tensor) -> torch.Tensor:
    """Round toward zero (the non-stochastic mode)."""
    return torch.trunc(x)


def round_to_grid(
    x: torch.Tensor, gen: torch.Generator | None, stochastic: bool
) -> torch.Tensor:
    if stochastic:
        if gen is None:
            raise ValueError("stochastic rounding requires a torch.Generator or a DeviceKey")
        return stochastic_round(x, gen)
    return round_trunc(x)
