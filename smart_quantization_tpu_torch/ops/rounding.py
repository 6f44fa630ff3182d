"""Rounding primitives shared by the quantizers.

Randomness comes from an explicit host-side ``torch.Generator`` (the JAX
package threads PRNG keys, ``smart_quantization_tpu/ops/rounding.py``).
A generator on the CPU is the port's key: a draw from it is a host-side
operation that never waits on the card.  Noise for a tensor on another
device comes from a generator on that device, seeded by one such draw.
"""

from __future__ import annotations

import torch

_SEED_HI = 2**62


def draw_seed(gen: torch.Generator) -> int:
    """One 62-bit seed from ``gen`` (a host draw; no device sync)."""
    return int(torch.randint(0, _SEED_HI, (), generator=gen))


def child_generator(gen: torch.Generator, device: torch.device | str = "cpu"):
    """A fresh generator on ``device`` seeded by one draw from ``gen``."""
    child = torch.Generator(device=device)
    child.manual_seed(draw_seed(gen))
    return child


def uniform(shape, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """``U[0, 1)`` float32 noise of ``shape`` on ``device`` from ``gen``."""
    if gen.device.type != torch.device(device).type:
        gen = child_generator(gen, device)
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def randint(high: int, shape, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """Integers in ``[0, high)`` of ``shape`` on ``device`` from ``gen``."""
    if gen.device.type != torch.device(device).type:
        gen = child_generator(gen, device)
    return torch.randint(0, high, shape, generator=gen, device=device)


def random_bits(shape, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """Uniform 32-bit words (int64 in ``[0, 2^32)``) of ``shape`` on
    ``device`` from ``gen``."""
    if gen.device.type != torch.device(device).type:
        gen = child_generator(gen, device)
    return torch.randint(0, 2**32, shape, generator=gen, device=device, dtype=torch.int64)


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
            raise ValueError("stochastic rounding requires a torch.Generator")
        return stochastic_round(x, gen)
    return round_trunc(x)
