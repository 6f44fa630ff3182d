"""Philox4x32-10 words from a 64-bit step key and a call index, in int64
tensor arithmetic on any device.

The stochastic rounding of the program under test and the dropout masks
of BERT draw their noise from one scheme: a step key, a call index mixed
into it by splitmix64's output function, then Philox4x32-10 on the
element's group of four as the counter.  This is that scheme, written
from its definition (Salmon et al., SC'11; splitmix64), so the reference
rounds every element with the bits the program's kernels use for it.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
U64 = 2**64 - 1
MIX_GAMMA = 0x9E3779B97F4A7C15
MIX_M1 = 0xBF58476D1CE4E5B9
MIX_M2 = 0x94D049BB133111EB
MIX_SHIFTS = (30, 27, 31)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def mix(key: int, call: int) -> int:
    """The Philox key of draw ``call`` of a step keyed ``key``: splitmix64's
    output function on ``key + (call + 1) * gamma``."""
    s1, s2, s3 = MIX_SHIFTS
    z = (key + (call + 1) * MIX_GAMMA) & U64
    z = ((z ^ (z >> s1)) * MIX_M1) & U64
    z = ((z ^ (z >> s2)) * MIX_M2) & U64
    return z ^ (z >> s3)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``m * x`` for 32-bit values in int64,
    through 16-bit halves of ``x`` (no product exceeds 2^49)."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & U32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(ctr: tuple, k0: int, k1: int) -> tuple:
    """Ten rounds of Philox4x32 on four int64 tensors of 32-bit values."""
    c0, c1, c2, c3 = ctr
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & U32
        k1 = (k1 + PHILOX_W[1]) & U32
    return c0, c1, c2, c3


def words(n: int, key: int, call: int, device) -> torch.Tensor:
    """The ``n`` 32-bit words (int64 in ``[0, 2^32)``) of draw ``call`` of
    step key ``key``: element e takes word e % 4 of the group e // 4."""
    k = mix(key, call)
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    out = philox4x32_10((g & U32, g >> 32, zero, zero), k & U32, k >> 32)
    return torch.stack(out, 1).reshape(-1)[:n]


def uniform(n: int, key: int, call: int, device) -> torch.Tensor:
    """``U[0, 1)`` float32 from the top 24 bits of each word."""
    return (words(n, key, call, device) >> 8).to(torch.float32) * 2.0**-24
