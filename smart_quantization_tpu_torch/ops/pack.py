"""Bit-packed SmaQ buffers: the dense b_main-bit checkpoint packer.

The counterpart of ``smart_quantization_tpu/ops/pack.py``.  A tensor packs
into 32-bit words holding every element's main-bucket code (b_main bits),
one outlier flag bit an element, and the outlier-bucket codes (b_out bits)
of the first ``capacity`` outliers in scan order, plus the float32 mean and
std.  An outlier past the capacity decodes from its main-bucket code (an
accuracy cost, never a correctness one).  About ``n (b_main + 1) +
capacity b_out + 64`` bits: 10.2 bits an element at 6/8 bits and the
default 40 % capacity.

Words are int32 tensors holding the 32-bit patterns (``view(uint32)`` in
numpy gives the JAX package's words); the shifts run in int64, so no shift
leaves its range at any width from 1 to 32 bits.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from smart_quantization_tpu_torch.ops.rounding import round_to_grid
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, compute_stats

_WORD = (1 << 32) - 1


def _positions(n: int, bits: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(word index, bit offset) of each of ``n`` ``bits``-bit values."""
    pos = torch.arange(n, dtype=torch.int64, device=device) * bits
    return pos >> 5, pos & 31


def pack_bits(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack ``vals`` (integers in ``[0, 2^bits)``) into dense 32-bit words."""
    n = vals.numel()
    n_words = -(-n * bits // 32)
    word, off = _positions(n, bits, vals.device)
    v = vals.reshape(-1).to(torch.int64)
    lo = (v << off) & _WORD
    hi = v >> (32 - off)  # the part that straddles into the next word
    words = torch.zeros(n_words + 1, dtype=torch.int64, device=vals.device)
    # the bits are disjoint, so the sums are ORs
    words.index_add_(0, word, lo).index_add_(0, word + 1, hi)
    words = words[:n_words]
    return (words - ((words >> 31) << 32)).to(torch.int32)


def unpack_bits(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``n`` values as int64."""
    word, off = _positions(n, bits, words.device)
    padded = torch.cat([words.to(torch.int64) & _WORD,
                        torch.zeros(1, dtype=torch.int64, device=words.device)])
    lo = padded[word] >> off
    hi = torch.where(off == 0, 0, (padded[word + 1] << (32 - off)) & _WORD)
    return (lo | hi) & ((1 << bits) - 1)


class PackedSmaQ(NamedTuple):
    main: torch.Tensor  # packed b_main-bit codes, one an element
    flags: torch.Tensor  # packed 1-bit outlier flags
    outliers: torch.Tensor  # packed b_out-bit codes of the first capacity outliers
    mean: torch.Tensor
    std: torch.Tensor
    n_outliers: torch.Tensor  # the actual count, for the ratio


@dataclasses.dataclass(frozen=True)
class PackSpec:
    params: SmaQParams = SmaQParams()
    outlier_capacity_frac: float = 0.40  # a Gaussian's |z| > 1 is about 31.7 %

    def capacity(self, n: int) -> int:
        return max(1, int(n * self.outlier_capacity_frac))

    def packed_bits(self, n: int) -> int:
        p = self.params
        return n * (p.num_bits_main + 1) + self.capacity(n) * p.num_bits_outlier + 64


def smaq_pack(x: torch.Tensor, gen: torch.Generator | None,
              spec: PackSpec = PackSpec()) -> PackedSmaQ:
    """Pack ``x``; draws from ``gen`` for the sampled stats, then the main
    codes' rounding, then the outlier codes'."""
    p = spec.params
    flat = x.reshape(-1).float()
    n = flat.numel()
    mean, std = compute_stats(flat, p, gen)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    std = std.clamp(p.std_clamp_lo, p.std_clamp_hi)

    t = p.main_std_dev_threshold
    z = (flat - mean) / std
    hi, lo = z > t, z < -t
    outlier = hi | lo
    shift = hi.float() * -t + lo.float() * t

    # every element's main-bucket code (clamped into range): an outlier
    # beyond the capacity decodes from it
    main_max = 2 ** (p.num_bits_main - 2) - 1
    qm = round_to_grid(z.clamp(-t, t) * p.range_main, gen, p.stochastic_rounding)
    main_codes = qm.clamp(-main_max - 1, main_max).to(torch.int64) + main_max + 1

    # outlier codes, clamped at the outlier threshold
    out_max = 2 ** (p.num_bits_outlier - 2) - 1
    zo = z.clamp(-p.outlier_std_dev_threshold, p.outlier_std_dev_threshold)
    qo = round_to_grid((zo + shift) * p.range_outlier, gen, p.stochastic_rounding)
    out_codes = qo.clamp(-out_max - 1, out_max).to(torch.int64) + out_max + 1

    # the first `capacity` outliers in scan order, zero-padded
    cap = spec.capacity(n)
    kept = out_codes[outlier][:cap]
    gathered = torch.cat([kept, kept.new_zeros(cap - kept.numel())])
    return PackedSmaQ(
        main=pack_bits(main_codes, p.num_bits_main),
        flags=pack_bits(outlier.to(torch.int64), 1),
        outliers=pack_bits(gathered, p.num_bits_outlier),
        mean=mean,
        std=std,
        n_outliers=outlier.sum().float(),
    )


def smaq_unpack(packed: PackedSmaQ, n: int, spec: PackSpec = PackSpec()) -> torch.Tensor:
    """The ``n`` values of ``packed`` (flat float32)."""
    p = spec.params
    t = p.main_std_dev_threshold
    main_max = 2 ** (p.num_bits_main - 2) - 1
    out_max = 2 ** (p.num_bits_outlier - 2) - 1
    cap = spec.capacity(n)

    main_codes = unpack_bits(packed.main, p.num_bits_main, n)
    flags = unpack_bits(packed.flags, 1, n).bool()
    out_codes = unpack_bits(packed.outliers, p.num_bits_outlier, cap)

    z_main = (main_codes - (main_max + 1)).float() / p.range_main
    order = torch.cumsum(flags.to(torch.int64), 0) - 1
    in_cap = flags & (order < cap)
    padded = torch.cat([out_codes, out_codes.new_zeros(1)])
    qo = padded[torch.where(in_cap, order, cap)] - (out_max + 1)
    # an outlier's side comes from its main code (clamped to exactly +-t),
    # since qo == 0 is on neither side
    side = torch.where(z_main >= 0, 1.0, -1.0)
    z_out = qo.float() / p.range_outlier + side * t
    z = torch.where(in_cap, z_out, z_main)
    return z * packed.std + packed.mean
