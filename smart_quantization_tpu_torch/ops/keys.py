"""Step keys: where every random draw of a training step on the card takes
its key from.

The JAX package derives each step's randomness on the device from the step
count (``smart_quantization_tpu/train/loop.py``), so K steps scanned in one
dispatch draw what K dispatches draw.  The port does the same for a CUDA
graph of K steps:

- :func:`step_key` derives one 64-bit key per step on the host from
  ``(seed, step)``: the first word of the ``np.random.SeedSequence([seed,
  step])`` that the host generators of a CPU step come from, so a resumed
  run still steps as a straight run does;
- the trainer writes the key into a small buffer on the card (a K-step
  graph has K slots, filled by one host-to-device copy before a replay) and
  hands the step a :class:`DeviceKey` on its slot;
- each draw of the step takes a call index from the key (:meth:`DeviceKey.
  take`), a plain integer that counts the step's draws in program order, so
  a capture bakes the indices that an eager step uses;
- the draw's Philox key is :func:`mix` of (step key, call index), computed
  on the card by the kernels (``csrc/philox.cuh``, whose constants these
  mirror) and by the Philox fill's plain version.

A draw whose order autograd decides (a tap's backward) takes its indices
from a block reserved when the forward runs (:meth:`DeviceKey.reserve`).

On the CPU the trainer keeps its host ``torch.Generator``s; everything that
draws takes either, or a :class:`PartKey` of either: the draws of one part
of a larger tensor (a rank's rows of a global batch).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# csrc/philox.cuh: kMixGamma, kMixM1, kMixM2 and the shifts kMixS1..3
MIX_GAMMA = 0x9E3779B97F4A7C15
MIX_M1 = 0xBF58476D1CE4E5B9
MIX_M2 = 0x94D049BB133111EB
MIX_SHIFTS = (30, 27, 31)
# call indices are 32-bit on the C side
CALLS = 2**32
_U64 = 2**64 - 1
_SEED_HI = 2**62


def draw_seed(gen: torch.Generator) -> int:
    """One 62-bit seed from the host generator ``gen`` (no device sync)."""
    return int(torch.randint(0, _SEED_HI, (), generator=gen))


def step_key(seed: int, step: int) -> int:
    """The 64-bit key of training step ``step`` of a run seeded ``seed``:
    the first word of its seed sequence, the taps' host generator's seed on
    the CPU (``Trainer._step_generators``)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(3, np.uint64)[0])


def mix(key: int, call: int) -> int:
    """The Philox key of draw ``call`` of a step keyed ``key``, as
    ``csrc/philox.cuh::mix`` computes it (splitmix64's output function on
    ``key + (call + 1) * gamma``)."""
    s1, s2, s3 = MIX_SHIFTS
    z = (key + (call + 1) * MIX_GAMMA) & _U64
    z = ((z ^ (z >> s1)) * MIX_M1) & _U64
    z = ((z ^ (z >> s2)) * MIX_M2) & _U64
    return z ^ (z >> s3)


def as_int64(words) -> np.ndarray:
    """64-bit keys as the int64 words a tensor holds (the same bits)."""
    return np.asarray(words, dtype=np.uint64).view(np.int64)


def key_tensor(key: int, device: torch.device | str) -> torch.Tensor:
    """One key in a 1-element int64 tensor on ``device``, written by a fill
    (no host-to-device copy, so no sync)."""
    return torch.full((1,), int(as_int64([key])[0]), dtype=torch.int64, device=device)


class DeviceKey:
    """A step key in device memory and the call indices of its draws.

    ``key`` is a 1-element int64 tensor (a slot of the trainer's key
    buffer); the indices ``start`` to ``stop - 1`` belong to this key."""

    __slots__ = ("key", "_next", "_stop")

    def __init__(self, key: torch.Tensor, start: int = 0, stop: int = CALLS):
        if key.dtype != torch.int64 or key.numel() != 1:
            raise ValueError(f"a step key is one int64 word, got {key.dtype} x {key.numel()}")
        self.key = key
        self._next = start
        self._stop = stop

    @property
    def device(self) -> torch.device:
        return self.key.device

    def take(self) -> int:
        """The next call index."""
        if self._next >= self._stop:
            raise RuntimeError(f"draw beyond the call indices reserved ({self._stop})")
        call = self._next
        self._next += 1
        return call

    def reserve(self, n: int) -> "DeviceKey":
        """The next ``n`` call indices, as a key of their own."""
        start = self._next
        if start + n > self._stop:
            raise RuntimeError(f"cannot reserve {n} call indices past {self._stop}")
        self._next += n
        return DeviceKey(self.key, start, start + n)


def mesh_step_words(seed: int, step: int, rank: int, fsdp_index: int,
                    fold_payload: bool) -> tuple[int, int, int, int]:
    """The 64-bit words of a step on a mesh rank, beside its shared step
    key (the optimizer's, the loss compressor's): the taps' and the
    augmentation's word and the dropout's, folded with the rank; the
    gradient payload's, shared by every rank under data parallelism and
    folded with the rank under FSDP (``fold_payload``); the FSDP parameter
    gather's, folded with the fsdp index only, so that the data replicas of
    a block send the same payload."""
    fwd, drop = np.random.SeedSequence([seed, step, 1, rank]).generate_state(2, np.uint64)
    payload = np.random.SeedSequence(
        [seed, step, 2, *((rank,) if fold_payload else ())]).generate_state(1, np.uint64)[0]
    gather = np.random.SeedSequence([seed, step, 3, fsdp_index]).generate_state(1, np.uint64)[0]
    return int(fwd), int(drop), int(payload), int(gather)


@dataclasses.dataclass(frozen=True)
class PartKey:
    """The key of a call on one part of a larger tensor: element e of the
    part draws what element ``offset + e`` draws in a call keyed ``key`` on
    the whole, ``total`` elements (a rank's rows of the global batch,
    ``parallel/whole_batch.py``).  On the card the kernels and the Philox
    fill count their words from ``offset`` (``csrc/philox.cuh``: Draws);
    from a host generator the part takes its slice of the whole's draw."""

    key: torch.Generator | DeviceKey
    offset: int
    total: int

    def __post_init__(self):
        if not 0 <= self.offset <= self.total:
            raise ValueError(f"a part at element {self.offset} of {self.total}")


def split_key(gen) -> tuple[object, int, int | None]:
    """``(key, offset, total)`` of a :class:`PartKey`, ``(gen, 0, None)``
    of any other key."""
    if isinstance(gen, PartKey):
        return gen.key, gen.offset, gen.total
    return gen, 0, None


def check_part(n: int, offset: int, total: int | None) -> None:
    """A part of ``n`` elements at ``offset`` lies inside the whole."""
    if total is not None and offset + n > total:
        raise ValueError(f"{n} elements at {offset} run past the whole's {total}")
