"""Step keys (``ops/keys.py``) and the Philox fill's plain version
(``ops/cuda/philox_kernel.py``), without a card.

- the host derivation: a step's key is the first word of its seed
  sequence (the CPU step's tap generator's seed), and the Philox key of a
  draw, ``mix(step key, call)``, is pinned at a few (seed, step, call)
  triples; keys differ across steps and calls;
- ``mix``'s constants are those of ``csrc/philox.cuh``, parsed from the
  source, and the int64 tensor mirror gives ``mix``'s words;
- the plain Philox4x32-10 gives the published test vectors (Random123's
  ``kat_vectors``), and the fill's word e is the word the quantize kernels
  give element e;
- a ``DeviceKey`` hands out call indices in order, reserves blocks, and
  feeds ``ops/rounding.py``'s draws through the fill (on the CPU, its plain
  version); a tap fixes its backward block when the forward runs.
"""

import os
import re

import numpy as np
import pytest
import torch

from smart_quantization_tpu_torch.compress import build_compressor
from smart_quantization_tpu_torch.inject.tap import DRAWS_PER_COMPRESS, compression_tap
from smart_quantization_tpu_torch.ops import keys, rounding
from smart_quantization_tpu_torch.ops.cuda import build
from smart_quantization_tpu_torch.ops.cuda.philox_kernel import (
    mix_reference,
    philox4x32_10,
    philox_fill_reference,
)
from smart_quantization_tpu_torch.optim.compressed import build_optimizer
from smart_quantization_tpu_torch.train.loop import Trainer

CPU = torch.device("cpu")


def _read(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("seed, step, call, want", [
    (0, 0, 0, 0x05F58D093C7F2C24),
    (0, 1, 0, 0x9D81CC8F1141D547),
    (3, 5, 7, 0x8D39B986143A6794),
    (1234, 99999, 4_000_000_000, 0xC609BFFC21AD832E),
])
def test_host_key_derivation_is_pinned(seed, step, call, want):
    key = keys.step_key(seed, step)
    assert key == int(np.random.SeedSequence([seed, step]).generate_state(3, np.uint64)[0])
    assert keys.mix(key, call) == want


def test_step_key_is_the_cpu_steps_tap_seed():
    trainer = Trainer(torch.nn.Linear(2, 2), None, build_optimizer("sgd", 0.1), device="cpu")
    g_fwd, _, _ = trainer._step_generators(7)
    assert g_fwd.initial_seed() == keys.step_key(trainer.cfg.seed, 7)


def test_keys_differ_across_steps_and_calls():
    words = {keys.mix(keys.step_key(seed, step), call)
             for seed in (0, 1) for step in range(64) for call in range(64)}
    assert len(words) == 2 * 64 * 64


def test_mix_constants_match_philox_cuh():
    src = _read("philox.cuh")

    def const(name):
        m = re.search(rf"\b{name} = (0x[0-9A-Fa-f]+|\d+)", src)
        assert m is not None, name
        return int(m.group(1), 0)

    assert (const("kMixGamma"), const("kMixM1"), const("kMixM2")) == (
        keys.MIX_GAMMA, keys.MIX_M1, keys.MIX_M2)
    assert (const("kMixS1"), const("kMixS2"), const("kMixS3")) == keys.MIX_SHIFTS
    fill = _read("philox_fill.cu")
    # the fill keys its words as the quantize kernels do: Draws, whose key
    # is philox_key's mix of (step key, call)
    assert '#include "philox.cuh"' in fill and "smaq::draws(key, call, offset)" in fill
    assert "return Draws{philox_key(key, call)," in src


@pytest.mark.parametrize("key", [0, 5, 2**63 + 17, 2**64 - 1])
def test_tensor_mix_matches_host_mix(key):
    t = torch.tensor(keys.as_int64([key]))
    for call in (0, 1, 2**32 - 1):
        got = int(mix_reference(t, call)[0]) & (2**64 - 1)
        assert got == keys.mix(key, call)


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_plain_philox_gives_the_published_vectors(ctr, key, want):
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    out = philox4x32_10(tuple(t(c) for c in ctr), tuple(t(k) for k in key))
    assert tuple(int(o[0]) for o in out) == want


def test_fill_words_are_the_kernels_element_words():
    """Word e of a fill is word (e & 3) of Philox at counter e >> 2 under
    the mixed key; the uniforms are the words' top 24 bits."""
    key = keys.key_tensor(keys.step_key(0, 3), CPU)
    n, call = 23, 9
    words = philox_fill_reference(n, key, call, uniform=False).to(torch.int64) & 0xFFFFFFFF
    k = keys.mix(keys.step_key(0, 3), call)
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    for e in (0, 1, 5, 22):
        group = philox4x32_10((t(e >> 2), t(0), t(0), t(0)), (t(k & 0xFFFFFFFF), t(k >> 32)))
        assert int(words[e]) == int(group[e & 3][0])
    u = philox_fill_reference(n, key, call, uniform=True)
    assert u.dtype == torch.float32
    assert torch.equal(u, (words >> 8).to(torch.float32) * 2.0**-24)


def test_device_key_hands_out_call_indices():
    key = keys.DeviceKey(keys.key_tensor(11, CPU))
    assert [key.take(), key.take()] == [0, 1]
    block = key.reserve(3)
    assert key.take() == 5
    assert [block.take() for _ in range(3)] == [2, 3, 4]
    with pytest.raises(RuntimeError):
        block.take()
    u = rounding.uniform((4, 5), key, CPU)
    assert u.shape == (4, 5) and bool(((u >= 0) & (u < 1)).all())
    assert torch.equal(u.reshape(-1), philox_fill_reference(20, key.key, 6, uniform=True))
    r = rounding.randint(7, (1000,), key, CPU)
    assert int(r.min()) == 0 and int(r.max()) == 6
    bits = rounding.random_bits((8,), key, CPU)
    assert bits.dtype == torch.int64 and bool(((bits >= 0) & (bits < 2**32)).all())
    assert key.take() == 9


def test_tap_reserves_its_backward_block_in_the_forward():
    key = keys.DeviceKey(keys.key_tensor(5, CPU))
    x = torch.randn(4, 16, requires_grad=True)
    y, _ = compression_tap(x, key, build_compressor("smart"))
    assert key.take() == 2 * DRAWS_PER_COMPRESS  # both blocks taken at once
    y.sum().backward()
    assert torch.isfinite(x.grad).all()
