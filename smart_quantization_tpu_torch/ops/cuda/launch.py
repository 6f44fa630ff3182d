"""What every kernel wrapper of the port shares: the launch shape, the input
checks, the stream and the error check after a launch."""

from __future__ import annotations

import torch

from smart_quantization_tpu_torch.ops.rounding import draw_seed

THREADS = 256
# The shapes below serve float_quantize, the S2FP8 pair and
# smaq_quantize_bn; smaq_stats and smaq_quantize have their own
# (smaq_kernel.py::smaq_plan).
# Partials per stats launch: every s2fp8_quantize block folds all of them,
# so they are kept few (264 = 2 per SM of an H100).
MAX_STATS_BLOCKS = 264
# 8 blocks of 256 threads fill an SM; larger tensors loop inside the block.
MAX_QUANT_BLOCKS = 1056


def blocks(n: int, per_block: int, cap: int) -> int:
    return max(1, min(cap, -(-n // per_block)))


def stats_blocks(n: int) -> int:
    """Blocks of a stats pass: 16 elements a thread, at most 264 partials."""
    return blocks(n, THREADS * 16, MAX_STATS_BLOCKS)


def quant_blocks(n: int) -> int:
    """Blocks of an elementwise pass: 4 elements a thread per loop step."""
    return blocks(n, THREADS * 4, MAX_QUANT_BLOCKS)


def seed_for(gen: torch.Generator | None, stochastic: bool) -> int:
    """The kernel's 64-bit Philox key: one draw from the caller's host
    generator when rounding stochastically (no device sync), else 0."""
    if not stochastic:
        return 0
    if gen is None:
        raise ValueError("stochastic rounding requires a torch.Generator")
    return draw_seed(gen)


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def check_input(x: torch.Tensor) -> None:
    """The kernels take contiguous float32 tensors on the current card."""
    if not x.is_cuda:
        raise ValueError(f"the kernels take CUDA tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the kernels take contiguous tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {x.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )


def stream(x: torch.Tensor) -> int:
    """PyTorch's current stream on ``x``'s card, as the C functions take it."""
    return torch.cuda.current_stream(x.device).cuda_stream


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()
