"""What every kernel wrapper of the port shares: the launch shapes, the SM
count, the per-stream workspaces, the key of a stochastic launch (its step
key, call index and element offset), the element types, the input checks,
the stream and the error check after a launch."""

from __future__ import annotations

import torch

from smart_quantization_tpu_torch.ops.keys import (
    DeviceKey,
    check_part,
    draw_seed,
    key_tensor,
    split_key,
)

THREADS = 256
# The element types the elementwise kernels read and write (csrc/elem.cuh),
# as their C interface's dtype argument.  A bfloat16 tensor goes to the
# bfloat16 form as it is; a tensor of any other dtype is cast to float32
# first and its result cast back (kernel_input).
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# a bfloat16 form's launches count under its kernel's name with this suffix
BF16_SUFFIX = "_bf16"


def form_name(name: str, xf: torch.Tensor) -> str:
    """The launch counter of kernel ``name`` in ``xf``'s element form."""
    return name + BF16_SUFFIX if xf.dtype == torch.bfloat16 else name


def with_bf16_forms(names) -> dict[str, int]:
    """Zeroed launch counters of ``names`` and of their bfloat16 forms."""
    return {n: 0 for name in names for n in (name, name + BF16_SUFFIX)}
# float_quantize and smaq_quantize_bn: a float4 for each thread per loop
# step, at most 1056 blocks (8 blocks of 256 threads fill an SM); larger
# tensors loop inside the block.
MAX_QUANT_BLOCKS = 1056
# The split forms of SmaQ and S2FP8 (smaq_kernel.py::smaq_plan,
# s2fp8_kernel.py::s2fp8_plan): blocks of THREADS threads, each thread with
# 4 float4 loads in flight per loop step, at most BLOCKS_PER_SM blocks on
# each SM of the card (the kernels are built for 4 resident: 64 registers
# a thread).  More blocks than that only queue behind the first.
BLOCKS_PER_SM = 4

_SM_COUNTS: dict[int, int] = {}
_WORKSPACES: dict[tuple[str, int, int], torch.Tensor] = {}


def quant_blocks(n: int) -> int:
    """Blocks of an elementwise pass: 4 elements a thread per loop step."""
    return max(1, min(MAX_QUANT_BLOCKS, -(-n // (THREADS * 4))))


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA card, read once per card."""
    if device.index not in _SM_COUNTS:
        _SM_COUNTS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SM_COUNTS[device.index]


def split_blocks(n: int, sms: int) -> int:
    """Blocks of a split-form launch on a card of ``sms`` SMs: a float4
    for each thread, at most BLOCKS_PER_SM a SM (the loops step over the
    rest)."""
    return max(1, min(sms * BLOCKS_PER_SM, -(-n // (4 * THREADS))))


def workspace(xf: torch.Tensor, kind: str, words: int) -> torch.Tensor:
    """The ``kind`` kernels' workspace on ``xf``'s card and current stream:
    ``words`` 64-bit words, zeroed once, here; each kernel puts the counters
    it used back to 0, so a call needs no memset.  Launches on one stream
    run in order, so no two kernels ever use one at once; each encoder has
    its own, so no kernel of one overwrites what another's reads later."""
    key = (kind, xf.device.index, stream(xf))
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = torch.zeros(words, dtype=torch.int64, device=xf.device)
        _WORKSPACES[key] = ws
    return ws


def key_for(gen, stochastic: bool, device: torch.device,
            n: int) -> tuple[torch.Tensor | None, int, int]:
    """A stochastic launch's key pointer, call index and element offset
    (``ops/keys.py``): a :class:`DeviceKey`'s slot and its next call index,
    or, for a host ``torch.Generator`` (initialization, tests), one draw
    from it written to the card by a fill (no copy, no sync) with call
    index 0; the offset of a :class:`PartKey`'s part (of ``n`` elements),
    else 0.  None, 0 and 0 when the launch rounds by truncation."""
    if not stochastic:
        return None, 0, 0
    gen, offset, total = split_key(gen)
    check_part(n, offset, total)
    if gen is None:
        raise ValueError("stochastic rounding requires a torch.Generator or a DeviceKey")
    if isinstance(gen, DeviceKey):
        if gen.device != device:
            raise ValueError(f"step key on {gen.device}, tensor on {device}")
        return gen.key, gen.take(), offset
    return key_tensor(draw_seed(gen), device), 0, offset


def check_offset(offset: int) -> None:
    """An element offset is in ``[0, 2^62)`` (a 64-bit argument)."""
    if not 0 <= offset < 2**62:
        raise ValueError(f"an element offset is in [0, 2^62), got {offset}")


def check_key(key: torch.Tensor | None, x: torch.Tensor, stochastic: bool,
              offset: int = 0) -> None:
    """A stochastic launch needs a 1-element int64 step key on ``x``'s card,
    and an element offset in ``[0, 2^62)``."""
    check_offset(offset)
    if not stochastic:
        return
    if key is None or key.dtype != torch.int64 or key.numel() != 1 or key.device != x.device:
        raise ValueError("stochastic rounding needs a 1-element int64 key on the tensor's card")


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def kernel_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` flat and contiguous in a dtype the kernels take: float32 and
    bfloat16 as they are, any other dtype cast to float32."""
    flat = x.reshape(-1)
    if flat.dtype not in DTYPES:
        flat = flat.to(torch.float32)
    return flat.contiguous()


def check_input(x: torch.Tensor, dtypes=tuple(DTYPES)) -> None:
    """The kernels take contiguous tensors of ``dtypes`` (float32 or
    bfloat16 elements; their scalars and per-channel constants float32
    only) on the current card."""
    if not x.is_cuda:
        raise ValueError(f"the kernels take CUDA tensors, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"the kernels take {', '.join(map(str, dtypes))}, got {x.dtype}")
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
