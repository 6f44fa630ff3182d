"""Float-format fake-quantization on the card: the wrapper of
``csrc/float_quantize.cu`` and the dispatcher.

The port of ``smart_quantization_tpu/ops/pallas/float_kernel.py::
float_quantize_fused``.  The source note in ``csrc/float_quantize.cu``
gives the design.  Here:

- ``float_quantize_launch`` launches the kernel on PyTorch's current stream
  and counts its launches in ``LAUNCHES``;
- ``float_quantize_fused`` is the kernel path for a CUDA tensor;
- the plain version is ``ops/float_format.py::float_quantize``, on any
  device: in nearest mode the kernel gives its bits exactly;
- ``float_quantize_fused_or_reference`` sends a CUDA tensor to the kernel
  and a CPU tensor to the plain version.  There is no size threshold.

The kernel reads and writes float32 or bfloat16 (``launch.DTYPES``): a
bfloat16 tensor goes to the bfloat16 form as it is, another dtype is cast
to float32.  The two forms launch differently (``launch_blocks``): the
float32 form on ``launch.quant_blocks``' grid, the bfloat16 form (16-byte
loads, several in flight a thread) on every block the card holds at once,
read from the card's occupancy once.

Stochastic rounding keys the kernel's Philox words by a step key in device
memory and a call index, counted from the call's element offset in a
larger tensor (``launch.key_for``: a ``PartKey``'s); the plain version
draws its words from the caller's key by ``ops/rounding.py``, which gives
other bits, so stochastic outputs compare by statistics only.
"""

from __future__ import annotations

import ctypes

import torch

from smart_quantization_tpu_torch.ops.cuda import build
from smart_quantization_tpu_torch.ops.cuda.launch import (
    DTYPES,
    THREADS,
    check_input,
    check_key,
    form_name,
    kernel_input,
    key_for,
    ptr,
    quant_blocks,
    raise_on,
    sm_count,
    stream,
    with_bf16_forms,
)
from smart_quantization_tpu_torch.ops.float_format import FloatFormat, f32_bits, float_quantize

# Launches of the kernel since the last reset (one per launch, nowhere
# else), its bfloat16 form under "float_quantize_bf16".
LAUNCHES = with_bf16_forms(("float_quantize",))


# bf16 elements in one 16-byte load of the bfloat16 form (two groups)
BF16_LOAD_ELEMS = 8
_BF16_RESIDENT: dict[int, int] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def format_args(fmt: FloatFormat) -> tuple:
    """``fmt`` as the C functions take it: man, emin, bits of the max and of
    the quantum, and 1/quantum as two powers of two."""
    c1, c2 = fmt.quantum_scale
    return fmt.man, fmt.emin, f32_bits(fmt.max_value), f32_bits(fmt.quantum), c1, c2


def bf16_resident(device: torch.device) -> int:
    """Blocks of THREADS of the bfloat16 form resident on one SM of
    ``device``'s card, asked of the card once."""
    if device.index not in _BF16_RESIDENT:
        c = ctypes.c_int(0)
        raise_on(build.library().float_occupancy(DTYPES[torch.bfloat16], THREADS,
                                                 ctypes.addressof(c)), "float_occupancy")
        _BF16_RESIDENT[device.index] = c.value
    return _BF16_RESIDENT[device.index]


def launch_blocks(n: int, dtype: torch.dtype, sms: int = 0, resident: int = 0) -> int:
    """Blocks of THREADS for ``n`` elements: ``quant_blocks`` for float32;
    for bfloat16 the ``resident`` blocks a SM on ``sms`` SMs, and no more
    than give each thread one 16-byte load."""
    if dtype == torch.bfloat16:
        return max(1, min(sms * resident, -(-n // (BF16_LOAD_ELEMS * THREADS))))
    return quant_blocks(n)


def float_quantize_launch(
    xf: torch.Tensor, fmt: FloatFormat, *, key: torch.Tensor | None, call: int = 0,
    offset: int = 0, stochastic: bool, check_inf: bool
) -> torch.Tensor:
    """Launch the kernel on a flat float32 or bfloat16 CUDA tensor;
    stochastic rounding draws (``key``, ``call``), ``key`` a 1-element
    int64 step key on the card, element e the word of element ``offset +
    e``.  Returns the output, of ``xf``'s dtype."""
    check_input(xf)
    check_key(key, xf, stochastic, offset)
    n = xf.numel()
    y = torch.empty_like(xf)
    if xf.dtype == torch.bfloat16:
        blocks = launch_blocks(n, xf.dtype, sm_count(xf.device), bf16_resident(xf.device))
    else:
        blocks = launch_blocks(n, xf.dtype)
    rc = build.library().float_quantize(
        xf.data_ptr(), y.data_ptr(), n, DTYPES[xf.dtype], *format_args(fmt), ptr(key), call,
        offset, int(stochastic), int(check_inf), blocks, THREADS, stream(xf),
    )
    raise_on(rc, "float_quantize")
    LAUNCHES[form_name("float_quantize", xf)] += 1
    return y


def float_quantize_fused(
    x: torch.Tensor,
    fmt: FloatFormat,
    gen: torch.Generator | None = None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
) -> torch.Tensor:
    """``float_quantize`` of a CUDA tensor through the kernel, of ``x``'s
    shape: bfloat16 for a bfloat16 ``x`` (the float32 result rounded to
    nearest-even, as the JAX wrapper's ``astype``), float32 otherwise."""
    if not x.is_cuda:
        raise ValueError(f"float_quantize_fused takes CUDA tensors, got {x.device}")
    if x.numel() == 0:
        return x if x.dtype in DTYPES else x.to(torch.float32)
    xf = kernel_input(x)
    key, call, offset = key_for(gen, stochastic, x.device, xf.numel())
    y = float_quantize_launch(
        xf, fmt, key=key, call=call, offset=offset, stochastic=stochastic, check_inf=check_inf
    )
    return y.view(x.shape)


def float_quantize_fused_or_reference(
    x: torch.Tensor,
    fmt: FloatFormat,
    gen: torch.Generator | None = None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
) -> torch.Tensor:
    """A CUDA tensor goes to the kernel, a CPU tensor to the plain version."""
    if x.is_cuda:
        return float_quantize_fused(x, fmt, gen, stochastic=stochastic, check_inf=check_inf)
    if x.device.type == "cpu":
        return float_quantize(x, fmt, gen, stochastic=stochastic, check_inf=check_inf)
    raise ValueError(f"no float_quantize path for device {x.device}")
