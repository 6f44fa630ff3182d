"""S2FP8 on the card: the wrappers of ``csrc/s2fp8.cu``, their plain PyTorch
version, and the dispatcher.

The port of ``smart_quantization_tpu/ops/pallas/s2fp8_kernel.py::
s2fp8_fused`` (its default ``intrinsic`` squeeze) and of the statistics its
wrapper computes first.  The source note in ``csrc/s2fp8.cu`` gives the
design.  Here:

- ``s2fp8_stats`` and ``s2fp8_quantize`` launch the two kernels on
  PyTorch's current stream and count their launches in ``LAUNCHES``;
- ``s2fp8_plan`` picks a call's form from its size: one ``s2fp8_quantize``
  block that computes its own stats (``SMALL_MAX`` elements or fewer), or
  ``s2fp8_stats`` then ``s2fp8_quantize``;
- ``s2fp8_fused`` is the kernel path of one S2FP8 call on a CUDA tensor;
- ``s2fp8_fused_reference`` is the kernels' plain version, for any device:
  the stats summed in float64, the squeeze as ``exp2(alpha * log2|x| +
  beta)`` and its inverse as ``exp2((log2 t - beta) / alpha)``, as the
  kernel computes them; ``unsqueeze_table_reference`` is the inverse as
  the kernels read it, a table over the e5m2 grid;
- ``s2fp8_fused_or_reference`` sends a CUDA tensor to the kernels and a CPU
  tensor to ``ops/s2fp8.py``.  There is no size threshold.

The kernels read and write float32 or bfloat16 (``launch.DTYPES``): a
bfloat16 tensor goes to the bfloat16 forms as it is, another dtype is cast
to float32.  The bfloat16 split form of a large call has kernels of its
own (the note in ``csrc/s2fp8.cu``), which ``split_forms`` picks by size:
``s2fp8_stats_table`` takes log2 as exponent + a table entry of the
mantissa on the float32 kernel's grid (``log2_table_reference`` is its
plain version), and ``s2fp8_quantize_window`` runs one block of
BF16_THREADS on each SM (``window_blocks``), each block tabulating the
element function over WINDOW_BINADES binades of bf16 magnitudes.
"""

from __future__ import annotations

import torch

from smart_quantization_tpu_torch.ops.cuda import build, launch
from smart_quantization_tpu_torch.ops.cuda.launch import (
    BLOCKS_PER_SM,
    DTYPES,
    THREADS,
    check_input,
    check_key,
    form_name,
    kernel_input,
    key_for,
    ptr,
    raise_on,
    sm_count,
    split_blocks,
    stream,
    with_bf16_forms,
)
from smart_quantization_tpu_torch.ops.float_format import (
    FP8_FORMAT,
    float_quantize,
    from_bits,
    to_bits,
)
from smart_quantization_tpu_torch.ops.s2fp8 import (
    log2_stats,
    s2fp8_quantize_dequantize,
    squeeze_coefs,
)

# Launches of each kernel since the last reset (one per launch, nowhere
# else), its bfloat16 form under the name with "_bf16"; the bfloat16 split
# form's table kernels under their own names.
LAUNCHES = {**with_bf16_forms(("s2fp8_stats", "s2fp8_quantize")),
            "s2fp8_stats_table_bf16": 0, "s2fp8_quantize_window_bf16": 0}

# The small form: one block of SMALL_THREADS computes the stats, the
# constants and the table, then quantizes, one launch.  It is one SM's
# work, so two launches spread over the card are faster from about 6000
# elements on (measured: PERF.md); SMALL_MAX is the largest main-path call
# size below that.
SMALL_THREADS = 1024
SMALL_MAX = 5120
# The unsqueeze table: entry k is the e5m2 value t whose float32 bits are
# (k + TABLE_BASE) << 21 (csrc/s2fp8.cu: kTableSize, kTableBase).
TABLE_SIZE = 128
TABLE_BASE = 444
# The workspace of a (device, stream), in 64-bit words: the stats ticket,
# the constants (mu, m, alpha, beta, 1/alpha, 3 unused, then the table:
# 136 float32), then 2 float64 partials per stats block (kCounterWords,
# kConstWords).
_COUNTER_WORDS = 2
_CONST_WORDS = 68
_CONST_FLOATS = 2 * _CONST_WORDS
# The bfloat16 split form (csrc/s2fp8.cu: kBf16Threads, kWindowBinades,
# kLog2Split): the quantize's block, a 16-byte load (8 bf16) a thread per
# step; the binades of 128 magnitudes each block tabulates; and the
# mantissas (of 128) from which log2f halves the mantissa before its
# polynomial, so that the stats take log2 as exponent + a table entry.
BF16_THREADS = 1024
BF16_LOAD_ELEMS = 8
WINDOW_BINADES = 16
LOG2_SPLIT = 54
# Where the stats' max is 0 (which zeros alone give), each block of the
# window quantize places its window from its first chunks' nonzero
# exponents: at their largest, or WINDOW_ABOVE_MEAN above their mean where
# that is lower (kWindowAboveMean).
WINDOW_ABOVE_MEAN = 6
# The sizes from which the bfloat16 split form takes its table kernels
# (``split_forms``; below, the float32 kernels' bfloat16 instances are
# faster: profile_s2fp8.py, PERF.md).
BF16_TABLE_MIN = 1 << 21
BF16_WINDOW_MIN = 1 << 20


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def s2fp8_plan(n: int, sms: int) -> tuple[str, int]:
    """The form of an S2FP8 call of ``n`` elements on a card of ``sms``
    SMs: ``("small", 1)`` (one ``s2fp8_quantize`` block of SMALL_THREADS,
    no stats launch) or ``("split", blocks)`` (``s2fp8_stats`` then
    ``s2fp8_quantize``, each on ``blocks`` blocks of THREADS, or a large
    bfloat16 call's table kernels where ``split_forms`` says)."""
    if n <= SMALL_MAX:
        return "small", 1
    return "split", split_blocks(n, sms)


def split_forms(n: int, dtype: torch.dtype) -> tuple[bool, bool]:
    """Whether a split-form call of ``n`` elements of ``dtype`` takes the
    bfloat16 table kernels: (``s2fp8_stats_table``, from BF16_TABLE_MIN
    elements; ``s2fp8_quantize_window``, from BF16_WINDOW_MIN).  The one
    place that decides it: the wrappers ask it unless told."""
    bf16 = dtype == torch.bfloat16
    return bf16 and n >= BF16_TABLE_MIN, bf16 and n >= BF16_WINDOW_MIN


def window_blocks(n: int, sms: int) -> int:
    """Blocks of BF16_THREADS of ``s2fp8_quantize_window``: one a SM at
    most (each builds its table once), and no more than give each thread
    one 16-byte load."""
    return max(1, min(sms, -(-n // (BF16_LOAD_ELEMS * BF16_THREADS))))


def log2_table_reference(device=None) -> torch.Tensor:
    """The bfloat16 stats' log2 of every bf16 magnitude (bits 0 to 0x7FFF,
    float32) as the table gives it, in PyTorch ops: exponent - 127 (+1 from
    LOG2_SPLIT on) plus ``torch.log2`` of the mantissa entry, rounded once;
    subnormals and zero (0) from ``log2`` itself, inf and NaN as ``log2``."""
    h = torch.arange(1 << 15, dtype=torch.int64, device=device)
    e, j = h >> 7, h & 127
    split = j >= LOG2_SPLIT
    m = 1.0 + j.double() / 128.0
    mant = torch.where(split, m / 2.0, m).float()
    ee = (e - 127 + split.long()).double()
    normal = (ee + torch.log2(mant).double()).float()
    x = from_bits(h << 16)
    direct = torch.where(h == 0, torch.zeros_like(x), torch.log2(x))
    return torch.where((e == 0) | (e == 255), direct, normal)


def workspace_words(sms: int) -> int:
    """64-bit words of a workspace: the ticket, the constants and the
    partials of the largest stats launch on a card of ``sms`` SMs."""
    return _COUNTER_WORDS + _CONST_WORDS + 2 * sms * BLOCKS_PER_SM


def workspace(xf: torch.Tensor) -> torch.Tensor:
    """The S2FP8 kernels' workspace on ``xf``'s card and current stream
    (``launch.workspace``)."""
    return launch.workspace(xf, "s2fp8", workspace_words(sm_count(xf.device)))


def s2fp8_stats(xf: torch.Tensor, *, table: bool | None = None,
                sums: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the stats kernel on a flat float32 or bfloat16 tensor, or
    with ``table`` (bfloat16 only; by default as ``split_forms`` says)
    ``s2fp8_stats_table``; returns the constants its last block
    writes, float32 ``[mu, m, alpha, beta, 1/alpha, 0, 0, 0, table[128]]``
    (``read_consts`` names them).  They live in the stream's workspace: the
    next stats launch on the stream overwrites them.  ``sums``, 2 float64
    on the card, also gets the folded sum and max of ``log2|x|`` they come
    from, for statistics reduced over ranks."""
    check_input(xf)
    n = xf.numel()
    if n == 0:
        raise ValueError("s2fp8_stats takes a non-empty tensor")
    if sums is not None and (sums.dtype != torch.float64 or sums.numel() != 2
                             or sums.device != xf.device or not sums.is_contiguous()):
        raise ValueError("sums must be 2 contiguous float64 on the tensor's device")
    if table is None:
        table = split_forms(n, xf.dtype)[0]
    elif table and xf.dtype != torch.bfloat16:
        raise ValueError(f"s2fp8_stats_table takes bfloat16, got {xf.dtype}")
    ws = workspace(xf)
    blocks = split_blocks(n, sm_count(xf.device))
    lib = build.library()
    if table:
        rc = lib.s2fp8_stats_table(xf.data_ptr(), n, ws.data_ptr(), ptr(sums), blocks, THREADS,
                                   stream(xf))
        name = "s2fp8_stats_table_bf16"
    else:
        rc = lib.s2fp8_stats(xf.data_ptr(), n, DTYPES[xf.dtype], ws.data_ptr(), ptr(sums),
                             blocks, THREADS, stream(xf))
        name = form_name("s2fp8_stats", xf)
    raise_on(rc, name)
    LAUNCHES[name] += 1
    return ws[_COUNTER_WORDS:_COUNTER_WORDS + _CONST_WORDS].view(torch.float32)


def read_consts(consts: torch.Tensor) -> dict[str, torch.Tensor]:
    """``s2fp8_stats``' constants by name (copies, so a later call does not
    change them): 0-d mu, m, alpha, beta, inv_alpha and the 128-entry
    unsqueeze table."""
    c = consts.clone()
    out = dict(zip(("mu", "m", "alpha", "beta", "inv_alpha"), c[:5].unbind()))
    out["table"] = c[8:]
    return out


def s2fp8_quantize(
    xf: torch.Tensor,
    consts: torch.Tensor | None = None,
    *,
    key: torch.Tensor | None,
    call: int = 0,
    offset: int = 0,
    stochastic: bool,
    check_inf: bool,
    window: bool | None = None,
) -> torch.Tensor:
    """Launch the quantize kernel against ``s2fp8_stats``' ``consts``, or
    with ``window`` (bfloat16 only; by default as ``split_forms`` says)
    ``s2fp8_quantize_window``; without them, the small form (``SMALL_MAX``
    elements at most): one block computes the stats itself, then
    quantizes.  Stochastic rounding draws (``key``, ``call``): ``key`` a
    1-element int64 step key on the card, element e the word of element
    ``offset + e``.  Returns the flat output, of ``xf``'s dtype."""
    check_input(xf)
    check_key(key, xf, stochastic, offset)
    n = xf.numel()
    if window is None:
        window = consts is not None and split_forms(n, xf.dtype)[1]
    elif window and (consts is None or xf.dtype != torch.bfloat16):
        raise ValueError("s2fp8_quantize_window takes bfloat16 and s2fp8_stats' consts")
    if consts is None:
        if not 0 < n <= SMALL_MAX:
            raise ValueError(f"the small form takes 1 to {SMALL_MAX} elements, got {n}: "
                             "pass s2fp8_stats' consts")
        blocks, threads = 1, SMALL_THREADS
    else:
        if (consts.dtype != torch.float32 or consts.numel() != _CONST_FLOATS
                or consts.device != xf.device or not consts.is_contiguous()
                or consts.data_ptr() % 16):
            raise ValueError("consts must be s2fp8_stats' constants on the tensor's device")
        sms = sm_count(xf.device)
        blocks, threads = ((window_blocks(n, sms), BF16_THREADS) if window
                           else (split_blocks(n, sms), THREADS))
    y = torch.empty_like(xf)
    lib = build.library()
    if window:
        rc = lib.s2fp8_quantize_window(
            xf.data_ptr(), y.data_ptr(), n, ptr(consts), ptr(key), call, offset,
            int(stochastic), int(check_inf), blocks, threads, stream(xf))
        name = "s2fp8_quantize_window_bf16"
    else:
        rc = lib.s2fp8_quantize(
            xf.data_ptr(), y.data_ptr(), n, DTYPES[xf.dtype], ptr(consts), ptr(key), call,
            offset, int(stochastic), int(check_inf), blocks, threads, stream(xf))
        name = form_name("s2fp8_quantize", xf)
    raise_on(rc, name)
    LAUNCHES[name] += 1
    return y


def stats_reference(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The stats kernel's plain version: (mu, max) of ``log2|x|``, zeros
    as 0, the sum in float64."""
    a = flat.abs()
    return log2_stats(torch.where(a == 0.0, torch.zeros_like(a), torch.log2(a)))


def unsqueeze_reference(t: torch.Tensor, beta: torch.Tensor, inv_alpha: torch.Tensor) -> torch.Tensor:
    """The inverse squeeze of positive finite ``t``:
    ``exp2((log2 t - beta) * inv_alpha)``."""
    return torch.exp2((torch.log2(t) - beta) * inv_alpha)


def unsqueeze_table_reference(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The 128-entry table the kernels read for the unsqueeze, in PyTorch
    ops: ``unsqueeze_reference`` at the float32 of bits
    ``(k + TABLE_BASE) << 21`` for k < 128 (the entries that are no e5m2
    value are never read)."""
    k = torch.arange(TABLE_SIZE, dtype=torch.int64, device=alpha.device)
    return unsqueeze_reference(from_bits((k + TABLE_BASE) << 21), beta, 1.0 / alpha)


def given_consts(mu: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The constants ``s2fp8_quantize`` reads, in PyTorch ops, from a given
    mean ``mu`` and max ``m`` of ``log2|x|`` (0-d float32 on the card):
    ``[mu, m, alpha, beta, 1/alpha, 0, 0, 0, table[128]]`` with the stats
    kernel's expressions (``squeeze_coefs``, ``unsqueeze_table_reference``)."""
    alpha, beta = squeeze_coefs(mu, m)
    inv_alpha = torch.ones_like(alpha) / alpha
    zero = torch.zeros_like(alpha)
    head = torch.stack([mu, m, alpha, beta, inv_alpha, zero, zero, zero])
    return torch.cat([head, unsqueeze_table_reference(alpha, beta)]).contiguous()


def s2fp8_fused(
    x: torch.Tensor,
    gen: torch.Generator | None = None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
    stats: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """S2FP8 of a CUDA tensor through the kernels, in the form
    ``s2fp8_plan`` names; same contract as ``s2fp8_quantize_dequantize``.
    Given ``stats`` (the mean and max of ``log2|x|``, as reduced over
    ranks) skip the stats launch: the quantize kernel reads
    ``given_consts``."""
    if not x.is_cuda:
        raise ValueError(f"s2fp8_fused takes CUDA tensors, got {x.device}")
    if x.numel() == 0:
        return x
    xf = kernel_input(x)
    if stats is not None:
        consts = given_consts(*(torch.as_tensor(v, device=x.device).float() for v in stats))
    elif s2fp8_plan(xf.numel(), sm_count(xf.device))[0] == "small":
        consts = None
    else:
        consts = s2fp8_stats(xf)
    key, call, offset = key_for(gen, stochastic, x.device, xf.numel())
    y = s2fp8_quantize(xf, consts, key=key, call=call, offset=offset, stochastic=stochastic,
                       check_inf=check_inf)
    return y.view(x.shape).to(x.dtype)


def s2fp8_fused_reference(
    x: torch.Tensor,
    gen: torch.Generator | None = None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
    rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernels' plain version, in PyTorch ops on any device
    (``s2fp8_kernel.py:146-184`` in its ``intrinsic`` form, stats as
    223-237).  ``rand`` replaces the rounding's random words."""
    flat = x.reshape(-1).to(torch.float32)
    alpha, beta = squeeze_coefs(*stats_reference(flat))
    inv_alpha = 1.0 / alpha

    bits = to_bits(flat)
    sign = bits & 0x80000000
    a = from_bits(bits & 0x7FFFFFFF)
    one = torch.ones_like(a)
    zero, nonfinite = a == 0.0, a >= float("inf")
    sq = torch.exp2(alpha * torch.log2(torch.where(zero | nonfinite, one, a)) + beta)
    sq = torch.where(nonfinite, a, torch.where(zero, 0.0, sq))
    t = float_quantize(
        sq, FP8_FORMAT, gen, stochastic=stochastic, check_inf=check_inf, rand=rand
    )
    t_zero, t_nonfinite = t == 0.0, t >= float("inf")
    out = unsqueeze_reference(torch.where(t_zero | t_nonfinite, one, t), beta, inv_alpha)
    out = torch.where(t_nonfinite, t, torch.where(t_zero, 0.0, out))
    y = from_bits(to_bits(out) | sign)
    return y.view(x.shape).to(x.dtype)


def s2fp8_fused_or_reference(
    x: torch.Tensor,
    gen: torch.Generator | None = None,
    *,
    stochastic: bool = True,
    check_inf: bool = True,
    stats: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """A CUDA tensor goes to the kernels, a CPU tensor to ``ops/s2fp8.py``;
    ``stats`` as ``s2fp8_fused``'s."""
    if x.is_cuda:
        return s2fp8_fused(x, gen, stochastic=stochastic, check_inf=check_inf, stats=stats)
    if x.device.type == "cpu":
        return s2fp8_quantize_dequantize(x, gen, stochastic=stochastic, check_inf=check_inf,
                                         stats=stats)
    raise ValueError(f"no S2FP8 path for device {x.device}")
