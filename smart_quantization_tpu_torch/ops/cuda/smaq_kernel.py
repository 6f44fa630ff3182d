"""Fused SmaQ on the card: the wrappers of ``csrc/smaq.cu``, their plain
PyTorch version, and the dispatcher.

The port of ``smart_quantization_tpu/ops/pallas/smaq_kernel.py::smaq_fused``
(and of the one-pass statistics reduction its wrapper runs first) and of
its BatchNorm-folded variant ``smaq_fused_bn``.  The source note in
``csrc/smaq.cu`` gives the design.  Here:

- ``smaq_stats``, ``smaq_quantize``, ``smaq_quantize_bn`` and
  ``smaq_onepass`` launch the kernels on PyTorch's current stream and
  count their launches in ``LAUNCHES``;
- ``smaq_plan`` picks a full-stats call's form from its size and the card:
  one ``smaq_quantize`` block that computes its own stats (``SMALL_MAX``
  elements or fewer); for bfloat16, up to what the card's shared memory
  holds (``onepass_capacity``), ``smaq_onepass``: one cooperative launch
  that keeps x on chip between its stats and its quantize pass; else
  ``smaq_stats`` then ``smaq_quantize``;
- ``smaq_fused`` and ``smaq_fused_bn`` are the kernel paths of one SmaQ
  call on a CUDA tensor, without and with (gamma, beta); the BN kernel's
  bfloat16 form has a loop of its own (16-byte loads, a running channel,
  compile-time modes: ``bn_blocks``);
- ``smaq_fused_reference`` and ``smaq_fused_bn_reference`` are the
  kernels' plain versions: the same arithmetic in PyTorch ops
  (pivot-shifted one-pass stats, folded reciprocals), for any device;
- ``smaq_fused_or_reference`` sends a CUDA tensor to the kernels and a CPU
  tensor to ``ops/smaq.py``.  On the card every tensor of ``min_size`` or
  more elements goes to a kernel, and a scalar gamma
  (``--bn_scalar_params``) to the BN kernel.

BatchNorm tensors are NCHW: gamma and beta are per channel (dim 1), or 0-d
for one scalar pair.

Each kernel reads and writes float32 or bfloat16 elements
(``launch.DTYPES``; a bfloat16 call is the float32 kernel on the widened
tensor, its output rounded to nearest-even, bit for bit); sizes count 32
original bits an element whatever the dtype, as the JAX package does.  A
tensor of another dtype is cast to float32 and back.

Stochastic rounding keys the kernel's Philox stream by a step key in device
memory and a call index (``launch.key_for``: a ``DeviceKey``'s next index,
or one draw from a host ``torch.Generator``), counted from the call's
element offset in a larger tensor (a ``PartKey``'s); the plain versions
draw their noise from the caller's key by ``ops/rounding.py``, which gives
other bits, so stochastic outputs compare by statistics only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from smart_quantization_tpu_torch.ops.cuda import build
from smart_quantization_tpu_torch.ops.cuda import launch
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
    quant_blocks,
    raise_on,
    sm_count,
    split_blocks,
    stream,
    with_bf16_forms,
)
from smart_quantization_tpu_torch.ops.rounding import uniform
from smart_quantization_tpu_torch.ops.smaq import SmaQParams, smaq_quantize_dequantize

# Launches of each kernel since the last reset (one per launch, nowhere
# else), its bfloat16 form under the name with "_bf16"; the one-launch form
# has only a bfloat16 form.
LAUNCHES = {**with_bf16_forms(("smaq_stats", "smaq_quantize", "smaq_quantize_bn")),
            "smaq_onepass_bf16": 0}

# The TPU kernel's in-kernel sample spans its first block of 512 x 1024.
_SAMPLE_SPAN = 512 * 1024
# stats modes of the quantize kernels: a given (mean, std) pair, the
# constants smaq_stats wrote, the small form's own stats
_GIVEN, _CONSTS, _SMALL = 0, 1, 2
# the BN kernel keeps one float4 per channel in shared memory (48 KB)
MAX_BN_CHANNELS = 3072
# The BN kernel's bfloat16 form reads 8 bf16 (16 bytes) a thread per step,
# on BLOCKS_PER_SM blocks of THREADS a SM at most (bn_blocks)
BN_BF16_LOAD_ELEMS = 8

# The split form's launch shape is launch.py's (split_blocks).  The small
# form: one block of SMALL_THREADS computes the stats and then quantizes,
# one launch; above SMALL_MAX elements two launches spread over the card
# are faster (measured: PERF.md).
SMALL_THREADS = 1024
SMALL_MAX = 16384
# The workspace of a (device, stream): the kernels' counters, then 4
# float64 partials per stats block (csrc/smaq.cu: kCounterWords).
_COUNTER_WORDS = 4
# The one-launch form holds each thread's groups of four bf16 in slots of
# SLOT_BYTES of shared memory (csrc/smaq.cu: kSlotBytes); a card holds as
# many slots a thread as leave BLOCKS_PER_SM blocks of THREADS resident on
# an SM (asked of the card once: onepass_slots; 27 on an H100).
SLOT_BYTES = 8
_ONEPASS_SLOTS: dict[int, int] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def workspace_words(sms: int) -> int:
    """64-bit words of a workspace: the counters and the partials of the
    largest stats launch on a card of ``sms`` SMs."""
    return _COUNTER_WORDS + 4 * sms * BLOCKS_PER_SM


def bn_blocks(n: int, dtype: torch.dtype, sms: int) -> int:
    """Blocks of THREADS of a ``smaq_quantize_bn`` launch on ``n`` elements:
    ``quant_blocks``' grid for float32; for bfloat16 BLOCKS_PER_SM a SM on
    ``sms`` SMs, and no more than give each thread one 16-byte load."""
    if dtype == torch.bfloat16:
        return max(1, min(sms * BLOCKS_PER_SM, -(-n // (BN_BF16_LOAD_ELEMS * THREADS))))
    return quant_blocks(n)


def onepass_capacity(sms: int, slots: int) -> int:
    """Elements the one-launch form takes on a card of ``sms`` SMs that
    holds ``slots`` slots a thread: every thread of BLOCKS_PER_SM blocks a
    SM holds ``slots`` groups of four."""
    return sms * BLOCKS_PER_SM * THREADS * 4 * slots


def smaq_plan(n: int, sms: int, slots: int = 0) -> tuple[str, int]:
    """The form of a full-stats SmaQ call of ``n`` elements on a card of
    ``sms`` SMs: ``("small", 1)`` (one ``smaq_quantize`` block of
    SMALL_THREADS, no stats launch), ``("onepass", blocks)`` (one
    cooperative ``smaq_onepass`` launch; a bfloat16 call whose card holds
    ``slots`` slots a thread, ``onepass_slots``, up to ``onepass_capacity``)
    or ``("split", blocks)`` (``smaq_stats`` then ``smaq_quantize``).  Every
    form but the small one runs on ``split_blocks(n, sms)`` blocks of
    THREADS.  ``slots=0``: no one-launch form (float32)."""
    if n <= SMALL_MAX:
        return "small", 1
    if n <= onepass_capacity(sms, slots):
        return "onepass", split_blocks(n, sms)
    return "split", split_blocks(n, sms)


def onepass_slots(device: torch.device) -> int:
    """The most slots a thread of ``smaq_onepass`` can hold with
    BLOCKS_PER_SM blocks of THREADS resident on each SM of ``device``'s card
    (from the card's shared memory a SM, its reserve a block and the
    kernel's static shared memory: ``csrc/smaq.cu::smaq_onepass_smem``),
    asked of the card once."""
    if device.index not in _ONEPASS_SLOTS:
        smem = ctypes.c_longlong(0)
        raise_on(build.library().smaq_onepass_smem(BLOCKS_PER_SM, THREADS,
                                                   ctypes.addressof(smem)), "smaq_onepass_smem")
        _ONEPASS_SLOTS[device.index] = smem.value // (THREADS * SLOT_BYTES)
    return _ONEPASS_SLOTS[device.index]


def plan_slots(xf: torch.Tensor) -> int:
    """The ``slots`` argument of ``smaq_plan`` for ``xf``: its card's for a
    bfloat16 tensor, 0 (no one-launch form) for float32."""
    return onepass_slots(xf.device) if xf.dtype == torch.bfloat16 else 0


def full_stats_form(xf: torch.Tensor) -> str:
    """``smaq_plan``'s form of a full-stats call on ``xf``."""
    return smaq_plan(xf.numel(), sm_count(xf.device), plan_slots(xf))[0]


def workspace(xf: torch.Tensor) -> torch.Tensor:
    """The SmaQ kernels' counters and stats partials on ``xf``'s card and
    current stream (``launch.workspace``)."""
    return launch.workspace(xf, "smaq", workspace_words(sm_count(xf.device)))


def _quant_args(params: SmaQParams) -> tuple:
    """The scalar arguments every SmaQ kernel takes."""
    return (
        params.main_std_dev_threshold, params.range_main, params.range_outlier,
        1.0 / params.range_main, 1.0 / params.range_outlier,
        params.std_clamp_lo, params.std_clamp_hi,
        params.num_bits_main, params.num_bits_outlier,
    )


# smaq_stats' folded sums (its ``sums`` output): sum(d), sum(d * d), min
# and max of x, and the pivot, d = x - pivot; float64
SUM_WORDS = 5


def smaq_stats(xf: torch.Tensor, params: SmaQParams,
               sums: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the stats kernel on a flat float32 or bfloat16 tensor; returns
    the per-tensor constants its last block folds, float32 ``[mean, std, 1 / std,
    std / range_main, std / range_outlier, t * std, 0, 0]`` (std after the zero-std guard and
    the clamp; ``consts_reference`` is their plain version).  ``sums``, a
    float64 tensor of ``SUM_WORDS`` on the card, also gets the folded sums
    the constants come from (``pivot_sums_reference`` is their plain
    version), for statistics reduced over ranks."""
    check_input(xf)
    n = xf.numel()
    if sums is not None and (sums.dtype != torch.float64 or sums.numel() != SUM_WORDS
                             or sums.device != xf.device or not sums.is_contiguous()):
        raise ValueError(f"sums must be {SUM_WORDS} contiguous float64 on the tensor's device")
    consts = torch.empty(8, dtype=torch.float32, device=xf.device)
    rc = build.library().smaq_stats(
        xf.data_ptr(), n, DTYPES[xf.dtype], int(params.use_range_std_dev), *_quant_args(params),
        workspace(xf).data_ptr(), consts.data_ptr(), ptr(sums),
        split_blocks(n, sm_count(xf.device)), THREADS, stream(xf),
    )
    raise_on(rc, "smaq_stats")
    LAUNCHES[form_name("smaq_stats", xf)] += 1
    return consts


def read_consts(consts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) from the stats kernel's constants, for reading its
    result on its own."""
    return consts[0], consts[1]


def _stats_args(xf, stats, consts):
    """(stats or None, consts or None, mode): neither is the small form."""
    if stats is not None and consts is not None:
        raise ValueError("pass at most one of stats= and consts=")
    if stats is not None:
        if stats.dtype != torch.float32 or stats.numel() != 2 or stats.device != xf.device:
            raise ValueError("stats must be a float32 (mean, std) pair on the tensor's device")
        return stats.contiguous(), None, _GIVEN
    if consts is not None:
        if (consts.dtype != torch.float32 or consts.numel() != 8 or consts.device != xf.device
                or not consts.is_contiguous() or consts.data_ptr() % 16):
            raise ValueError("consts must be smaq_stats' 8 float32 constants on the tensor's device")
        return None, consts, _CONSTS
    return None, None, _SMALL


def smaq_quantize(
    xf: torch.Tensor,
    params: SmaQParams,
    *,
    key: torch.Tensor | None,
    call: int = 0,
    offset: int = 0,
    stats: torch.Tensor | None = None,
    consts: torch.Tensor | None = None,
    all_positive: bool = False,
    compute_size: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantize kernel against ``stats`` (a float32 (mean, std)
    pair on the device) or ``smaq_stats``' ``consts``; with neither, the
    small form (``SMALL_MAX`` elements at most): one block computes the
    full stats itself, then quantizes.  Stochastic rounding draws
    (``key``, ``call``): ``key`` a 1-element int64 step key on the card,
    element e the word of element ``offset + e``.  Returns the flat
    output, of ``xf``'s dtype, and the size in bits as a 0-d float32
    device tensor."""
    check_input(xf)
    check_key(key, xf, params.stochastic_rounding, offset)
    stats, consts, mode = _stats_args(xf, stats, consts)
    n = xf.numel()
    if mode == _SMALL and n > SMALL_MAX:
        raise ValueError(f"the small form takes at most {SMALL_MAX} elements, got {n}: "
                         "pass stats= or smaq_stats' consts=")
    y = torch.empty_like(xf)
    size = torch.empty((), dtype=torch.float32, device=xf.device)
    blocks, threads = (
        (1, SMALL_THREADS) if mode == _SMALL else (split_blocks(n, sm_count(xf.device)), THREADS))
    rc = build.library().smaq_quantize(
        xf.data_ptr(), y.data_ptr(), n, DTYPES[xf.dtype], ptr(stats), ptr(consts), mode,
        int(params.use_range_std_dev), ptr(key), call, offset, int(params.stochastic_rounding),
        int(all_positive), int(compute_size), *_quant_args(params),
        workspace(xf).data_ptr(), size.data_ptr(), blocks, threads, stream(xf),
    )
    raise_on(rc, "smaq_quantize")
    LAUNCHES[form_name("smaq_quantize", xf)] += 1
    return y, size


def smaq_onepass(
    xf: torch.Tensor,
    params: SmaQParams,
    *,
    key: torch.Tensor | None,
    call: int = 0,
    offset: int = 0,
    all_positive: bool = False,
    compute_size: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the one-launch form on a flat bfloat16 tensor that
    ``smaq_plan`` gives it (more than ``SMALL_MAX`` elements, no more than
    the card's ``onepass_capacity``): the full stats, then the quantize pass
    on the groups held in shared memory.  ``key``, ``call`` and ``offset``
    as ``smaq_quantize``'s.  Returns the flat bfloat16 output, the size in
    bits as a 0-d float32 device tensor and the 8 constants ``smaq_stats``
    would write."""
    check_input(xf, (torch.bfloat16,))
    check_key(key, xf, params.stochastic_rounding, offset)
    n = xf.numel()
    form, blocks = smaq_plan(n, sm_count(xf.device), onepass_slots(xf.device))
    if form != "onepass":
        raise ValueError(f"the one-launch form does not take {n} elements on this card "
                         f"({form} form)")
    y = torch.empty_like(xf)
    size = torch.empty((), dtype=torch.float32, device=xf.device)
    consts = torch.empty(8, dtype=torch.float32, device=xf.device)
    rc = build.library().smaq_onepass(
        xf.data_ptr(), y.data_ptr(), n, DTYPES[xf.dtype], int(params.use_range_std_dev),
        ptr(key), call, offset, int(params.stochastic_rounding), int(all_positive),
        int(compute_size), *_quant_args(params), workspace(xf).data_ptr(), consts.data_ptr(),
        size.data_ptr(),
        blocks, THREADS, stream(xf),
    )
    raise_on(rc, "smaq_onepass")
    LAUNCHES["smaq_onepass_bf16"] += 1
    return y, size, consts


def smaq_quantize_bn(
    xf: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    channels: int,
    inner: int,
    params: SmaQParams,
    *,
    key: torch.Tensor | None,
    call: int = 0,
    offset: int = 0,
    stats: torch.Tensor | None = None,
    consts: torch.Tensor | None = None,
    all_positive: bool = False,
    compute_size: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the BN-folded quantize kernel: ``xf`` is the flat NCHW tensor,
    element e in channel ``(e // inner) % channels``, and ``gamma``/``beta``
    hold ``channels`` float32 values on the device; one of ``stats`` and
    ``consts`` is required; ``key``, ``call`` and ``offset`` as
    ``smaq_quantize``'s."""
    check_input(xf)
    check_key(key, xf, params.stochastic_rounding, offset)
    for v in (gamma, beta):
        check_input(v, (torch.float32,))
        if v.numel() != channels:
            raise ValueError(f"gamma and beta need {channels} values, got {v.numel()}")
    if not 1 <= channels <= MAX_BN_CHANNELS:
        raise ValueError(f"the BN kernel takes 1 to {MAX_BN_CHANNELS} channels, got {channels}")
    stats, consts, mode = _stats_args(xf, stats, consts)
    if mode == _SMALL:
        raise ValueError("the BN kernel needs stats= or consts=")
    n = xf.numel()
    y = torch.empty_like(xf)
    size = torch.empty((), dtype=torch.float32, device=xf.device)
    rc = build.library().smaq_quantize_bn(
        xf.data_ptr(), y.data_ptr(), n, DTYPES[xf.dtype], ptr(stats), ptr(consts), mode,
        gamma.data_ptr(), beta.data_ptr(), channels, inner,
        ptr(key), call, offset, int(params.stochastic_rounding), int(all_positive),
        int(compute_size), *_quant_args(params), workspace(xf).data_ptr(), size.data_ptr(),
        bn_blocks(n, xf.dtype, sm_count(xf.device)), THREADS, stream(xf),
    )
    raise_on(rc, "smaq_quantize_bn")
    LAUNCHES[form_name("smaq_quantize_bn", xf)] += 1
    return y, size


def sample_stats(flat: torch.Tensor, params: SmaQParams) -> torch.Tensor:
    """``use_sample_stats``: mean and biased std (or the range std) over the
    TPU kernel's deterministic positions ``flat[:n_block:stride]``
    (smaq_kernel.py:101-114); a float32 (mean, std) pair."""
    n = flat.numel()
    n_block = min(n, _SAMPLE_SPAN)
    stride = max(n_block // params.num_samples, 1)
    s = flat[:n_block:stride].float()
    k = s.numel()
    m1 = s.sum() / k
    if params.use_range_std_dev:
        std = (s.max() - s.min()) / math.sqrt(2.0 * math.log(k))
    else:
        std = ((s * s).sum() / k - m1 * m1).clamp_min(0.0).sqrt()
    return torch.stack([m1, std])


def pivot_sums_reference(flat: torch.Tensor) -> torch.Tensor:
    """``smaq_stats``' folded sums in PyTorch ops: float64 ``[sum(d),
    sum(d * d), min, max, pivot]`` of ``d = x - pivot``, the pivot the mean
    of the first 256 elements in float32."""
    flat = flat.reshape(-1).float()
    pivot = flat[: min(flat.numel(), 256)].mean()
    d = (flat - pivot).double()
    return torch.stack([d.sum(), (d * d).sum(), flat.min().double(), flat.max().double(),
                        pivot.double()])


def fold_sums(sums: torch.Tensor, n: int, params: SmaQParams) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and std (0-d float32, before the guard and the clamp) of a
    tensor whose W parts hold ``n`` elements each and folded ``sums`` (W,
    5) (ranks' parts: ``parallel/whole_batch.py``): each part's sums moved
    to part 0's pivot, added in order, then ``smaq_stats``' expressions
    (``csrc/smaq.cu``: ``finish_stats``): ddof=1, or the range std.  One
    part's sums give its own mean and std."""
    s1, s2, mn, mx, pivot = sums.unbind(1)
    d = pivot - pivot[0]
    s1_all = (s1 + n * d).sum()
    s2_all = (s2 + 2.0 * d * s1 + n * d * d).sum()
    total = float(n * sums.shape[0])
    mean = (pivot[0] + s1_all / total).float()
    if params.use_range_std_dev:
        std = (mx.max().float() - mn.min().float()) / math.sqrt(2.0 * math.log(total))
    else:
        var = ((s2_all - s1_all * (s1_all / total)) / max(total - 1.0, 1.0)).clamp_min(0.0)
        std = var.sqrt().float()
    return mean, std


def pivot_stats_reference(
    flat: torch.Tensor, params: SmaQParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """The stats kernel's plain version, before the guard and the clamp:
    mean and ddof=1 std from the sums of ``d = x - pivot`` in float64
    (pivot = mean of the first 256 elements), or the range std."""
    return fold_sums(pivot_sums_reference(flat)[None], flat.numel(), params)


def consts_reference(mean: torch.Tensor, std: torch.Tensor, params: SmaQParams) -> torch.Tensor:
    """The constants ``smaq_stats`` writes, from a (mean, std) pair: the
    zero-std guard, the clamp, then the folded reciprocals of
    ``smaq_kernel.py:121-130`` less its ``b = -mean / std`` (the kernels
    take ``(x - mean) * a``), padded with zeros to a float32 tensor of 8."""
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    std = std.clamp(params.std_clamp_lo, params.std_clamp_hi)
    zero = torch.zeros_like(std)
    return torch.stack([
        mean, std, 1.0 / std, std * (1.0 / params.range_main),
        std * (1.0 / params.range_outlier), params.main_std_dev_threshold * std, zero, zero,
    ])


def _given_stats(mean, std, device) -> torch.Tensor:
    return torch.stack([torch.as_tensor(mean), torch.as_tensor(std)]).to(
        device=device, dtype=torch.float32
    )


def _stats_form(xf, params, mean, std) -> str:
    """Where a call's stats come from: ``given`` (the caller's (mean,
    std)), ``sampled``, or the form ``smaq_plan`` gives a full-stats call."""
    if mean is not None and std is not None:
        return "given"
    if params.use_sample_stats and xf.numel() > params.num_samples:
        return "sampled"
    return full_stats_form(xf)


def _device_stats(xf, params, mean, std, form):
    """(stats, consts) for a quantize launch of ``_stats_form``'s ``form``:
    the caller's (mean, std), the sampled stats, (None, None) for the small
    form (the quantize block computes them), or the stats kernel's
    constants."""
    if form == "given":
        return _given_stats(mean, std, xf.device), None
    if form == "sampled":
        return sample_stats(xf, params), None
    if form == "small":
        return None, None
    return None, smaq_stats(xf, params)


def smaq_fused(
    x: torch.Tensor,
    gen: torch.Generator | None,
    params: SmaQParams = SmaQParams(),
    *,
    all_positive: bool = False,
    compute_size: bool = True,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SmaQ of a CUDA tensor through the kernels; same contract as
    ``smaq_quantize_dequantize``.  ``compute_size=False`` skips the outlier
    count and returns the static all-main-bucket floor as the size."""
    if not x.is_cuda:
        raise ValueError(f"smaq_fused takes CUDA tensors, got {x.device}")
    n = x.numel()
    if n < params.min_size:
        return x, torch.full((), float(n * 32), device=x.device)
    xf = kernel_input(x)
    key, call, offset = key_for(gen, params.stochastic_rounding, x.device, n)
    form = _stats_form(xf, params, mean, std)
    if form == "onepass":
        y, size, _ = smaq_onepass(xf, params, key=key, call=call, offset=offset,
                                  all_positive=all_positive, compute_size=compute_size)
    else:
        stats, consts = _device_stats(xf, params, mean, std, form)
        y, size = smaq_quantize(
            xf, params, key=key, call=call, offset=offset, stats=stats, consts=consts,
            all_positive=all_positive, compute_size=compute_size,
        )
    return y.view(x.shape).to(x.dtype), size


def channel_layout(x: torch.Tensor, gamma: torch.Tensor) -> tuple[int, int]:
    """(channels, inner) of the fold: a 0-d gamma is one pair for the whole
    tensor; a (C,) gamma runs over dim 1 of ``x``."""
    if gamma.dim() == 0:
        return 1, 1
    if gamma.dim() == 1 and x.dim() >= 2 and x.shape[1] == gamma.numel():
        return gamma.numel(), math.prod(x.shape[2:])
    raise ValueError(
        f"gamma of shape {tuple(gamma.shape)} does not fold over dim 1 of {tuple(x.shape)}"
    )


def smaq_fused_bn(
    x: torch.Tensor,
    gen: torch.Generator | None,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    params: SmaQParams = SmaQParams(),
    *,
    all_positive: bool = False,
    compute_size: bool = True,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """BN-folded SmaQ of a CUDA tensor through the kernels: the stats of
    the raw tensor (``smaq_stats``, or the sampled or given stats), then
    ``smaq_quantize_bn``."""
    if not x.is_cuda:
        raise ValueError(f"smaq_fused_bn takes CUDA tensors, got {x.device}")
    n = x.numel()
    if n < params.min_size:
        return x, torch.full((), float(n * 32), device=x.device)
    channels, inner = channel_layout(x, gamma)
    xf = kernel_input(x)
    key, call, offset = key_for(gen, params.stochastic_rounding, x.device, n)
    form = _stats_form(xf, params, mean, std)
    # the BN kernel always reads given, sampled or smaq_stats' constants
    stats, consts = _device_stats(xf, params, mean, std,
                                  form if form in ("given", "sampled") else "split")
    y, size = smaq_quantize_bn(
        xf, gamma.reshape(-1).to(torch.float32).contiguous(),
        beta.reshape(-1).to(torch.float32).contiguous(), channels, inner, params,
        key=key, call=call, offset=offset, stats=stats, consts=consts,
        all_positive=all_positive, compute_size=compute_size,
    )
    return y.view(x.shape).to(x.dtype), size


def _reference_consts(flat, params, mean, std):
    """The kernels' constants in PyTorch ops (``consts_reference``) from
    the caller's stats, the sampled ones, or the pivot-shifted full ones."""
    if mean is not None and std is not None:
        mean, std = _given_stats(mean, std, flat.device).unbind()
    elif params.use_sample_stats and flat.numel() > params.num_samples:
        mean, std = sample_stats(flat, params).unbind()
    else:
        mean, std = pivot_stats_reference(flat, params)
    return consts_reference(mean, std, params)


def _buckets(z, params, gen, u):
    """Bucket and round the normalized ``z`` as the kernels do; returns
    (q, hi, lo, outlier)."""
    t = params.main_std_dev_threshold
    hi, lo = z > t, z < -t
    outlier = hi | lo
    shift = torch.where(hi, -t, torch.where(lo, t, 0.0))
    scale = torch.where(outlier, params.range_outlier, params.range_main)
    q = (z + shift) * scale
    if params.stochastic_rounding or u is not None:
        if u is None:
            if gen is None:
                raise ValueError("stochastic rounding requires a torch.Generator")
            # top 24 random bits, as the kernel takes them
            u = torch.floor(uniform(q.shape, gen, q.device) * 2**24) * 2.0**-24
        q = torch.floor(q + u.reshape(q.shape))
    else:
        q = torch.trunc(q)
    return q, hi, lo, outlier


def _reference_size(outlier, n, params, compute_size, device):
    bm, bo = params.num_bits_main, params.num_bits_outlier
    if compute_size:
        return (n * bm + outlier.sum().double() * (bo - bm)).float()
    return torch.full((), float(n * bm), device=device)


def smaq_fused_reference(
    x: torch.Tensor,
    gen: torch.Generator | None,
    params: SmaQParams = SmaQParams(),
    *,
    all_positive: bool = False,
    compute_size: bool = True,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' plain version, in PyTorch ops on any device.

    Follows the kernel's arithmetic: pivot-shifted one-pass sums folded in
    float64 (``smaq_kernel.py:268-278``), the folded reciprocals
    (119-130), ``z = (x - mean) * a`` (the TPU kernel's ``x * a + b``
    cancels where ``|mean| >> std``) and ``q * inv_scale_std + shift_term
    + mean`` (167-172).
    ``u`` (float32, ``x``'s shape) replaces the rounding noise, so a test
    can put every element on its lower (``u = 0``) or upper (``u = 1``)
    grid point."""
    n = x.numel()
    if n < params.min_size:
        return x, torch.full((), float(n * 32), device=x.device)
    flat = x.reshape(-1).to(torch.float32)
    mean, _, a, inv_main_std, inv_out_std, t_std, _, _ = _reference_consts(
        flat, params, mean, std).unbind()

    q, hi, lo, outlier = _buckets((flat - mean) * a, params, gen, u)
    inv_scale_std = torch.where(outlier, inv_out_std, inv_main_std)
    shift_term = torch.where(hi, t_std, torch.where(lo, -t_std, torch.zeros_like(t_std)))
    y = q * inv_scale_std + shift_term + mean
    if all_positive:
        y = y.clamp_min(0.0)
    size = _reference_size(outlier, n, params, compute_size, x.device)
    return y.view(x.shape).to(x.dtype), size


def smaq_fused_bn_reference(
    x: torch.Tensor,
    gen: torch.Generator | None,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    params: SmaQParams = SmaQParams(),
    *,
    all_positive: bool = False,
    compute_size: bool = True,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The BN kernel's plain version, in PyTorch ops on any device.

    The stats of the raw tensor as ``smaq_fused_reference`` takes them,
    then the per-channel constants of ``smaq_kernel.py:436-443`` (gamma = 0
    taken as 1): z = (x - H) * A, zhat = q / scale - shift, y = zhat * G + H."""
    n = x.numel()
    if n < params.min_size:
        return x, torch.full((), float(n * 32), device=x.device)
    channels, inner = channel_layout(x, gamma)
    flat = x.reshape(-1, channels, inner).to(torch.float32)
    mean, std = _reference_consts(flat.reshape(-1), params, mean, std)[:2].unbind()

    g = gamma.reshape(1, -1, 1).to(torch.float32)
    g = torch.where(g == 0.0, torch.ones_like(g), g)
    b = beta.reshape(1, -1, 1).to(torch.float32)
    a = 1.0 / (g * std)
    gg = std * g
    # the kernel's H = fma(mean, g, beta): the product is exact in float64
    hh = (mean.double() * g.double() + b.double()).float()

    q, hi, lo, outlier = _buckets((flat - hh) * a, params, gen, u)
    t = params.main_std_dev_threshold
    shift = torch.where(hi, -t, torch.where(lo, t, 0.0))
    inv_scale = torch.where(outlier, 1.0 / params.range_outlier, 1.0 / params.range_main)
    y = (q * inv_scale - shift) * gg + hh
    if all_positive:
        y = y.clamp_min(0.0)
    size = _reference_size(outlier, n, params, compute_size, x.device)
    return y.view(x.shape).to(x.dtype), size


def smaq_fused_or_reference(
    x: torch.Tensor,
    gen: torch.Generator | None,
    params: SmaQParams = SmaQParams(),
    *,
    all_positive: bool = False,
    compute_size: bool = True,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
    gamma: torch.Tensor | None = None,
    beta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A CUDA tensor goes to the kernels (the BN kernel when ``gamma`` and
    ``beta`` are given), a CPU tensor to ``ops/smaq.py``.

    The CPU path always computes the true size; ``compute_size`` only
    spares the kernel's outlier count."""
    if x.is_cuda:
        if gamma is not None and beta is not None:
            return smaq_fused_bn(
                x, gen, gamma, beta, params, all_positive=all_positive,
                compute_size=compute_size, mean=mean, std=std,
            )
        return smaq_fused(
            x, gen, params, all_positive=all_positive,
            compute_size=compute_size, mean=mean, std=std,
        )
    if x.device.type == "cpu":
        return smaq_quantize_dequantize(
            x, gen, params, all_positive=all_positive, mean=mean, std=std,
            gamma=gamma, beta=beta,
        )
    raise ValueError(f"no SmaQ path for device {x.device}")
