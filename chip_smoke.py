#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh_only
    python3 chip_smoke.py --times_of DIR

With no arguments, phases, each printing its own lines; any failure exits
non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build the CUDA kernels from ``smart_quantization_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (the largest ResNet-18 batch-128 activation, bert-base's
   largest activation and its word-embedding table, a ragged tensor, a
   BatchNorm leaf, the fc bias, an ill-conditioned tensor of mean 1e3 and
   std 1e-2, held by the flip rule like the others: the kernels compute
   z = (x - mean) * a):
   SmaQ in truncation, stochastic, ``all_positive`` and
   ``compute_size=False`` modes; the float formats (FP8, FP16, BF16)
   bitwise in nearest mode with and without ``check_inf``, on their grid
   and unbiased in stochastic mode; S2FP8's stats kernel's constants
   (mu, max, alpha, beta, 1/alpha and the unsqueeze table) and its output
   in both forms, around the small form's threshold and on constant
   tensors; the BatchNorm-folded SmaQ on NCHW tensors, a scalar pair, a
   zero gamma and an ill-conditioned map; SmaQ's one-block small form at
   the main path's small sizes and around its threshold, the stats
   kernel's constants buffer,
   and the outlier size after 1000 back-to-back calls (the self-resetting
   counters); 1000 back-to-back calls of both S2FP8 forms and SmaQ; the
   packed state's codebook against the kernels' fake path and its CPU
   version by the flip rule, and the dense packer's round trip; the Philox
   fill (the tensor-op noise of a step on the card) bitwise against its
   plain version at bert-base's dropout sizes, and the float kernel's
   stochastic bits against the fill's words for the same key; each
   kernel's bfloat16 form (``--compute_dtype bfloat16``) at the same shapes
   in bf16 bitwise against its float32 form on the widened input rounded
   to nearest-even (outputs and sizes, truncation and stochastic) and
   against its plain version by the rules above, and 1000 back-to-back
   bf16 calls; the bf16 forms redesigned for the card (the one-launch
   SmaQ form ``smaq_onepass``, the two-launch bf16 path, float_quantize's
   16-byte loop) bitwise the float32 form on the widened input and each
   other, in outputs, sizes and SmaQ's constants, at the one-launch
   form's capacity -1 / +0 / +1, bert-base's 12 582 912 elements, a
   ragged size and a misaligned pointer, a launch one slot beyond the
   card's shared memory (refused), captured in a CUDA graph and over 1000
   back-to-back calls (every counter back to 0); the bf16 forms of S2FP8's
   split path (the stats' log2 table on all 32 768 bf16 magnitudes against
   log2f, the quantize's per-block table of the element function) and of
   the BN kernel (16-byte loads, a running channel) bitwise the float32
   form on the widened input, rounded, in S2FP8's constants and outputs and
   BN's outputs and sizes, at 8 388 608, 12 582 912, S2FP8's SMALL_MAX -1 /
   +1, 16 385 and 300 001 elements, the sizes where the tables take over,
   a tensor of zeros, tiny, huge and
   subnormal values, BN_SHAPE, RAGGED_BN_SHAPE, inner 9 and inner 4 maps,
   a scalar and a zero gamma, one channel and a pointer 2 bytes off, on
   two tensors of other stats in turn, in a CUDA graph and over 1000
   back-to-back calls; the stats kernel's mean and std and the C++ SmaQ
   golden model's (``smaq_golden.py``: modes 0 and 1) each against float64
   (``check_golden``), and the binding refusing a CUDA tensor; the
   whole-batch step's entries (``check_whole_tensor_stats``: the stats
   kernels' ``sums`` and their folds over 4 parts, ``given_consts``, the
   SmaQ, BN and S2FP8 quantize kernels on given statistics) at the largest
   and a ragged shape, float32 and bfloat16; every stochastic kernel at an
   element offset (``check_offsets``: each quantize form on 4 parts at
   their offsets against the whole launch, each part and an offset beyond
   32 bits against its plain version fed the fill's words there, the
   one-launch form against the two-launch form at an offset, the fill);
4. the main paths: ``python -m smart_quantization_tpu_torch.train``'s
   ``main`` on full-width ResNet-18, batch 128, synthetic CIFAR-10, with
   every structure compressed by SmaQ 6/8, FP8, FP16, BF16, S2FP8, and SmaQ
   with ``--use_batch_norm`` (and ``--bn_scalar_params``), with the master
   weights and with packed SGD momentum, and on bert-base, batch 32 x 512
   tokens, synthetic GLUE STSB, SmaQ 6/8 on every structure, AdamW at lr
   2e-5 and weight decay 0.01 (z-score, and ``--momentum_rowwise
   --momentum_log_nu``), launch counts read around each; then 17 steps of
   each: launches per step, no host sync between logging points, and the
   median step time beside the uncompressed step (for BERT with the peak
   device memory and the memory held between steps, and with packed
   state as well); the loss after 17 steps of the codecs against the plain
   run's; ``--steps_per_call``: each cell's seeded command at K=1 and at K
   (ResNet-18 SmaQ at K=8 over two epochs of 10 steps; bert-base at K=4 in
   its z-score, codecs and packed forms; K=2 for FP8, FP16, BF16, S2FP8,
   ``--use_batch_norm``, the master weights, packed momentum and sampled
   stats), every loss and checkpoint tensor bitwise equal; the launches of
   a first group (warm-up and capture) and of replays (none from the host,
   no host sync), a run resumed under K against the straight run, grouped
   against single evaluation, a ``--profile_dir`` trace with the five
   regions, and each K-step cell's step time, device idle share, launches,
   peak and held memory at K=1 and at K (``chiprun_out/k_step_times.json``);
   each cell's seeded command twice, bitwise, and the step under
   PyTorch's default kernels (determinism's cost); under
   ``--compute_dtype bfloat16``: ResNet-18 with SmaQ 6/8 (with
   ``--measure_average_grad_norm``), FP8, FP16, BF16, S2FP8 and
   ``--use_batch_norm``, bert-base with the stable codecs beside its
   ``--no_compress`` step (the loss after 17 steps within 1.25x), each
   with its ratio, launches per step equal to the plan with no dtype cast
   inside an encoder call, no host sync, K=8 / K=4 against K=1 and two
   seeded runs bitwise, and each K-step cell timed; ``--compress_loss``
   (SmaQ, FP8), ``--auto_lr_find`` at K=8 (the weights and graphs put
   back) and ``--auto_scale_batch_size`` (an out-of-memory trial under a
   memory cap, its memory given back, then a step at batch 128);
   Inception-v3 on synthetic CIFAR-10 at batch 128 with SmaQ 6/8 on every
   structure (``inception_cell``), in float32 and in bfloat16: the CLI's
   main path, launches a step equal to the plan (1226 encoder calls), its
   ratio, K=8 against K=1 bitwise, the seeded command twice bitwise, a
   ``--use_batch_norm`` run, the K=8 graph's capture and memory, and each
   form's step profile at K=1 and K=8 (``chiprun_out/inception_times.json``);
4b. the mesh (``parallel/``): W = min(cards, 4) NCCL ranks, one card each,
   started once (``RankPool``); ResNet-18 at the global batch of 128 with
   int8 gradient payloads in gather and psum mode, each at K=1 and K=8
   (finite losses, the ratio in 4.5-5.5, K=8 bitwise eight K=1 steps,
   every rank's parameters bitwise equal, launches a step, the step time
   beside phase 4's single-card step, the exchange alone by CUDA events,
   its NCCL kernels' device time in a step by the profiler, the bytes it
   moves by the traffic table), bert-base STSB 3 steps, and with two cards
   or more the fused FSDP path (``--fsdp W --param_gather_bits 8
   --packed_momentum --packed_weights``) under the same checks at K=1 and
   K=8, its single-card counterpart's step, and ``python -m
   smart_quantization_tpu_torch.train --dp W`` (K=8) and ``--fsdp W``
   (packed state) as a user runs them, the CLI spawning its ranks (exit 0,
   one ``final:`` line, one log, one checkpoint of the mesh); at W = 1 the
   cells build the trainer with a one-rank mesh and the command line's
   spawn is left to a machine of more cards; then the whole-batch float32
   FSDP step (``parallel/train_fsdp.py``: ResNet-18, batch 128, SmaQ 6/8
   full coverage, SGD momentum 0.9) on a (1, W) mesh: launches a step
   against the plan (``whole_batch_plan``), every rank bitwise equal, one
   step of the optimizer's truncation SmaQ (taps off) against the
   single-card trainer's step by the flip rule, its median step, peak
   memory and NCCL time beside the single-card trainer's and the fused
   FSDP steps (``chiprun_out/mesh_times.json``); then the step stochastic
   with taps off, with ``--use_sample_stats`` and stochastic taps, and with
   packed state (``WHOLE_CELLS``): ranks bitwise equal, launches, step
   time, peak and held memory, and at W >= 2 one step against the (1, 1)
   step in this process with the same key by the flip rule (the sampled
   cell's taps: every tap call bitwise one card's call on its input
   gathered from the ranks, ``tap_trace_check``), and packed state's held
   memory and state bytes below float32 state's; and two experiment
   drivers on the card, ``memory_footprint`` (ResNet-18, Adam, fsdp 4)
   and a tiny ``bert_nan_probe``, each printing its JSON line;
5. kernel times at 8 388 608 elements (CUDA events, L2 flushed between
   runs) beside the memory bound and, for the float formats, PyTorch's
   cast to the same format; the SmaQ call at the main path's sizes,
   truncation beside stochastic rounding, the SmaQ kernel time of one
   ResNet-18 step and of one bert-base step (their calls, at their sizes,
   in one CUDA graph each), and the
   SmaQ kernels' blocks resident per SM; the same for S2FP8, with both of
   its forms at its threshold and at 8192 elements; the Philox fill of
   bert-base's largest dropout mask; the bfloat16 forms beside the
   float32 form between a cast in and a cast out (the path they replace),
   against their 4 bytes an element, with ``xb.sum()`` and ``yb.copy_(xb)``
   in bf16 as yardsticks; the bf16 SmaQ call by size in a stream of 20,
   truncation beside stochastic rounding, the SmaQ calls of a bf16
   ResNet-18 step and of a bf16 bert-base codecs step in one CUDA graph
   each, the float_quantize calls of a bf16 FP8 ResNet-18 step in one
   graph, the bf16 S2FP8 call alone and by size and a bf16 S2FP8
   ResNet-18 step's S2FP8 calls in one graph, the bf16 BN call and a bf16
   ``--use_batch_norm`` step's BN calls in one graph, the float32 calls
   beside them and digests of their outputs, and the new kernels' blocks
   resident per SM; each stochastic quantize kernel at element offset 0
   and 2 (``chiprun_out/offset_times.json``);
6. the kernel table as one JSON line (the bfloat16 forms as rows of their
   own), then the result as the last line.

``--mesh_only`` builds the kernels and runs phase 4b's mesh cells alone
(not the drivers): the check of the mesh on a machine of two to four
cards, which would otherwise pay for phases 3-5 on every card it holds.
``--times_of DIR`` builds the port in DIR and prints, as one JSON line,
phase 5's time of every kernel at 8 388 608 elements (float32 and bf16),
its S2FP8 call (by size, and a ResNet-18 step's calls in one CUDA graph)
and its bf16 forms' calls (``bf16_call_times``: the SmaQ call and
float_quantize at 8 388 608 elements, the SmaQ call by size, a bf16
ResNet-18 step's and a bf16 bert-base codecs step's calls in one CUDA
graph each; the S2FP8 call at 8 388 608 elements and by size, a bf16
S2FP8 ResNet-18 step's calls in one graph; the BN call at BN_SHAPE and a
bf16 ``--use_batch_norm`` step's BN calls in one graph; the float32 calls
at the same sizes and digests of the S2FP8 and BN outputs), all with this
script's timer: run parent, change, change, parent in one chip call to
hold a change against its parent.

Needs the repository beside it (or in DIR) and one CUDA card.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ACT_SHAPE = (128, 64, 32, 32)  # the largest ResNet-18 batch-128 activation
# 68 tap sites in ResNet-18, each tapped forward and backward
RESNET18_TAPS = 68
# 295 in Inception-v3: 90 convs (conv, BatchNorm, ReLU), 11 pooled
# branches, 11 block outputs, the head's pool, fc and output
INCEPTION_TAPS = 295
# flip rule (tests/test_smaq.py:144-152): elements more than 1e-5 apart
# (plus 4 ulp of the value) are bucket flips from the folded reciprocals
FLIP_FRACTION = 1e-4
MAIN_ARGV = [
    "--device", "cuda", "--model", "resnet", "--resnet_model", "resnet18",
    "--dataset", "cifar10", "--compress", "smart", "--measure_compression_ratio",
    "--batch_size", "128", "--log_every", "5",
]
# bert-base at batch 32 x 512: the STSB configuration of
# scripts/train_bert_stsb.sh (SmaQ 6/8, AdamW, lr 2e-5, weight decay 0.01)
BERT_ARGV = [
    "--device", "cuda", "--model", "bert", "--dataset", "glue", "--glue_task", "stsb",
    "--bert_size", "base", "--batch_size", "32", "--max_input_length", "512",
    "--compress", "smart", "--optimizer_type", "adamw", "--learning_rate", "2e-5",
    "--weight_decay", "0.01", "--measure_compression_ratio", "--log_every", "5",
]
# Inception-v3 on CIFAR-10 at ResNet-18's batch, SmaQ 6/8, full coverage
INCEPTION_ARGV = [
    "--device", "cuda", "--model", "inception", "--dataset", "cifar10", "--compress", "smart",
    "--measure_compression_ratio", "--batch_size", "128", "--log_every", "5",
]
# its largest activation (the FFN's intermediate, 32 x 512 x 3072) and the
# word-embedding table (30522 x 768; its gradient, mu and nu alike)
BERT_SIZES = (("bert intermediate 50331648", 32 * 512 * 3072),
              ("bert word embeddings 23440896", 30522 * 768))
BERT_LAYERS = 12
# the stable momentum codecs and the packed state on bert-base
CODEC_ARGV = ["--momentum_rowwise", "--momentum_log_nu"]
# the models' compute in bfloat16: every tap's map goes to a kernel's bf16 form
BF16_ARGV = ["--compute_dtype", "bfloat16"]
# ResNet-18's other encoders under bfloat16: (label, arguments, overall
# ratio range, the loss must be finite), so that every bf16 form launches
# on a training path
BF16_PATHS = [
    ("bf16 fp8", ["--compress", "fp8"], (4.0, 4.0), True),
    ("bf16 fp16", ["--compress", "fp16"], (2.0, 2.0), True),
    ("bf16 bf16", ["--compress", "bf16"], (2.0, 2.0), True),
    ("bf16 s2fp8", ["--compress", "s2fp8", "--no_terminate_on_nan"], (3.9, 4.0), False),
    ("bf16 smart bn", ["--use_batch_norm"], (4.5, 5.5), True),
]
PACKED_ARGV = ["--packed_momentum", "--packed_weights"]
BN_SHAPE = (128, 64, 32, 32)  # the largest BatchNorm output, NCHW
RAGGED_BN_SHAPE = (3, 10, 7, 5)
TPU = "smart_quantization_tpu/ops/pallas"
# the kernels of csrc/*.cu, as their wrappers count them; the bfloat16
# forms count under the same name with "_bf16"
BF16_KERNELS = ("smaq_stats", "smaq_quantize", "smaq_quantize_bn", "float_quantize",
                "s2fp8_stats", "s2fp8_quantize")
KERNEL_NAMES = (*BF16_KERNELS, "philox_fill", *(f"{k}_bf16" for k in BF16_KERNELS),
                "smaq_onepass_bf16")
CSRC = "smart_quantization_tpu_torch/csrc"
# the other CLI paths: (label, arguments after MAIN_ARGV's, overall ratio
# range, the loss must be finite); argparse takes the last --compress
PATHS = [
    ("fp8", ["--compress", "fp8"], (4.0, 4.0), True),
    ("fp16", ["--compress", "fp16"], (2.0, 2.0), True),
    ("bf16", ["--compress", "bf16"], (2.0, 2.0), True),
    # S2FP8 at full coverage turned the TPU's loss NaN
    # (experiments/results/encoder_sweep_resnet18_synthetic.json), so a
    # non-finite loss is accepted here
    ("s2fp8", ["--compress", "s2fp8", "--no_terminate_on_nan"], (3.9, 4.0), False),
    ("smart bn", ["--use_batch_norm"], (4.5, 5.5), True),
    ("smart bn scalar", ["--use_batch_norm", "--bn_scalar_params"], (4.5, 5.5), True),
]


def param_sizes(model: str) -> list[int]:
    """The parameter sizes of ResNet-18 or bert-base, built on the CPU."""
    from smart_quantization_tpu_torch.models.bert import BertConfig, BertForSequenceClassification
    from smart_quantization_tpu_torch.models.resnet import resnet18

    m = resnet18(num_classes=10) if model == "resnet" else BertForSequenceClassification(
        BertConfig(), num_labels=1)
    return [p.numel() for p in m.parameters()]


def check_packed_ratio(label, sizes, param_sizes_, buffers, min_size=8):
    """Packed momentum's sizes ``[orig_bits, new_bits]`` are the real ones:
    8 n + 64 bits a leaf of ``min_size`` elements or more, 32 n a smaller
    one, for each of ``buffers`` buffers."""
    orig = 32 * sum(param_sizes_) * buffers
    new = sum(8 * n + 64 if n >= min_size else 32 * n for n in param_sizes_) * buffers
    say(f"  [{label}] optimizer_momentum real ratio {sizes[0] / sizes[1]!r}; from the shapes "
        f"{orig / new!r}")
    if abs(sizes[1] / sizes[0] - new / orig) > 1e-6:
        fail(f"[{label}] optimizer_momentum ratio {sizes[0] / sizes[1]} is not the real "
             f"sizes' {orig / new}")


def timing_key(device):
    """The step key the timed stochastic launches draw from."""
    from smart_quantization_tpu_torch.ops.keys import key_tensor

    return key_tensor(7, device)


def call_key(device, seed):
    """What a timed call draws from: a step key on the card, as a training
    step passes it, where the port has one; else (an older tree of the
    port) a host generator."""
    import torch

    try:
        from smart_quantization_tpu_torch.ops.keys import DeviceKey, key_tensor
    except ImportError:
        return torch.Generator().manual_seed(seed)
    return DeviceKey(key_tensor(seed, device))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def kernel_modules():
    from smart_quantization_tpu_torch.ops.cuda import (
        float_kernel,
        philox_kernel,
        s2fp8_kernel,
        smaq_kernel,
    )

    return smaq_kernel, float_kernel, s2fp8_kernel, philox_kernel


def reset_counts() -> None:
    for m in kernel_modules():
        m.reset_launch_counts()


def read_counts() -> dict:
    out = {}
    for m in kernel_modules():
        out.update(m.LAUNCHES)
    return out


# ---------------------------------------------------------------- phase 3
def flip_check(name, y, y_ref, bits, bits_ref, quantum):
    """The flip rule: few elements apart, none by more than one main
    quantum, bit counts within 2 per flip."""
    import torch

    diff = (y - y_ref).abs().flatten()
    tol = 1e-5 + 2.5e-7 * y_ref.abs().flatten()
    flipped = int((diff > tol).sum())
    n = diff.numel()
    max_diff = float(diff.max())
    dbits = abs(float(bits) - float(bits_ref))
    ok = (
        flipped <= FLIP_FRACTION * n
        and max_diff <= float(quantum) * (1 + 1e-4) + 1e-6
        and dbits <= 2 * flipped + 1e-3
        and bool(torch.isfinite(y).all())
    )
    say(f"  {name}: n={n} flips={flipped} max|d|={max_diff:.3e} "
        f"quantum={float(quantum):.3e} bits {float(bits):.0f} vs {float(bits_ref):.0f}"
        f" -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"kernel disagrees with its plain version: {name}")
    return max_diff


def check_kernels(device):
    import torch

    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    K.reset_launch_counts()
    gen = torch.Generator(device=device).manual_seed(0)
    host = torch.Generator().manual_seed(1)
    trunc = SmaQParams(stochastic_rounding=False)
    stoch = SmaQParams()
    cases = [
        ("act 128x64x32x32", torch.randn(ACT_SHAPE, generator=gen, device=device) * 1.7 + 0.3),
        ("ragged 300001", torch.randn(300_001, generator=gen, device=device) * 2.5 - 0.7),
        ("bn leaf 64", torch.randn(64, generator=gen, device=device) * 0.1 + 1.0),
        ("fc bias 10", torch.randn(10, generator=gen, device=device) * 0.01),
        ("ill-conditioned 65536", torch.randn(65536, generator=gen, device=device) * 1e-2 + 1e3),
        *((name, torch.randn(n, generator=gen, device=device) * 0.05 - 0.01)
          for name, n in BERT_SIZES),
    ]
    errs = {"smaq_stats": 0.0, "smaq_quantize": 0.0}
    for name, x in cases:
        n = x.numel()
        flat = x.reshape(-1)
        # the stats kernel alone, against its plain version: mean and std,
        # and the constants derived from them (to an ulp)
        consts = K.smaq_stats(flat, trunc)
        mean_k, std_k = K.read_consts(consts)
        mean_p, std_p = K.pivot_stats_reference(flat, trunc)
        d_mean, d_std = float((mean_k - mean_p).abs()), float((std_k - std_p).abs())
        derived = K.consts_reference(mean_k, std_k, trunc)
        d_derived = float(((consts - derived).abs() / derived.abs().clamp_min(1e-30)).max())
        stat_ok = (d_mean <= 1e-6 * (1 + abs(float(mean_p))) and d_std <= 1e-5 * float(std_p) + 1e-12
                   and d_derived <= 2.5e-7)
        say(f"  {name}: stats |d mean|={d_mean:.2e} |d std|={d_std:.2e}, constants "
            f"within {d_derived:.1e} of theirs -> {'ok' if stat_ok else 'MISMATCH'}")
        if not stat_ok:
            fail(f"smaq_stats disagrees with its plain version: {name}")
        errs["smaq_stats"] = max(errs["smaq_stats"], d_mean, d_std)
        quantum = std_p / trunc.range_main

        # truncation: the whole fused call against the plain version
        y, bits = K.smaq_fused_or_reference(x, host, trunc)
        y_ref, bits_ref = K.smaq_fused_reference(x, None, trunc)
        # the ill-conditioned tensor too: z = (x - mean) * a does not cancel
        errs["smaq_quantize"] = max(errs["smaq_quantize"], flip_check(
            f"{name} trunc", y, y_ref, bits, bits_ref, quantum))

        # the other two stats modes: the range estimator folded from the
        # stats kernel's min/max, and the sampled stats given to the kernel
        for mode, p in (("range std", SmaQParams(stochastic_rounding=False, use_range_std_dev=True)),
                        ("sample stats", SmaQParams(stochastic_rounding=False, use_sample_stats=True))):
            ym, bm = K.smaq_fused(x, host, p)
            ymr, bmr = K.smaq_fused_reference(x, None, p)
            if p.use_sample_stats and n > p.num_samples:
                std_m = K.sample_stats(flat, p)[1]
            else:
                std_m = K.pivot_stats_reference(flat, p)[1]
            flip_check(f"{name} {mode}", ym, ymr, bm, bmr, std_m / p.range_main)

        # compute_size=False: the same output, the static floor as the size
        y2, bits2 = K.smaq_fused(x, host, trunc, compute_size=False)
        if not torch.equal(y2, y) or float(bits2) != n * trunc.num_bits_main:
            fail(f"compute_size=False changed the output or the size: {name}")

        # all_positive on a tensor around zero
        xp = x - x.mean()
        y3, b3 = K.smaq_fused(xp, host, trunc, all_positive=True)
        y3r, b3r = K.smaq_fused_reference(xp, None, trunc, all_positive=True)
        flip_check(f"{name} all_positive", y3, y3r, b3, b3r, quantum)
        if float(y3.min()) < 0.0:
            fail(f"all_positive left a negative value: {name}")

        # stochastic: every output on one of the two grid points around its
        # input, and no bias over many elements
        ys, _ = K.smaq_fused(x, host, stoch)
        stochastic_check(name, x, ys, stoch, quantum)

    counts = {k: K.LAUNCHES[k] for k in ("smaq_stats", "smaq_quantize")}
    say(f"  launches during the checks: {counts}")
    if min(counts.values()) == 0:
        fail("a kernel was never launched by the checks")
    return errs


def check_codebook(device):
    """Packed state's codebook on the card (the ``smaq_stats`` kernel's
    stats, tensor ops for the codes), in truncation: its decode against the
    card's fake path (the kernels) and against its own plain version on the
    CPU, by the flip rule, wherever |z| is within the storage range (the
    fake path never clamps); and the dense packer's words round-trip."""
    import torch

    from smart_quantization_tpu_torch.ops import codebook as cb
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.pack import pack_bits, unpack_bits
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    trunc = SmaQParams(stochastic_rounding=False)
    gen = torch.Generator(device=device).manual_seed(11)
    name, n = BERT_SIZES[1]
    cases = [("act 128x64x32x32", torch.randn(ACT_SHAPE, generator=gen, device=device) * 1.7 + 0.3),
             (name, torch.randn(n, generator=gen, device=device) * 0.05 - 0.01),
             ("bias 768", torch.randn(768, generator=gen, device=device) * 0.02)]
    for name, x in cases:
        enc = cb.smaq_encode(x, None, trunc)
        y = cb.smaq_decode(enc, trunc)
        y_fake, _ = K.smaq_fused(x, None, trunc)
        y_cpu = cb.smaq_decode(cb.smaq_encode(x.cpu(), None, trunc), trunc).to(device)
        ok = ((x - enc.mean) / enc.std).abs() <= cb.storage_z_limit(trunc)
        quantum = enc.std / trunc.range_main
        say(f"  {name}: {int((~ok).sum())} of {x.numel()} elements beyond the codebook's "
            f"{cb.storage_z_limit(trunc):.3f} sigma")
        flip_check(f"{name} codebook against the kernels", y[ok], y_fake[ok], 0, 0, quantum)
        flip_check(f"{name} codebook against its CPU version", y[ok], y_cpu[ok], 0, 0, quantum)
    for bits in (1, 6, 13, 32):
        v = torch.randint(0, 2**bits, (1_000_003,), generator=gen, device=device)
        if not torch.equal(unpack_bits(pack_bits(v, bits), bits, v.numel()), v):
            fail(f"pack_bits/unpack_bits do not round-trip at {bits} bits on the card")
    say("  pack_bits/unpack_bits round-trip 1 000 003 values at 1, 6, 13 and 32 bits")


def stochastic_check(name, x, ys, params, quantum):
    """Every output on one of the two grid points around its input (the
    plain version at u = 0 and u = 1), and no bias over many elements.  An
    element off its grid point is a flip: never more than one quantum
    outside the pair; as many flips as the trunc mode allows."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K

    n = x.numel()
    lo, _ = K.smaq_fused_reference(x, None, params, u=torch.zeros_like(x))
    hi, _ = K.smaq_fused_reference(x, None, params, u=torch.ones_like(x))
    ys = ys.view(x.shape)
    tol = 1e-5 + 2.5e-7 * lo.abs()
    off_grid = int((((ys - lo).abs() > tol) & ((ys - hi).abs() > tol)).sum())
    slack = quantum * 1.01 + tol
    far = int(((ys < torch.minimum(lo, hi) - slack) | (ys > torch.maximum(lo, hi) + slack)).sum())
    ok = off_grid <= FLIP_FRACTION * n and far == 0 and bool(torch.isfinite(ys).all())
    line = f"  {name} stochastic: off-grid={off_grid} beyond a quantum={far}"
    if n >= 1_000_000:
        err = (ys - x).double().flatten()
        sigma = float(err.std()) / math.sqrt(n)
        bias = float(err.mean())
        ok = ok and abs(bias) <= 4 * sigma
        line += f" mean err={bias:.3e} (4 sigma={4 * sigma:.3e})"
    say(line + f" -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"stochastic rounding off its grid or biased: {name}")


def check_small_form(device):
    """SmaQ calls at the main path's small sizes (fc bias, BN leaf, a
    1728-element conv weight, a 3x3x64x64 conv weight) and around the small
    form's threshold against the plain version, in truncation, stochastic,
    ``all_positive`` and range-std modes, each in the form ``smaq_plan``
    names; ``smaq_fused`` launches that form, and ``smaq_quantize`` refuses
    the small form above its threshold."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    gen = torch.Generator(device=device).manual_seed(16)
    host = torch.Generator().manual_seed(17)
    trunc, stoch = SmaQParams(stochastic_rounding=False), SmaQParams()
    rng = SmaQParams(stochastic_rounding=False, use_range_std_dev=True)
    sms = K.sm_count(device)
    t = K.SMALL_MAX
    err = 0.0
    for n in (10, 64, 512, 1728, 36864, t - 1, t, t + 1):
        x = torch.randn(n, generator=gen, device=device) * 0.8 + 0.3
        form = K.smaq_plan(n, sms)[0]
        name = f"{form} form {n}"
        quantum = K.pivot_stats_reference(x, trunc)[1] / trunc.range_main
        before = dict(K.LAUNCHES)
        y, bits = K.smaq_fused(x, host, trunc)
        got = {k: K.LAUNCHES[k] - before[k] for k in ("smaq_stats", "smaq_quantize")}
        if got != {"smaq_stats": int(form == "split"), "smaq_quantize": 1}:
            fail(f"smaq_fused at {n} did not take the {form} form: {got}")
        y_ref, bits_ref = K.smaq_fused_reference(x, None, trunc)
        err = max(err, flip_check(f"{name} trunc", y, y_ref, bits, bits_ref, quantum))
        xp = x - x.mean()
        y, bits = K.smaq_fused(xp, host, trunc, all_positive=True)
        y_ref, bits_ref = K.smaq_fused_reference(xp, None, trunc, all_positive=True)
        flip_check(f"{name} all_positive", y, y_ref, bits, bits_ref, quantum)
        if float(y.min()) < 0.0:
            fail(f"all_positive left a negative value: {name}")
        y, bits = K.smaq_fused(x, host, rng)
        y_ref, bits_ref = K.smaq_fused_reference(x, None, rng)
        flip_check(f"{name} range std", y, y_ref, bits, bits_ref,
                   K.pivot_stats_reference(x, rng)[1] / rng.range_main)
        ys, _ = K.smaq_fused(x, host, stoch)
        stochastic_check(name, x, ys, stoch, quantum)
    try:
        K.smaq_quantize(torch.zeros(t + 1, device=device), trunc, key=None)
    except ValueError:
        say(f"  the small form refuses {t + 1} elements -> ok")
    else:
        fail(f"smaq_quantize ran the small form on {t + 1} elements")
    return err


def check_counter_reset(device):
    """1000 back-to-back calls on one stream, alternating the split form,
    the small form and the BN kernel (all three share the stream's
    counters): every size must equal the first call's and the plain
    version's, which it would not if a counter kept its count."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    gen = torch.Generator(device=device).manual_seed(18)
    trunc = SmaQParams(stochastic_rounding=False)
    big = torch.randn(300_001, generator=gen, device=device) * 2.5 - 0.7
    small = torch.randn(1728, generator=gen, device=device)
    xb = torch.randn(RAGGED_BN_SHAPE, generator=gen, device=device)
    g = torch.rand(RAGGED_BN_SHAPE[1], generator=gen, device=device) + 0.5
    b = torch.randn(RAGGED_BN_SHAPE[1], generator=gen, device=device)
    calls = [lambda: K.smaq_fused(big, None, trunc)[1],
             lambda: K.smaq_fused(small, None, trunc)[1],
             lambda: K.smaq_fused_bn(xb, None, g, b, trunc)[1]]
    refs = [K.smaq_fused_reference(big, None, trunc)[1],
            K.smaq_fused_reference(small, None, trunc)[1],
            K.smaq_fused_bn_reference(xb, None, g, b, trunc)[1]]
    sizes = torch.stack([calls[i % 3]() for i in range(1000)]).view(-1)
    ok = True
    for j, (name, n) in enumerate((("split 300001", big.numel()), ("small 1728", small.numel()),
                                   ("bn 3x10x7x5", xb.numel()))):
        s = sizes[j::3]
        same = bool((s == s[0]).all())
        d = abs(float(s[0]) - float(refs[j]))
        ok = ok and same and d <= 2 * FLIP_FRACTION * n + 1e-3  # the flip rule's bit slack
        say(f"  counters after {s.numel()} {name} calls: sizes all {float(s[0]):.0f} ({same}), "
            f"plain {float(refs[j]):.0f}")
    say(f"  1000 back-to-back calls -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("a SmaQ counter did not reset between calls")


def float_cases(device):
    """The float kernels' inputs: the largest activation with the edge
    values at its head and stretches at 1e-6 and at float32-subnormal
    scale, a ragged tensor, the fc bias."""
    import torch

    gen = torch.Generator(device=device).manual_seed(10)
    act = torch.randn(ACT_SHAPE, generator=gen, device=device).reshape(-1) * 1.7
    edges = torch.tensor(
        [0.0, -0.0, 1e38, -1e38, 3.3e38, float("inf"), float("-inf"), float("nan"),
         1e-45, -1e-45, 1.17549435e-38, -5.9e-39, 57344.0, -57344.0, 65504.0,
         65520.0, 2.0**-14, 2.0**-16, 2.0**-17, 2.0**-24, 2.0**-126, 2.0**-133],
        device=device)
    act[: edges.numel()] = edges
    act[4096:8192] *= 1e-6
    act[8192:12288] *= 1e-40
    return [
        ("act 128x64x32x32", act.view(ACT_SHAPE)),
        ("ragged 300001", torch.randn(300_001, generator=gen, device=device) * 2.5 - 0.7),
        ("fc bias 10", torch.randn(10, generator=gen, device=device) * 0.01),
    ]


def check_float_kernels(device):
    """Nearest: bitwise equal to ``ops/float_format.py`` on the card, with
    and without check_inf.  Stochastic: every output is one of the plain
    version's two roundings (all-zero and all-one random words) and the
    mean error of the 8 M-element tensor is within 4 sigma of 0."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.float_format import (
        BF16_FORMAT,
        FP8_FORMAT,
        FP16_FORMAT,
        float_quantize,
    )

    F.reset_launch_counts()
    host = torch.Generator().manual_seed(11)
    formats = (("fp8", FP8_FORMAT), ("fp16", FP16_FORMAT), ("bf16", BF16_FORMAT))
    for name, x in float_cases(device):
        n = x.numel()
        for fname, fmt in formats:
            for ci in (True, False):
                y = F.float_quantize_fused(x, fmt, None, stochastic=False, check_inf=ci)
                y_ref = float_quantize(x, fmt, stochastic=False, check_inf=ci)
                bad = int((y.view(torch.int32) != y_ref.view(torch.int32)).sum())
                say(f"  {name} {fname} nearest check_inf={ci}: {bad} of {n} bit patterns "
                    f"differ -> {'ok' if bad == 0 else 'MISMATCH'}")
                if bad:
                    fail(f"float_quantize nearest is not bitwise equal: {name} {fname}")
            ys = F.float_quantize_fused(x, fmt, host, stochastic=True, check_inf=False)
            lo = float_quantize(x, fmt, stochastic=True, check_inf=False,
                                rand=torch.zeros(x.shape, dtype=torch.int64, device=device))
            hi = float_quantize(x, fmt, stochastic=True, check_inf=False,
                                rand=torch.full(x.shape, 2**32 - 1, dtype=torch.int64, device=device))
            bits = ys.view(torch.int32)
            off = int(((bits != lo.view(torch.int32)) & (bits != hi.view(torch.int32))).sum())
            line = f"  {name} {fname} stochastic: {off} outputs off the two roundings"
            ok = off == 0
            if n >= 1_000_000:
                keep = torch.isfinite(x).reshape(-1)
                keep[:32] = False  # the edge values
                err = (ys.reshape(-1)[keep] - x.reshape(-1)[keep]).double()
                sigma = float(err.std()) / math.sqrt(err.numel())
                bias = float(err.mean())
                ok = ok and abs(bias) <= 4 * sigma
                line += f", mean err={bias:.3e} (4 sigma={4 * sigma:.3e})"
            say(line + f" -> {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"stochastic float rounding off its grid or biased: {name} {fname}")
    say(f"  launches during the checks: {dict(F.LAUNCHES)}")
    if F.LAUNCHES["float_quantize"] == 0:
        fail("float_quantize was never launched by the checks")
    return {"float_quantize": 0.0}


def e5m2_steps(a, b):
    """How many e5m2 steps apart two nonnegative squeezed values are, in
    steps of the coarser of the two binades (2^-16 below 2^-14)."""
    import torch

    big = torch.maximum(a, b).clamp_min(2.0**-14)
    step = torch.exp2(torch.floor(torch.log2(big)) - 2)
    return (a - b).abs() / step


def ulps_apart(a, b):
    """The largest distance in float32 units in the last place between two
    tensors of positive values (NaN beside NaN counts as equal)."""
    import torch

    d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int(torch.where(same, torch.zeros_like(d), d).max())


def check_s2fp8_kernels(device):
    """The stats kernel's constants: mu and max against their plain version
    within 1e-6 relative, alpha, beta and 1/alpha bitwise equal to
    ``squeeze_coefs`` of the kernel's own (mu, max), the unsqueeze table
    within 1 ulp of ``unsqueeze_table_reference``.  The call, in the form
    ``s2fp8_plan`` names (its launches counted): the output (nearest) equal
    to ``s2fp8_fused_reference`` except for at most 1e-3 of the elements,
    each at most one e5m2 step away in the squeezed domain (exp2f/log2f and
    torch's may differ in the last ulp), and bitwise for the signed-zero
    and constant cases; stochastic outputs on one of the plain version's
    two roundings but for as few.  The small form refuses more than
    ``SMALL_MAX`` elements."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda.launch import sm_count
    from smart_quantization_tpu_torch.ops.s2fp8 import squeeze_coefs

    S.reset_launch_counts()
    host = torch.Generator().manual_seed(12)
    gen = torch.Generator(device=device).manual_seed(13)
    sms = sm_count(device)
    t = S.SMALL_MAX
    cases = [
        ("act 128x64x32x32", torch.randn(ACT_SHAPE, generator=gen, device=device) * 1.7),
        ("ragged 300001", torch.randn(300_001, generator=gen, device=device) * 2.5e-3 - 1e-3),
        ("fc bias 10", torch.randn(10, generator=gen, device=device) * 0.01),
        (f"at threshold {t}", torch.randn(t, generator=gen, device=device) * 0.5 + 0.1),
        (f"past threshold {t + 1}", torch.randn(t + 1, generator=gen, device=device) * 0.5 + 0.1),
        ("signed zeros 4096", torch.cat([torch.zeros(2048, device=device),
                                         -torch.zeros(2048, device=device)])),
        ("constant 4096", torch.full((4096,), 2.0, device=device)),
        # log2(0.375) is inexact: only an exact mean keeps alpha finite
        ("constant -0.375 4096", torch.full((4096,), -0.375, device=device)),
        ("constant -0.375 300001", torch.full((300_001,), -0.375, device=device)),
    ]
    cases[0][1].reshape(-1)[:4] = torch.tensor([0.0, -0.0, 1e-30, -3e4], device=device)
    errs = {"s2fp8_stats": 0.0, "s2fp8_quantize": 0.0}
    for name, x in cases:
        flat = x.reshape(-1)
        n = flat.numel()
        c = S.read_consts(S.s2fp8_stats(flat))
        mu_r, m_r = S.stats_reference(flat)
        d_mu, d_m = float((c["mu"] - mu_r).abs()), float((c["m"] - m_r).abs())
        alpha, beta = squeeze_coefs(c["mu"], c["m"])
        coefs_bitwise = all(
            bool((a.view(torch.int32) == b.view(torch.int32)).all())
            for a, b in ((c["alpha"], alpha), (c["beta"], beta), (c["inv_alpha"], 1.0 / alpha)))
        table_ulps = ulps_apart(c["table"], S.unsqueeze_table_reference(c["alpha"], c["beta"]))
        ok = (d_mu <= 1e-6 * max(1.0, abs(float(mu_r))) and d_m <= 1e-6 * max(1.0, abs(float(m_r)))
              and coefs_bitwise and table_ulps <= 1)
        say(f"  {name}: stats |d mu|={d_mu:.2e} |d max|={d_m:.2e}; alpha, beta, 1/alpha bitwise "
            f"{coefs_bitwise}; table within {table_ulps} ulp -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"s2fp8_stats disagrees with its plain version: {name}")
        errs["s2fp8_stats"] = max(errs["s2fp8_stats"], d_mu, d_m)

        alpha, beta = (v.double() for v in squeeze_coefs(mu_r, m_r))

        def squeezed(y):
            a = y.reshape(-1).double().abs()
            return torch.where(a == 0, a, torch.exp2(alpha * torch.log2(a) + beta))

        form = S.s2fp8_plan(n, sms)[0]
        before = dict(S.LAUNCHES)
        y = S.s2fp8_fused(x, None, stochastic=False)
        got = {k: S.LAUNCHES[k] - before[k] for k in ("s2fp8_stats", "s2fp8_quantize")}
        if got != {"s2fp8_stats": int(form == "split"), "s2fp8_quantize": 1}:
            fail(f"s2fp8_fused at {n} did not take the {form} form: {got}")
        y_ref = S.s2fp8_fused_reference(x, stochastic=False)
        diff = y.view(torch.int32) != y_ref.view(torch.int32)
        n_diff = int(diff.sum())
        steps = float(e5m2_steps(squeezed(y)[diff.reshape(-1)],
                                 squeezed(y_ref)[diff.reshape(-1)]).max()) if n_diff else 0.0
        ok = n_diff <= max(1e-3 * n, 1) and steps <= 1.01 and bool(torch.isfinite(y).all())
        if name.startswith(("signed", "constant")):
            ok = ok and n_diff == 0
        say(f"  {name} nearest ({form} form): {n_diff} of {n} differ, at most {steps:.3f} e5m2 "
            f"steps -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"s2fp8_quantize disagrees with its plain version: {name}")
        errs["s2fp8_quantize"] = max(errs["s2fp8_quantize"], float((y - y_ref).abs().max()))

        ys = S.s2fp8_fused(x, host, stochastic=True)
        lo = S.s2fp8_fused_reference(x, stochastic=True,
                                     rand=torch.zeros(x.shape, dtype=torch.int64, device=device))
        hi = S.s2fp8_fused_reference(x, stochastic=True,
                                     rand=torch.full(x.shape, 2**32 - 1, dtype=torch.int64, device=device))
        b = ys.view(torch.int32)
        off = int(((b != lo.view(torch.int32)) & (b != hi.view(torch.int32))).sum())
        ok = off <= max(1e-3 * n, 1) and bool(torch.isfinite(ys).all())
        say(f"  {name} stochastic: {off} outputs off the two roundings -> {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"stochastic S2FP8 off its grid: {name}")
    try:
        S.s2fp8_quantize(torch.zeros(t + 1, device=device), key=None, stochastic=False,
                         check_inf=True)
    except ValueError:
        say(f"  the small form refuses {t + 1} elements -> ok")
    else:
        fail(f"s2fp8_quantize ran the small form on {t + 1} elements")
    say(f"  launches during the checks: {dict(S.LAUNCHES)}")
    if min(S.LAUNCHES["s2fp8_stats"], S.LAUNCHES["s2fp8_quantize"]) == 0:
        fail("an S2FP8 kernel was never launched by the checks")
    return errs


def check_s2fp8_back_to_back(device):
    """1000 back-to-back calls on one stream, alternating S2FP8's split form,
    SmaQ's split form, S2FP8's small form and SmaQ's small form.  The first
    S2FP8 output of each form agrees with the plain version by phase 3's
    rule; every later output and SmaQ size is bitwise the first of its
    kind, which it would not be if a counter kept its count or a call read
    another's constants."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    gen = torch.Generator(device=device).manual_seed(19)
    trunc = SmaQParams(stochastic_rounding=False)
    xs = {"s2fp8 split 300001": torch.randn(300_001, generator=gen, device=device) * 2.5 - 0.7,
          "smaq split 300001": torch.randn(300_001, generator=gen, device=device) * 1.5 + 0.2,
          "s2fp8 small 1728": torch.randn(1728, generator=gen, device=device) * 0.1,
          "smaq small 1728": torch.randn(1728, generator=gen, device=device)}
    calls = {}
    for name, x in xs.items():
        if name.startswith("s2fp8"):
            calls[name] = lambda x=x: (S.s2fp8_fused(x, None, stochastic=False),)
        else:
            calls[name] = lambda x=x: K.smaq_fused(x, None, trunc)
    firsts = {name: fn() for name, fn in calls.items()}
    for name, x in xs.items():
        if name.startswith("s2fp8"):
            y_ref = S.s2fp8_fused_reference(x, stochastic=False)
            n_diff = int((firsts[name][0].view(torch.int32) != y_ref.view(torch.int32)).sum())
            say(f"  {name}: first call {n_diff} of {x.numel()} differ from the plain version")
            if n_diff > 1e-3 * x.numel():
                fail(f"s2fp8_quantize disagrees with its plain version: {name}")
    bad = {name: torch.zeros((), dtype=torch.int64, device=device) for name in calls}
    names = list(calls)
    for i in range(1000 - len(names)):
        name = names[i % len(names)]
        for out, first in zip(calls[name](), firsts[name]):
            bad[name] += (out.view(torch.int32) != first.view(torch.int32)).sum()
    bad = {name: int(v) for name, v in bad.items()}
    say(f"  1000 back-to-back calls, outputs and sizes apart from the first: {bad} -> "
        f"{'ok' if not any(bad.values()) else 'MISMATCH'}")
    if any(bad.values()):
        fail("a call's output changed over back-to-back calls")


def check_bn_kernel(device):
    """The BatchNorm-folded SmaQ against its plain version by the flip rule:
    NCHW with per-channel (gamma, beta), a ragged shape, a scalar pair, a
    zero gamma (ResNet's init of each block's last BN; must stay finite),
    an ill-conditioned map (mean 1e3, std 1e-2); stochastic outputs on one
    of their two grid points."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    gen = torch.Generator(device=device).manual_seed(14)
    host = torch.Generator().manual_seed(15)
    trunc, stoch = SmaQParams(stochastic_rounding=False), SmaQParams()
    before = K.LAUNCHES["smaq_quantize_bn"]
    x = torch.randn(BN_SHAPE, generator=gen, device=device) * 1.3 + 0.2
    xr = torch.randn(RAGGED_BN_SHAPE, generator=gen, device=device) * 0.8 - 0.1

    def affine(c):
        return (torch.randn(c, generator=gen, device=device) * 0.3 + 1.0,
                torch.randn(c, generator=gen, device=device) * 0.2)

    g, b = affine(BN_SHAPE[1])
    g_zero = g.clone()
    g_zero[::3] = 0.0
    cases = [
        ("bn 128x64x32x32", x, g, b),
        ("bn ragged 3x10x7x5", xr, *affine(RAGGED_BN_SHAPE[1])),
        ("bn scalar pair", x, g.mean(), b.mean()),
        ("bn zero gamma", x, g_zero, b),
        ("bn all-zero gamma", x, torch.zeros_like(g), b),
        # |mean| >> std: z = (x - H) * A does not cancel (H = mean at g = 1, b = 0)
        ("bn ill-conditioned 16x64x8x8",
         torch.randn(16, 64, 8, 8, generator=gen, device=device) * 1e-2 + 1e3,
         torch.ones_like(g), torch.zeros_like(b)),
    ]
    err = 0.0
    for name, xx, gg, bb in cases:
        y, bits = K.smaq_fused_bn(xx, host, gg, bb, trunc)
        y_ref, bits_ref = K.smaq_fused_bn_reference(xx, None, gg, bb, trunc)
        _, std = K.pivot_stats_reference(xx.reshape(-1), trunc)
        g_safe = torch.where(gg == 0, torch.ones_like(gg), gg)
        quantum = std * g_safe.abs().max() / trunc.range_main
        err = max(err, flip_check(f"{name} trunc", y, y_ref, bits, bits_ref, quantum))
    ys, _ = K.smaq_fused_bn(x, host, g, b, stoch)
    lo, _ = K.smaq_fused_bn_reference(x, None, g, b, stoch, u=torch.zeros_like(x))
    hi, _ = K.smaq_fused_bn_reference(x, None, g, b, stoch, u=torch.ones_like(x))
    tol = 1e-5 + 2.5e-7 * lo.abs()
    off = int((((ys - lo).abs() > tol) & ((ys - hi).abs() > tol)).sum())
    ok = off <= FLIP_FRACTION * x.numel() and bool(torch.isfinite(ys).all())
    say(f"  bn 128x64x32x32 stochastic: off-grid={off} -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("stochastic BN SmaQ off its grid")
    if K.LAUNCHES["smaq_quantize_bn"] == before:
        fail("smaq_quantize_bn was never launched by the checks")
    return {"smaq_quantize_bn": err}


# the Philox fill at the main path's sizes: a ragged one, bert-base's
# hidden states (32 x 512 x 768: the embeddings', attention output's and
# FFN output's dropout) and attention probabilities (32 x 12 x 512 x 512)
FILL_SIZES = (("ragged 300001", 300_001), ("bert hidden 12582912", 32 * 512 * 768),
              ("bert attention probs 100663296", 32 * 12 * 512 * 512))


def bitwise_equal(a, b) -> bool:
    """The same dtype, shape and bytes (NaN and -0.0 included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return bool(torch.equal(a.contiguous().view(-1).view(torch.uint8),
                            b.contiguous().view(-1).view(torch.uint8)))


def check_philox_fill(device) -> float:
    """The Philox fill against its plain version, bitwise, in both outputs
    at FILL_SIZES; and the float kernel's stochastic rounding against the
    plain version fed the fill's words for the same (key, call): the
    kernels and the fill draw the same bits.  Returns the largest
    difference (0.0: every check is bitwise)."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import philox_kernel as P
    from smart_quantization_tpu_torch.ops.float_format import FP8_FORMAT, float_quantize
    from smart_quantization_tpu_torch.ops.keys import key_tensor, step_key

    for i, (label, n) in enumerate(FILL_SIZES):
        key = key_tensor(step_key(0, i), device)
        for uniform in (False, True):
            got = P.philox_fill(n, key, 5 + i, uniform=uniform)
            want = P.philox_fill_reference(n, key, 5 + i, uniform=uniform)
            torch.cuda.synchronize()
            if not bitwise_equal(got, want):
                fail(f"philox_fill {label} ({'uniform' if uniform else 'words'}) differs from "
                     "its plain version")
            del got, want
        say(f"  philox_fill {label}: words and uniforms bitwise equal to the plain version")
    x = torch.randn(300_001, generator=torch.Generator(device=device).manual_seed(20),
                    device=device) * 3.0
    key = key_tensor(step_key(1, 2), device)
    y = F.float_quantize_launch(x, FP8_FORMAT, key=key, call=9, stochastic=True, check_inf=True)
    words = P.philox_fill(x.numel(), key, 9, uniform=False).to(torch.int64) & 0xFFFFFFFF
    ref = float_quantize(x, FP8_FORMAT, None, stochastic=True, check_inf=True, rand=words)
    if not bitwise_equal(y, ref):
        fail("float_quantize's stochastic bits are not the fill's words for the same key")
    say("  float_quantize (fp8, stochastic) bitwise equal to its plain version fed the "
        "fill's words: the kernels and the fill draw the same bits")
    return 0.0


# the golden model's checks: sizes (a ragged one and ResNet-18's largest
# activation) and the scale and shift of their values
GOLDEN_SIZES = (1000, 65_536, 1_048_573, 128 * 64 * 32 * 32)


def f32_ulp(v: float) -> float:
    """The float32 unit in the last place at ``v`` (normal range)."""
    return 2.0 ** (math.floor(math.log2(abs(v))) - 23) if v else 2.0 ** -149


def golden_emulation(a) -> tuple[float, float]:
    """The golden model's mode 0 in numpy: float32 sums of x and x * x in
    order (``add.accumulate``), the biased std ``sqrt(E[x^2] - E[x]^2)`` in
    float32 (``native/smaq_golden/smaq_golden.cpp:72-80``)."""
    import numpy as np

    n = np.float32(a.size)
    m1 = np.float32(np.add.accumulate(a, dtype=np.float32)[-1] / n)
    m2 = np.float32(np.add.accumulate(a * a, dtype=np.float32)[-1] / n)
    return float(m1), float(np.sqrt(np.float32(m2 - m1 * m1)))


def check_golden(device) -> None:
    """The stats kernel and the C++ SmaQ golden model (``smaq_golden.py``,
    ``native/build/libsmaq_golden.so``), a third check that depends on no
    framework, each held against float64 statistics of the same float32
    values: ``smaq_stats``' mean and ddof=1 std (``read_consts``; its sums
    are float64) within 2 float32 ulps, its range std within 4 (float32
    log, sqrt and division); the golden model's mode 0 bitwise its float32
    sequential sums emulated in numpy, and within twice that emulation's
    measured error of the float64 values plus 2 ulps; its mode 1 (the range
    std) within 4 ulps; and the binding refuses a CUDA tensor."""
    import torch

    from smart_quantization_tpu_torch import smaq_golden
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    kernel_ulps, golden_err = 0.0, 0.0
    for n in GOLDEN_SIZES:
        gen = torch.Generator(device=device).manual_seed(n)
        x = torch.randn(n, generator=gen, device=device) * 3 + 1.5
        host = x.cpu()
        xd = host.double()
        mean64 = float(xd.mean())
        var64 = float(((xd - mean64) ** 2).sum())
        std1, std0 = math.sqrt(var64 / (n - 1)), math.sqrt(var64 / n)
        range64 = (float(xd.max()) - float(xd.min())) / math.sqrt(2.0 * math.log(n))

        mean, std = (float(v) for v in K.read_consts(K.smaq_stats(x, SmaQParams())))
        _, r_std = (float(v) for v in K.read_consts(
            K.smaq_stats(x, SmaQParams(use_range_std_dev=True))))
        ulps = (abs(mean - mean64) / f32_ulp(mean64), abs(std - std1) / f32_ulp(std1),
                abs(r_std - range64) / f32_ulp(range64))
        kernel_ulps = max(kernel_ulps, *ulps)
        if ulps[0] > 2 or ulps[1] > 2 or ulps[2] > 4:
            fail(f"[golden] smaq_stats on {n} elements: mean {mean!r}, std {std!r}, range std "
                 f"{r_std!r}; float64 {mean64!r}, {std1!r}, {range64!r} ({ulps} ulps)")

        g_mean, g_std = smaq_golden.stats(host, 0)
        g1_mean, g1_std = smaq_golden.stats(host, 1)
        e_mean, e_std = golden_emulation(host.numpy())
        if (g_mean, g_std, g1_mean) != (e_mean, e_std, e_mean):
            fail(f"[golden] on {n} elements the golden model's mode 0 ({g_mean!r}, {g_std!r}) "
                 f"or mode 1 mean {g1_mean!r} is not its float32 sequential sums "
                 f"({e_mean!r}, {e_std!r})")
        tol_mean = 2 * abs(e_mean - mean64) + 2 * f32_ulp(mean64)
        tol_std = 2 * abs(e_std - std0) + 2 * f32_ulp(std0)
        if (abs(g_mean - mean64) > tol_mean or abs(g_std - std0) > tol_std
                or abs(g1_std - range64) > 4 * f32_ulp(range64)):
            fail(f"[golden] on {n} elements the golden model's mean {g_mean!r}, std {g_std!r}, "
                 f"range std {g1_std!r} against float64 {mean64!r}, {std0!r}, {range64!r} "
                 f"(tolerances {tol_mean!r}, {tol_std!r}, 4 ulps)")
        golden_err = max(golden_err, abs(g_std - std0) / std0)
    try:
        smaq_golden.stats(torch.zeros(8, device=device))
    except ValueError as e:
        refused = str(e)
    else:
        fail("[golden] the binding took a CUDA tensor")
    say(f"  smaq_stats and the C++ golden model (modes 0 and 1) at {GOLDEN_SIZES}, each "
        f"against float64: the kernel within {kernel_ulps:.2f} float32 ulps; the golden "
        f"model bitwise its float32 sequential sums, its std at most {golden_err:.2e} "
        f"relative off (that summation's own error); a CUDA tensor refused "
        f"({refused[:60]}...)")


# the whole-batch step's kernel entries (parallel/whole_batch.py): phase
# 3's largest and ragged shapes, float32 and bfloat16, split over 4 ranks
WHOLE_STATS_CASES = (("act 128x64x32x32", ACT_SHAPE, 1.7, 0.3),
                     ("ragged 300001", (300_001,), 2.5, -0.7))
WHOLE_STATS_RANKS = 4


def f32_ulps_apart(a, b) -> int:
    """Float32 units in the last place between two same-signed 0-d
    tensors."""
    import torch

    a, b = a.float().reshape(1), b.float().reshape(1)
    return abs(int(a.view(torch.int32)) - int(b.view(torch.int32)))


def check_smaq_sums(label, flat, params, mode) -> tuple[float, float]:
    """``smaq_stats``' ``sums`` against ``pivot_sums_reference``: min and
    max bitwise, the pivot within the float32 error bound of its 256-term
    sum, sum(d) and sum(d * d) moved to the reference's pivot within 1e-10
    of sum|d| and of sum(d * d) (float64 sums of the same float32 d), or,
    where the pivots differ, within the bound of d's float32 rounding
    (2^-23 sum|d|, 2^-22 sum(d * d)); ``fold_sums`` of them within 2 ulps of
    the constants the kernel writes; and ``fold_sums`` of WHOLE_STATS_RANKS
    equal parts' sums (the whole-batch step's gather) against the plain
    statistics of the whole within that rounding's bound (each part rounds
    d about its own pivot): 2^-23 max|d| on the mean, 2^-22 of the mean
    square of d over the std on the std, plus 2 ulps.  Returns that
    folded (mean, std)."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K

    n = flat.numel()
    sums = torch.empty(K.SUM_WORDS, dtype=torch.float64, device=flat.device)
    mean_k, std_k = K.read_consts(K.smaq_stats(flat, params, sums=sums))
    s1, s2, mn, mx, pv = sums.tolist()
    r1, r2, rmn, rmx, rpv = K.pivot_sums_reference(flat).tolist()
    xf = flat.float()
    pivot_tol = 2 * 2.0 ** -24 * float(xf[:256].abs().sum())
    delta = pv - rpv
    m1, m2 = s1 + n * delta, s2 + 2 * delta * s1 + n * delta * delta
    abs_d = float((xf.double() - rpv).abs().sum())
    one = K.fold_sums(sums[None], n, params)
    ulps_one = max(f32_ulps_apart(one[0], mean_k), f32_ulps_apart(one[1], std_k))
    m = n - n % WHOLE_STATS_RANKS
    parts = torch.stack([torch.empty(K.SUM_WORDS, dtype=torch.float64, device=flat.device)
                         for _ in range(WHOLE_STATS_RANKS)])
    for r, part in enumerate(flat[:m].view(WHOLE_STATS_RANKS, -1)):
        K.smaq_stats(part, params, sums=parts[r])
    mean4, std4 = K.fold_sums(parts, m // WHOLE_STATS_RANKS, params)
    mean_p, std_p = K.pivot_stats_reference(xf[:m], params)
    rel1, rel2 = (1e-10, 1e-10) if delta == 0 else (2.0 ** -23, 2.0 ** -22)
    dd = xf[:m].double() - float(mean_p)
    mean_tol = (2.0 ** -23 * float((xf[:m].double() - rpv).abs().max())
                + 2 * f32_ulp(float(mean_p)))
    std_tol = (2.0 ** -22 * float((dd * dd).mean()) / max(float(std_p), 1e-30)
               + 2 * f32_ulp(float(std_p)))
    d_mean, d_std = abs(float(mean4) - float(mean_p)), abs(float(std4) - float(std_p))
    ok = (mn == rmn and mx == rmx and abs(delta) <= pivot_tol
          and abs(m1 - r1) <= rel1 * abs_d and abs(m2 - r2) <= rel2 * r2
          and ulps_one <= 2 and d_mean <= mean_tol and d_std <= std_tol)
    say(f"  {label} {mode}: smaq_stats' sums against pivot_sums_reference: min/max bitwise "
        f"{mn == rmn and mx == rmx}, pivot {abs(delta):.2e} apart, sum(d) "
        f"{abs(m1 - r1) / abs_d:.2e} of sum|d|, sum(d*d) {abs(m2 - r2) / r2:.2e} relative; "
        f"folded: {ulps_one} ulp from the kernel's constants, {WHOLE_STATS_RANKS} parts "
        f"{f32_ulps_apart(mean4, mean_p)} and {f32_ulps_apart(std4, std_p)} ulp from the "
        f"whole's (bounds {mean_tol:.2e}, {std_tol:.2e}) -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"smaq_stats' sums disagree with their plain version: {label} {mode}")
    return mean4, std4


def check_s2fp8_sums(label, flat) -> tuple:
    """``s2fp8_stats``' ``sums`` (the table kernel where ``split_forms``
    takes it) against the plain sum and max of ``log2|x|`` as the kernel
    takes it (``torch.log2``; the bfloat16 table form's
    ``log2_table_reference``): the sum within the sum of the elements'
    float32 ulps (log2f and torch's may differ by one) plus 1e-12 of
    sum|log2|, the max within one ulp; ``given_consts`` of the kernel's own
    (mu, max) bitwise the constants it writes, the unsqueeze table within 1
    ulp; ``fold_log2`` of WHOLE_STATS_RANKS parts' sums within 1 ulp (mu)
    and bitwise (max) of the whole's.  Returns the folded (mu, max)."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.parallel.whole_batch import fold_log2

    n = flat.numel()
    table = S.split_forms(n, flat.dtype)[0]
    sums = torch.empty(2, dtype=torch.float64, device=flat.device)
    c = S.read_consts(S.s2fp8_stats(flat, sums=sums))
    if table:
        lg = S.log2_table_reference(flat.device)[flat.view(torch.int16).long() & 0x7FFF]
    else:
        a = flat.float().abs()
        lg = torch.where(a == 0, torch.zeros_like(a), torch.log2(a))
    mag = lg.double().abs()
    ulps = torch.where(mag == 0, torch.zeros_like(mag),
                       torch.exp2(torch.floor(torch.log2(mag)) - 23))
    ref_sum, ref_max = float(lg.double().sum()), float(lg.max())
    k_sum, k_max = sums.tolist()
    sum_ok = abs(k_sum - ref_sum) <= float(ulps.sum()) + 1e-12 * float(mag.sum())
    max_ok = abs(k_max - ref_max) <= f32_ulp(ref_max)
    given = S.read_consts(S.given_consts(*fold_log2(sums[None], n)))
    head = ("mu", "m", "alpha", "beta", "inv_alpha")
    head_ok = all(f32_ulps_apart(given[k], c[k]) == 0 for k in head)
    table_ulps = ulps_apart(given["table"], c["table"])
    parts = torch.zeros(WHOLE_STATS_RANKS, 2, dtype=torch.float64, device=flat.device)
    for r, part in enumerate(flat.tensor_split(WHOLE_STATS_RANKS)):
        S.s2fp8_stats(part, sums=parts[r])
    mu4, m4 = fold_log2(parts, n)
    fold_ok = f32_ulps_apart(mu4, c["mu"]) <= 1 and f32_ulps_apart(m4, c["m"]) == 0
    ok = sum_ok and max_ok and head_ok and table_ulps <= 1 and fold_ok
    say(f"  {label}: s2fp8_stats{'_table' if table else ''}' sums: sum of log2|x| "
        f"{abs(k_sum - ref_sum):.2e} apart (bound {float(ulps.sum()):.2e}), max "
        f"{abs(k_max - ref_max):.2e}; given_consts: mu, m, alpha, beta, 1/alpha bitwise "
        f"{head_ok}, table within {table_ulps} ulp; {WHOLE_STATS_RANKS} parts folded: mu "
        f"{f32_ulps_apart(mu4, c['mu'])} ulp, max bitwise {f32_ulps_apart(m4, c['m']) == 0} "
        f"-> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"s2fp8_stats' sums or given_consts disagree with their plain version: {label}")
    return mu4, m4


def check_whole_tensor_stats(device) -> dict:
    """The kernel entries of the whole-batch step (``parallel/whole_batch.py``)
    against their plain versions, at WHOLE_STATS_CASES in float32 and
    bfloat16: the stats kernels' ``sums`` and their folds over
    WHOLE_STATS_RANKS parts (``check_smaq_sums``, ``check_s2fp8_sums``),
    then each quantize kernel on the folded statistics given, with no stats
    launch: ``smaq_fused`` (full and range std) and ``smaq_fused_bn`` (NCHW,
    per-channel gamma and beta) against their references with the same
    ``mean``/``std`` by the flip rule, ``s2fp8_fused(stats=)`` (nearest;
    its bfloat16 window form on the large shape) against
    ``s2fp8_quantize_dequantize(stats=)`` within one e5m2 step, at most 1e-3
    of the elements on another code, no sign flipped."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.s2fp8 import s2fp8_quantize_dequantize
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    gen = torch.Generator(device=device).manual_seed(23)
    modes = (("full std", SmaQParams(stochastic_rounding=False)),
             ("range std", SmaQParams(stochastic_rounding=False, use_range_std_dev=True)))
    errs = {"smaq_quantize": 0.0, "s2fp8_quantize": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, scale, shift in WHOLE_STATS_CASES:
            x = (torch.randn(shape, generator=gen, device=device) * scale + shift).to(dtype)
            label = f"whole-batch {name} {str(dtype).removeprefix('torch.')}"
            flat = x.reshape(-1)
            n = flat.numel()
            for mode, p in modes:
                mean, std = check_smaq_sums(label, flat, p, mode)
                stats_before = K.LAUNCHES["smaq_stats"] + K.LAUNCHES["smaq_stats_bf16"]
                # the float32 form on the (widened) input against the plain
                # version; a bfloat16 input's form bitwise it rounded
                xw = x.float()
                y, bits = K.smaq_fused(xw, None, p, mean=mean, std=std)
                y_ref, bits_ref = K.smaq_fused_reference(xw, None, p, mean=mean, std=std)
                errs["smaq_quantize"] = max(errs["smaq_quantize"], flip_check(
                    f"{label} {mode} smaq_fused(mean=, std=)", y, y_ref, bits, bits_ref,
                    std / p.range_main))
                if dtype == torch.bfloat16:
                    yb, bb = K.smaq_fused(x, None, p, mean=mean, std=std)
                    same_bits(f"{label} {mode} smaq_fused(mean=, std=)", yb, y)
                    if float(bb) != float(bits):
                        fail(f"bf16 {label} {mode}: size {float(bb)} against {float(bits)}")
                if len(shape) == 4:
                    g = torch.randn(shape[1], generator=gen, device=device) * 0.3 + 1.0
                    b = torch.randn(shape[1], generator=gen, device=device) * 0.2
                    yn, bn = K.smaq_fused_bn(xw, None, g, b, p, mean=mean, std=std)
                    ynr, bnr = K.smaq_fused_bn_reference(xw, None, g, b, p, mean=mean, std=std)
                    flip_check(f"{label} {mode} smaq_fused_bn(mean=, std=)", yn, ynr, bn, bnr,
                               std * g.abs().max() / p.range_main)
                    if dtype == torch.bfloat16:
                        ynb, bnb = K.smaq_fused_bn(x, None, g, b, p, mean=mean, std=std)
                        same_bits(f"{label} {mode} smaq_fused_bn(mean=, std=)", ynb, yn)
                        if float(bnb) != float(bn):
                            fail(f"bf16 {label} {mode} bn: size {float(bnb)} against {float(bn)}")
                if K.LAUNCHES["smaq_stats"] + K.LAUNCHES["smaq_stats_bf16"] != stats_before:
                    fail(f"{label}: SmaQ with the statistics given launched smaq_stats")
                say(f"  {label} {mode}: the bfloat16 forms on the statistics given bitwise the "
                    f"float32 forms rounded" if dtype == torch.bfloat16 else
                    f"  {label} {mode}: no smaq_stats launch with the statistics given")

            stats = check_s2fp8_sums(label, flat)
            before = {k: v for k, v in S.LAUNCHES.items() if "stats" in k}
            y = S.s2fp8_fused(x, None, stochastic=False, stats=stats)
            if {k: v for k, v in S.LAUNCHES.items() if "stats" in k} != before:
                fail(f"{label}: s2fp8_fused with the statistics given launched a stats kernel")
            y_ref = s2fp8_quantize_dequantize(x, None, stochastic=False, stats=stats)
            s2fp8_rule(f"{label} s2fp8_fused(stats=) (nearest, {n} elements)", y, y_ref, stats,
                       "s2fp8_quantize_dequantize(stats=)")
            errs["s2fp8_quantize"] = max(errs["s2fp8_quantize"],
                                         float((y.float() - y_ref.float()).abs().max()))
    return errs


def s2fp8_rule(label, y, y_ref, stats, ref_name) -> None:
    """S2FP8's rule against its plain version: at most one e5m2 step of the
    squeeze (``stats``' alpha and beta) apart, at most 1e-3 of the elements
    on another code, no sign flipped, every output finite."""
    import torch

    from smart_quantization_tpu_torch.ops.s2fp8 import squeeze_coefs

    alpha, beta = (v.double() for v in squeeze_coefs(*stats))

    def squeezed(t):
        a = t.reshape(-1).double().abs()
        return torch.where(a == 0, a, torch.exp2(alpha * torch.log2(a) + beta))

    steps = e5m2_steps(squeezed(y), squeezed(y_ref))
    other = float((steps > 0.5).float().mean())
    flipped = int(((y.float() * y_ref.float()) < 0).sum())
    ok = (float(steps.max()) <= 1.01 and other <= 1e-3 and flipped == 0
          and bool(torch.isfinite(y).all()))
    say(f"  {label}: at most {float(steps.max()):.3f} e5m2 steps from {ref_name}, "
        f"{other:.2e} of the elements on another code, {flipped} signs flipped -> "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"S2FP8 disagrees with its plain version: {label}")


# The element offset of a stochastic launch (csrc/philox.cuh: Draws): a
# ragged tensor cut into 4 parts, offsets 0, 75 001, 150 001 and 225 001
# (none but the first a multiple of 4), a BatchNorm map cut by rows (1050
# elements a part: offsets 2 past a multiple of 4), and one launch far
# beyond 32 bits of offset
OFFSET_PARTS = (75_001, 75_000, 75_000, 75_000)
OFFSET_BN_SHAPE = (12, 10, 7, 5)
FAR_OFFSET = 2**33 + 6


def check_offsets(device) -> dict:
    """Every stochastic kernel at an element offset: each quantize form on 4
    parts of a tensor, each part at its offset (a clone, so the vector
    paths run across two of the whole's Philox groups), against the whole
    tensor's launch under the same given statistics and (key, call):
    bitwise for float_quantize and S2FP8 (float32, bf16, the window form),
    by the flip rule for SmaQ and BN (float32, bf16; bitwise printed);
    each part's launch against its plain version fed the fill's words at
    that offset (``philox_fill_reference(offset=)``): float bitwise, S2FP8
    by ``s2fp8_rule``, SmaQ and BN by the flip rule; the one-launch form
    at an offset bitwise the two-launch form on its constants at the same
    offset; the fill at each offset bitwise its plain version and the
    whole fill's slice; every form once at FAR_OFFSET against its plain
    version.  Returns the largest difference from a plain version by
    kernel."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import philox_kernel as P
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.float_format import FP8_FORMAT, float_quantize
    from smart_quantization_tpu_torch.ops.keys import key_tensor, step_key
    from smart_quantization_tpu_torch.ops.s2fp8 import s2fp8_quantize_dequantize
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    key, call = key_tensor(step_key(3, 1), device), 5
    gen = torch.Generator(device=device).manual_seed(31)
    params = SmaQParams()
    errs: dict[str, float] = {}
    bf = torch.bfloat16

    def words(n, o):
        return P.philox_fill_reference(n, key, call, uniform=False, offset=o).to(
            torch.int64) & 0xFFFFFFFF

    def uniforms(n, o):
        return P.philox_fill_reference(n, key, call, uniform=True, offset=o)

    def rounded(y, like):
        return y.to(like.dtype)

    flat = torch.randn(sum(OFFSET_PARTS), generator=gen, device=device) * 1.7 + 0.3
    nchw = torch.randn(OFFSET_BN_SHAPE, generator=gen, device=device) * 0.8 - 0.1
    g = torch.randn(OFFSET_BN_SHAPE[1], generator=gen, device=device) * 0.3 + 1.0
    b = torch.randn(OFFSET_BN_SHAPE[1], generator=gen, device=device) * 0.2
    channels, inner = OFFSET_BN_SHAPE[1], math.prod(OFFSET_BN_SHAPE[2:])
    for dtype in (torch.float32, bf):
        tag = "" if dtype == torch.float32 else "_bf16"
        x, xn = flat.to(dtype), nchw.to(dtype)
        stats = torch.stack([x.float().mean(), x.float().std()])
        stats_n = torch.stack([xn.float().mean(), xn.float().std()])
        a = x.float().abs()
        lg = torch.where(a == 0, a, torch.log2(a))
        mu_m = ((lg.double().sum() / lg.numel()).float(), lg.max())
        consts = S.given_consts(*mu_m)
        quantum, quantum_n = stats[1] / params.range_main, stats_n[1] * g.abs().max() / params.range_main
        window = dtype == bf
        # name: (whole tensor, parts, launch(part, o), plain(part, o), rule)
        forms = {
            "smaq_quantize": (x, x.split(OFFSET_PARTS), lambda t, o: K.smaq_quantize(
                t, params, key=key, call=call, offset=o, stats=stats), lambda t, o: (
                rounded(K.smaq_fused_reference(t.float(), None, params, mean=stats[0],
                                               std=stats[1], u=uniforms(t.numel(), o))[0], t),
                None), "flip"),
            "smaq_quantize_bn": (xn.reshape(-1), [r.reshape(-1) for r in xn.split(3)],
                                 lambda t, o: K.smaq_quantize_bn(
                t, g, b, channels, inner, params, key=key, call=call, offset=o, stats=stats_n),
                lambda t, o: (rounded(K.smaq_fused_bn_reference(
                    t.float().view(-1, *OFFSET_BN_SHAPE[1:]), None, g, b, params,
                    mean=stats_n[0], std=stats_n[1], u=uniforms(t.numel(), o))[0].reshape(-1),
                    t), None), "flip"),
            "float_quantize": (x, x.split(OFFSET_PARTS), lambda t, o: (F.float_quantize_launch(
                t, FP8_FORMAT, key=key, call=call, offset=o, stochastic=True, check_inf=True),
                None), lambda t, o: (rounded(float_quantize(
                    t.float(), FP8_FORMAT, None, stochastic=True, check_inf=True,
                    rand=words(t.numel(), o)), t), None), "bits"),
            "s2fp8_quantize" + ("_window" if window else ""): (
                x, x.split(OFFSET_PARTS), lambda t, o: (S.s2fp8_quantize(
                    t, consts, key=key, call=call, offset=o, stochastic=True, check_inf=True,
                    window=window), None), lambda t, o: (s2fp8_quantize_dequantize(
                        t, None, stochastic=True, stats=mu_m, rand=words(t.numel(), o)), None),
                "s2fp8"),
        }
        if window:
            # a bf16 S2FP8 form: bitwise its float32 form at the same offset
            # on the widened input, rounded; that launch by S2FP8's rule
            # against the plain version (two bf16 roundings of outputs one
            # e5m2 step apart can land further apart than one step)
            def s2fp8_plain(t, o):
                y32 = S.s2fp8_quantize(t.float(), consts, key=key, call=call, offset=o,
                                       stochastic=True, check_inf=True, window=False)
                s2fp8_rule(f"offset s2fp8_quantize at {o} (the float32 form of a bf16 part)",
                           y32, s2fp8_quantize_dequantize(t.float(), None, stochastic=True,
                                                          stats=mu_m, rand=words(t.numel(), o)),
                           mu_m, "its plain version")
                return y32.to(bf), None

            forms["s2fp8_quantize_window"] = (*forms["s2fp8_quantize_window"][:3], s2fp8_plain,
                                              "bits")
        if window:  # the bf16 instance of the float32 split-form kernel too
            forms["s2fp8_quantize"] = (*forms["s2fp8_quantize_window"][:2], lambda t, o: (
                S.s2fp8_quantize(t, consts, key=key, call=call, offset=o, stochastic=True,
                                 check_inf=True, window=False), None),
                *forms["s2fp8_quantize_window"][3:])
        for name, (whole_x, parts, launch, plain, rule) in forms.items():
            label = f"offset {name}{tag}"
            whole, whole_size = launch(whole_x, 0)
            outs, sizes, at, worst = [], 0.0, 0, 0.0
            for part in [*parts, None]:
                o = FAR_OFFSET if part is None else at
                t = (parts[0] if part is None else part).clone()
                y, size = launch(t, o)
                y_ref, _ = plain(t, o)
                if rule == "bits":
                    if not bitwise_equal(y, y_ref):
                        fail(f"{label} at {o}: not bitwise its plain version")
                elif rule == "s2fp8":
                    s2fp8_rule(f"{label} at {o}", y, y_ref, mu_m, "its plain version")
                    worst = max(worst, float((y.float() - y_ref.float()).abs().max()))
                else:
                    worst = max(worst, flip_check(
                        f"{label} at {o} against its plain version", y.float(),
                        y_ref.float(), 0.0, 0.0, quantum_n if "bn" in name else quantum))
                if part is not None:
                    outs.append(y)
                    sizes += 0.0 if size is None else float(size)
                    at += t.numel()
            errs[name + tag] = max(errs.get(name + tag, 0.0), worst)
            got = torch.cat(outs)
            same = bitwise_equal(got, whole)
            if rule == "flip":
                flip_check(f"{label}: 4 parts at their offsets against the whole launch",
                           got.float(), whole.float(), sizes, float(whole_size),
                           quantum_n if "bn" in name else quantum)
            elif not same:
                fail(f"{label}: the parts at their offsets are not bitwise the whole launch")
            say(f"  {label}: 4 parts at offsets {[0, *itertools.accumulate(p.numel() for p in parts)][:4]}"
                f" bitwise the whole launch {same}; each part and offset {FAR_OFFSET} against "
                f"the plain version fed the fill's words there -> ok")

    # the one-launch form: at an offset, bitwise the two-launch form on its
    # constants at that offset
    xb = flat.to(bf)
    for o in (0, 6, FAR_OFFSET):
        y1, size1, c1 = K.smaq_onepass(xb, params, key=key, call=call, offset=o)
        y2, size2 = K.smaq_quantize(xb, params, key=key, call=call, offset=o, consts=c1)
        if not bitwise_equal(y1, y2) or float(size1) != float(size2):
            fail(f"smaq_onepass at offset {o}: not bitwise the two-launch form")
        y_ref = K.smaq_fused_reference(xb.float(), None, params, mean=c1[0], std=c1[1],
                                       u=uniforms(xb.numel(), o))[0].to(bf)
        errs["smaq_onepass_bf16"] = max(errs.get("smaq_onepass_bf16", 0.0), flip_check(
            f"offset smaq_onepass_bf16 at {o} against its plain version", y1.float(),
            y_ref.float(), 0.0, 0.0, c1[1] / params.range_main))
    say(f"  offset smaq_onepass_bf16 at 0, 6 and {FAR_OFFSET}: bitwise the two-launch form "
        "on its constants at the same offset -> ok")
    whole_fill = P.philox_fill(sum(OFFSET_PARTS), key, call, uniform=False)
    at = 0
    for n in (*OFFSET_PARTS, None):
        o = FAR_OFFSET if n is None else at
        n = n or 4099
        got = P.philox_fill(n, key, call, uniform=False, offset=o)
        if not bitwise_equal(got, P.philox_fill_reference(n, key, call, uniform=False, offset=o)):
            fail(f"philox_fill at offset {o}: not bitwise its plain version")
        if o != FAR_OFFSET and not bitwise_equal(got, whole_fill[o:o + n]):
            fail(f"philox_fill at offset {o}: not the whole fill's words")
        at += n
    say(f"  offset philox_fill: each part's words bitwise the whole fill's and its plain "
        f"version's, and at {FAR_OFFSET} -> ok")
    return errs


# the bfloat16 forms (--compute_dtype bfloat16): phase 3's shapes in bf16
BF16_CASES = (("act 128x64x32x32", ACT_SHAPE, 1.7, 0.3),
              ("ragged 300001", (300_001,), 2.5, -0.7),
              ("bn leaf 64", (64,), 0.1, 1.0),
              ("fc bias 10", (10,), 0.01, 0.0),
              *((name, (n,), 0.05, -0.01) for name, n in BERT_SIZES))


def bf16_of(shape, scale, shift, gen, device):
    """A bfloat16 tensor of ``shape`` (normal * scale + shift, rounded)."""
    import torch

    return (torch.randn(shape, generator=gen, device=device) * scale + shift).to(torch.bfloat16)


def same_bits(label, got, want) -> None:
    """``got`` must be bfloat16 and bitwise ``want`` (the float32 form's
    result on the widened input, rounded to nearest-even)."""
    import torch

    want = want.to(torch.bfloat16) if want.dtype != torch.bfloat16 else want
    if got.dtype != torch.bfloat16 or not bitwise_equal(got, want):
        bad = int((got.view(torch.int16) != want.view(torch.int16)).sum()) \
            if got.dtype == torch.bfloat16 and got.shape == want.shape else -1
        fail(f"bf16 {label}: not bitwise the float32 form on the widened input, rounded "
             f"({got.dtype}, {bad} of {want.numel()} apart)")


def fresh_key(device, seed=21):
    """A step key of its own, so two forms draw the same (key, call)."""
    from smart_quantization_tpu_torch.ops.keys import DeviceKey, key_tensor

    return DeviceKey(key_tensor(seed, device))


def check_bf16_kernels(device) -> dict:
    """Every kernel's bfloat16 form against (a) its float32 form on the
    widened input with the output rounded to nearest-even, bitwise (the
    outputs and the sizes, in truncation and, with the same key, in
    stochastic rounding) and (b) its plain version on the bf16 input by
    phase 3's rules: the flip rule for SmaQ, bitwise for the float formats,
    one e5m2 step for S2FP8.  Phase 3's shapes in bf16 (a ragged tensor,
    each small form's threshold, a BN NCHW tensor with a zero gamma,
    bert-base's largest activation and its word-embedding table), then 1000
    back-to-back bf16 calls.  Returns the largest difference from the plain
    versions."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.float_format import (
        BF16_FORMAT,
        FP8_FORMAT,
        FP16_FORMAT,
        float_quantize,
    )
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    gen = torch.Generator(device=device).manual_seed(22)
    trunc, stoch = SmaQParams(stochastic_rounding=False), SmaQParams()
    before = read_counts()
    errs = dict.fromkeys((f"{k}_bf16" for k in BF16_KERNELS), 0.0)
    cases = [(name, bf16_of(shape, scale, shift, gen, device))
             for name, shape, scale, shift in BF16_CASES]
    cases += [(f"smaq threshold {n}", bf16_of((n,), 0.8, 0.3, gen, device))
              for n in (K.SMALL_MAX - 1, K.SMALL_MAX, K.SMALL_MAX + 1)]
    cases += [(f"s2fp8 threshold {n}", bf16_of((n,), 0.5, 0.1, gen, device))
              for n in (S.SMALL_MAX, S.SMALL_MAX + 1)]
    for name, xb in cases:
        xw = xb.float()
        n = xb.numel()
        # SmaQ: truncation, all_positive and stochastic (the same key)
        for mode, p, kw in (("trunc", trunc, {}), ("all_positive", trunc, {"all_positive": True}),
                            ("stochastic", stoch, {})):
            xin, xwin = (xb - xb.mean(), None) if kw else (xb, xw)
            if kw:
                xwin = xin.float()
            yb, sb = K.smaq_fused(xin, fresh_key(device) if p.stochastic_rounding else None,
                                  p, **kw)
            yw, sw = K.smaq_fused(xwin, fresh_key(device) if p.stochastic_rounding else None,
                                  p, **kw)
            same_bits(f"smaq {name} {mode}", yb, yw)
            if not bitwise_equal(sb, sw):
                fail(f"bf16 smaq {name} {mode}: size {float(sb)} against {float(sw)}")
            if mode != "stochastic":
                y_ref, s_ref = K.smaq_fused_reference(xin, None, p, **kw)
                quantum = K.pivot_stats_reference(xwin.reshape(-1), p)[1] / p.range_main
                errs["smaq_quantize_bf16"] = max(errs["smaq_quantize_bf16"], flip_check(
                    f"bf16 {name} smaq {mode} against its plain version", yb.float(),
                    y_ref.float(), sb, s_ref, quantum))
        # the float formats: nearest with and without check_inf, stochastic
        for fname, fmt in (("fp8", FP8_FORMAT), ("fp16", FP16_FORMAT), ("bf16", BF16_FORMAT)):
            for ci in (True, False):
                yb = F.float_quantize_fused(xb, fmt, None, stochastic=False, check_inf=ci)
                same_bits(f"{fname} {name} nearest", yb,
                          F.float_quantize_fused(xw, fmt, None, stochastic=False, check_inf=ci))
                y_ref = float_quantize(xb, fmt, stochastic=False, check_inf=ci).to(torch.bfloat16)
                if not bitwise_equal(yb, y_ref):
                    fail(f"bf16 {fname} {name}: not bitwise its plain version")
            same_bits(f"{fname} {name} stochastic",
                      F.float_quantize_fused(xb, fmt, fresh_key(device), stochastic=True),
                      F.float_quantize_fused(xw, fmt, fresh_key(device), stochastic=True))
        # S2FP8: nearest and stochastic against the float32 form; nearest
        # against the plain version within one e5m2 step
        yb = S.s2fp8_fused(xb, None, stochastic=False)
        same_bits(f"s2fp8 {name} nearest", yb, S.s2fp8_fused(xw, None, stochastic=False))
        same_bits(f"s2fp8 {name} stochastic", S.s2fp8_fused(xb, fresh_key(device)),
                  S.s2fp8_fused(xw, fresh_key(device)))
        y_ref = S.s2fp8_fused_reference(xb, stochastic=False)
        mu_r, m_r = S.stats_reference(xw.reshape(-1))
        alpha, beta = (v.double() for v in squeeze_coefs_of(mu_r, m_r))

        def squeezed(y):
            a = y.reshape(-1).double().abs()
            return torch.where(a == 0, a, torch.exp2(alpha * torch.log2(a) + beta))

        diff = (yb.view(torch.int16) != y_ref.view(torch.int16)).reshape(-1)
        n_diff = int(diff.sum())
        steps = (float(e5m2_steps(squeezed(yb)[diff], squeezed(y_ref)[diff]).max())
                 if n_diff else 0.0)
        if n_diff > max(1e-3 * n, 1) or steps > 1.01:
            fail(f"bf16 s2fp8 {name}: {n_diff} of {n} apart from the plain version, "
                 f"{steps:.3f} e5m2 steps")
        table, window = S.split_forms(n, torch.bfloat16)
        qk = "s2fp8_quantize_window_bf16" if window else "s2fp8_quantize_bf16"
        errs[qk] = max(errs.get(qk, 0.0), float((yb.float() - y_ref.float()).abs().max()))
        mu_k, m_k = (S.read_consts(S.s2fp8_stats(xb.reshape(-1)))[k] for k in ("mu", "m"))
        sk = "s2fp8_stats_table_bf16" if table else "s2fp8_stats_bf16"
        errs[sk] = max(errs.get(sk, 0.0), float((mu_k - mu_r).abs()), float((m_k - m_r).abs()))
        mean_k, std_k = K.read_consts(K.smaq_stats(xb.reshape(-1), trunc))
        mean_p, std_p = K.pivot_stats_reference(xw.reshape(-1), trunc)
        errs["smaq_stats_bf16"] = max(errs["smaq_stats_bf16"], float((mean_k - mean_p).abs()),
                                      float((std_k - std_p).abs()))
        say(f"  bf16 {name}: smaq (trunc, all_positive, stochastic), fp8/fp16/bf16 (nearest "
            f"x2, stochastic), s2fp8 (nearest, stochastic) bitwise the float32 forms rounded; "
            f"s2fp8 {n_diff} apart from its plain version ({steps:.3f} e5m2 steps) -> ok")
        del xw
    # BatchNorm-folded SmaQ on NCHW bf16: per-channel, a zero gamma, a scalar pair
    xb = bf16_of(BN_SHAPE, 1.3, 0.2, gen, device)
    xw = xb.float()
    g = torch.randn(BN_SHAPE[1], generator=gen, device=device) * 0.3 + 1.0
    b = torch.randn(BN_SHAPE[1], generator=gen, device=device) * 0.2
    g_zero = g.clone()
    g_zero[::3] = 0.0
    for label, gg, bb in (("per channel", g, b), ("zero gamma", g_zero, b),
                          ("scalar pair", g.mean(), b.mean())):
        for p in (trunc, stoch):
            yb, sb = K.smaq_fused_bn(xb, fresh_key(device) if p.stochastic_rounding else None,
                                     gg, bb, p)
            yw, sw = K.smaq_fused_bn(xw, fresh_key(device) if p.stochastic_rounding else None,
                                     gg, bb, p)
            same_bits(f"bn {label}", yb, yw)
            if not bitwise_equal(sb, sw) or not bool(torch.isfinite(yb).all()):
                fail(f"bf16 bn {label}: size {float(sb)} against {float(sw)}, or not finite")
        y_ref, s_ref = K.smaq_fused_bn_reference(xb, None, gg, bb, trunc)
        yb, sb = K.smaq_fused_bn(xb, None, gg, bb, trunc)
        std = K.pivot_stats_reference(xw.reshape(-1), trunc)[1]
        g_safe = torch.where(gg == 0, torch.ones_like(gg), gg)
        errs["smaq_quantize_bn_bf16"] = max(errs["smaq_quantize_bn_bf16"], flip_check(
            f"bf16 bn {label} against its plain version", yb.float(), y_ref.float(), sb, s_ref,
            std * g_safe.abs().max() / trunc.range_main))
    # 1000 back-to-back bf16 calls on one stream, every form in turn
    gen_small = bf16_of((1728,), 1.0, 0.0, gen, device)
    big = bf16_of((300_001,), 2.5, -0.7, gen, device)
    calls = [lambda: K.smaq_fused(big, None, trunc),
             lambda: K.smaq_fused(gen_small, None, trunc),
             lambda: K.smaq_fused_bn(xb, None, g, b, trunc),
             lambda: (S.s2fp8_fused(big, None, stochastic=False),),
             lambda: (S.s2fp8_fused(gen_small, None, stochastic=False),),
             lambda: (F.float_quantize_fused(big, FP8_FORMAT, None, stochastic=False),)]
    firsts = [fn() for fn in calls]
    bad = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(1000 - len(calls)):
        for out, first in zip(calls[i % len(calls)](), firsts[i % len(calls)]):
            bad += (out.reshape(-1).view(torch.int16 if out.dtype == torch.bfloat16
                                         else torch.int32)
                    != first.reshape(-1).view(torch.int16 if first.dtype == torch.bfloat16
                                              else torch.int32)).sum()
    say(f"  1000 back-to-back bf16 calls (smaq split/small/bn, s2fp8 split/small, fp8): "
        f"{int(bad)} elements or sizes apart from the first of their kind -> "
        f"{'ok' if int(bad) == 0 else 'MISMATCH'}")
    if int(bad):
        fail("a bf16 call's output changed over back-to-back calls")
    got = {k: v - before[k] for k, v in read_counts().items()}
    say(f"  launches during the bf16 checks: {got}")
    if any(got[f"{k}_bf16"] == 0 for k in BF16_KERNELS):
        fail("a bf16 kernel form was never launched by the checks")
    return errs


def check_bf16_redesign(device) -> dict:
    """The bfloat16 forms redesigned in PR 9, bitwise against the float32
    form on the widened input with the output rounded to nearest-even, and
    against each other: ``smaq_onepass`` (one cooperative launch, x held in
    shared memory) and the two-launch bfloat16 path (``smaq_stats`` +
    ``smaq_quantize``) in outputs, sizes and
    the 8 constants, in truncation, stochastic, ``all_positive`` and
    ``compute_size=False`` modes, at ACT_SHAPE, bert-base's 12 582 912,
    the one-launch capacity -1 / +0 / +1, SMALL_MAX + 1, a ragged size and
    a misaligned pointer, each call in the form ``smaq_plan`` names; a
    launch with one slot more than the card holds is refused; both in a
    captured CUDA graph replayed twice; 1000 back-to-back calls with every
    workspace counter back to 0 after them; and ``float_quantize``'s bf16
    loop (16-byte loads) in every format, both roundings and with and
    without check_inf at ragged sizes and at pointers 2 and 8 bytes off 16,
    and in a graph.  Returns the largest difference of the one-launch form
    from its plain version."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import build
    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.cuda.launch import DTYPES, THREADS, stream
    from smart_quantization_tpu_torch.ops.float_format import (
        BF16_FORMAT,
        FP8_FORMAT,
        FP16_FORMAT,
    )
    from smart_quantization_tpu_torch.ops.keys import key_tensor
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    bf = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(23)
    trunc, stoch = SmaQParams(stochastic_rounding=False), SmaQParams()
    key = key_tensor(29, device)
    sms = K.sm_count(device)
    slots = K.onepass_slots(device)
    cap = K.onepass_capacity(sms, slots)
    say(f"  smaq_onepass: {slots} slots of {K.SLOT_BYTES} B a thread at {K.BLOCKS_PER_SM} "
        f"blocks of {THREADS} a SM on {sms} SMs: {cap} elements at most")
    if cap < math.prod(ACT_SHAPE):
        fail(f"the one-launch form holds {cap} elements, fewer than ResNet-18's largest map")
    big = (torch.randn(cap + 64, generator=gen, device=device) * 0.05 - 0.01).to(bf)
    sizes = [("act 128x64x32x32", math.prod(ACT_SHAPE), 0),
             ("bert hidden 12582912", 32 * 512 * 768, 0),
             ("capacity - 1", cap - 1, 0), ("capacity", cap, 0), ("capacity + 1", cap + 1, 0),
             ("SMALL_MAX + 1", K.SMALL_MAX + 1, 0), ("ragged 300001", 300_001, 0),
             ("misaligned 8388607", math.prod(ACT_SHAPE) - 1, 1)]
    modes = (("trunc", trunc, {}), ("stochastic", stoch, {}),
             ("all_positive", trunc, {"all_positive": True}),
             ("compute_size=False", stoch, {"compute_size": False}))
    err = 0.0
    for name, n, off in sizes:
        xb = big[off:off + n]
        form = K.smaq_plan(n, sms, slots)[0]
        for mode, p, kw in modes:
            xin = xb - xb.mean() if kw.get("all_positive") else xb
            xw = xin.float()
            cw = K.smaq_stats(xw, p)
            yw, sw = K.smaq_quantize(xw, p, key=key, call=4, consts=cw, **kw)
            cb = K.smaq_stats(xin, p)
            yb, sb = K.smaq_quantize(xin, p, key=key, call=4, consts=cb, **kw)
            same_bits(f"smaq two launches {name} {mode}", yb, yw)
            if not (bitwise_equal(sb, sw) and bitwise_equal(cb, cw)):
                fail(f"bf16 smaq two launches {name} {mode}: size or constants apart")
            if form == "onepass":
                yo, so, co = K.smaq_onepass(xin, p, key=key, call=4, **kw)
                same_bits(f"smaq_onepass {name} {mode}", yo, yw)
                if not (bitwise_equal(so, sw) and bitwise_equal(co, cw)):
                    fail(f"smaq_onepass {name} {mode}: size {float(so)} against {float(sw)}, or "
                         "constants apart")
            before = dict(K.LAUNCHES)
            yf, sf = K.smaq_fused(xin, fresh_key(device) if p.stochastic_rounding else None, p, **kw)
            got = {k: K.LAUNCHES[k] - before[k] for k in
                   ("smaq_onepass_bf16", "smaq_stats_bf16", "smaq_quantize_bf16")}
            want = {"smaq_onepass_bf16": int(form == "onepass"),
                    "smaq_stats_bf16": int(form == "split"),
                    "smaq_quantize_bf16": int(form != "onepass")}
            if got != want:
                fail(f"smaq_fused on {name} did not take the {form} form: {got}")
            if mode == "trunc":
                y_ref, s_ref = K.smaq_fused_reference(xin, None, p)
                quantum = K.pivot_stats_reference(xw, p)[1] / p.range_main
                d = flip_check(f"bf16 {name} ({form} form) against its plain version",
                               yf.float(), y_ref.float(), sf, s_ref, quantum)
                if form == "onepass":
                    err = max(err, d)
        say(f"  bf16 {name} ({form} form): one launch, two launches and the float32 form "
            f"rounded bitwise in outputs, sizes and constants ({', '.join(m for m, _, _ in modes)})"
            " -> ok")
    # one slot more than the card holds: the cooperative launch is refused
    n = K.onepass_capacity(sms, slots + 1)
    xb = torch.empty(n, dtype=bf, device=device)
    y, size, consts = torch.empty_like(xb), torch.empty((), device=device), torch.empty(8, device=device)
    rc = build.library().smaq_onepass(
        xb.data_ptr(), y.data_ptr(), n, DTYPES[bf], 0, None, 0, 0, 0, 0, 1,
        *K._quant_args(trunc), K.workspace(xb).data_ptr(), consts.data_ptr(), size.data_ptr(),
        sms * K.BLOCKS_PER_SM, THREADS, stream(xb))
    say(f"  smaq_onepass with {slots + 1} slots a thread: cudaError {rc} (720: too large for "
        f"a cooperative launch) -> {'ok' if rc == 720 else 'MISMATCH'}")
    if rc != 720:
        fail(f"a one-launch call beyond the card's shared memory returned {rc}, not 720")
    del xb, y
    # in a CUDA graph, captured on a side stream as train/graph.py does
    x8 = big[:math.prod(ACT_SHAPE)]
    eager = [K.smaq_onepass(x8, stoch, key=key, call=6),
             (F.float_quantize_launch(x8, FP8_FORMAT, key=key, call=6, stochastic=True,
                                      check_inf=True),)]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        K.smaq_onepass(x8, stoch, key=key, call=6)  # the side stream's workspace
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = [K.smaq_onepass(x8, stoch, key=key, call=6),
                    (F.float_quantize_launch(x8, FP8_FORMAT, key=key, call=6, stochastic=True,
                                             check_inf=True),)]
    for replay in range(2):
        for outs in captured:
            for o in outs:
                o.zero_()
        graph.replay()
        torch.cuda.synchronize(device)
        for want, got in zip(eager, captured):
            if not all(bitwise_equal(a, b) for a, b in zip(want, got)):
                fail(f"replay {replay} of a captured smaq_onepass / float_quantize bf16 differs "
                     "from the eager call")
    say("  smaq_onepass and float_quantize bf16 captured in a CUDA graph: two replays bitwise "
        "the eager calls -> ok")
    del graph
    # 1000 back-to-back calls: the grid barrier's words and the tickets reset
    ragged = big[:300_001]
    small = big[:K.SMALL_MAX]
    calls = [lambda: K.smaq_fused(x8, None, trunc), lambda: K.smaq_fused(ragged, None, trunc),
             lambda: K.smaq_fused(small, None, trunc),
             lambda: K.smaq_fused(big[:cap + 1], None, trunc)]
    firsts = [fn() for fn in calls]
    bad = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(1000 - len(calls)):
        y, s = calls[i % len(calls)]()
        y0, s0 = firsts[i % len(calls)]
        bad += (y.view(torch.int16) != y0.view(torch.int16)).sum() + (s != s0).int()
    words = K.workspace(x8)[:K._COUNTER_WORDS].tolist()
    say(f"  1000 back-to-back bf16 calls (one launch at 8388608 and 300001, the small form, "
        f"two launches at capacity + 1): {int(bad)} elements or sizes apart from the first of "
        f"their kind; counters after them {words} -> "
        f"{'ok' if int(bad) == 0 and not any(words) else 'MISMATCH'}")
    if int(bad) or any(words):
        fail("a bf16 SmaQ call changed over back-to-back calls, or a counter kept its count")
    # float_quantize's bf16 loop: ragged sizes, pointers 2 and 8 bytes off 16
    for n in (10, 64, 300_001, math.prod(ACT_SHAPE) + 7):
        for off in (0, 1, 4):
            xb = big[off:off + n]
            xw = xb.float()
            for fname, fmt in (("fp8", FP8_FORMAT), ("fp16", FP16_FORMAT), ("bf16", BF16_FORMAT)):
                for st in (False, True):
                    for ci in (True, False):
                        same_bits(f"float_quantize {fname} n={n} offset {2 * off} B stochastic={st} "
                                  f"check_inf={ci}",
                                  F.float_quantize_launch(xb, fmt, key=key, call=8, stochastic=st,
                                                          check_inf=ci),
                                  F.float_quantize_launch(xw, fmt, key=key, call=8, stochastic=st,
                                                          check_inf=ci))
    say("  float_quantize bf16 (16-byte loads) at 10, 64, 300001 and 8388615 elements, 0, 2 "
        "and 8 bytes off 16: fp8/fp16/bf16, nearest and stochastic, check_inf on and off, "
        "bitwise the float32 form rounded -> ok")
    return {"smaq_onepass_bf16": err}


def host_key(seed):
    """A host generator: each call with it draws the same step key."""
    import torch

    return torch.Generator().manual_seed(seed)


def check_bf16_s2fp8_bn(device) -> dict:
    """The bfloat16 forms of S2FP8's split path and of the BN kernel (their
    own kernels: the stats' log2 table, the quantize's per-block table of
    the element function, the BN loop with 16-byte loads and a running
    channel; csrc/s2fp8.cu, csrc/smaq.cu), bitwise against the float32 form
    on the widened input with the output rounded to nearest-even:

    - the log2 table: each of the 32 768 bf16 magnitudes among the least
      subnormals, in a tensor of BF16_TABLE_MIN elements, gives
      ``s2fp8_stats`` a max bitwise the float32 kernel's (log2f's);
    - S2FP8 at 8 388 608, 12 582 912, SMALL_MAX -1 / +1, 16 385 and 300 001
      elements, BF16_WINDOW_MIN and BF16_TABLE_MIN -1 / +0 (where the
      tables take over), a pointer 2 bytes off, and a tensor of zeros,
      tiny, huge and subnormal values (elements off the table's window,
      the stats' table rows of subnormals): the constants (mu, max, alpha,
      beta, 1/alpha, the unsqueeze table) and the outputs, nearest and
      stochastic, check_inf on and off; the constants of tensors with an
      inf, and with -inf and a NaN (the stats' path by log2f);
    - BN on BN_SHAPE, RAGGED_BN_SHAPE, inner 9 and inner 4 maps, a scalar
      pair, a zero gamma, one channel and a pointer 2 bytes off: outputs and
      sizes in truncation, stochastic, ``all_positive`` and
      ``compute_size=False`` modes;
    - two tensors of other stats in turn, each call against its own
      tensor's float32 form (a second kernel must read its own call's
      constants, not the last call's);
    - both calls captured in a CUDA graph and replayed twice;
    - 1000 back-to-back calls of the S2FP8 split and small forms and of the
      BN call, every workspace counter back to 0 after them.

    Returns the largest difference of each form from its plain version
    (S2FP8 by e5m2 steps as phase 3 holds it, BN by the flip rule)."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.keys import key_tensor
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    bf = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(31)
    trunc, stoch = SmaQParams(stochastic_rounding=False), SmaQParams()
    errs = {"s2fp8_quantize_bf16": 0.0, "s2fp8_quantize_window_bf16": 0.0,
            "s2fp8_stats_table_bf16": 0.0, "smaq_quantize_bn_bf16": 0.0}
    s2fp8_counters = ("s2fp8_stats_bf16", "s2fp8_quantize_bf16", "s2fp8_stats_table_bf16",
                      "s2fp8_quantize_window_bf16")

    # the log2 table against log2f: each magnitude in a tensor of the least
    # subnormal (log2 -133, below every other but zero's 0), of a size that
    # takes the table, so that the stats' max is that magnitude's log2
    mags = torch.arange(1 << 15, dtype=torch.int32, device=device).to(torch.int16).view(bf)
    xb = torch.ones(S.BF16_TABLE_MIN, dtype=torch.int16, device=device).view(bf)
    xw = xb.float()
    got = torch.empty(1 << 15, device=device)
    want = torch.empty_like(got)
    for i in range(1 << 15):
        xb[0] = mags[i]
        xw[0] = mags[i].float()
        got[i] = S.s2fp8_stats(xb, table=True)[1]
        want[i] = S.s2fp8_stats(xw)[1]
    if not bitwise_equal(got, want):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        fail(f"the bf16 stats' log2 disagrees with log2f on {bad} of 32768 magnitudes")
    finite = torch.isfinite(S.log2_table_reference(device))
    ulps = ulps_apart(got[finite], S.log2_table_reference(device)[finite])
    say(f"  bf16 s2fp8_stats' log2 table: all 32768 magnitudes bitwise log2f (the float32 "
        f"kernel's); within {ulps} ulp of log2_table_reference -> ok")
    if ulps > 1:
        fail(f"log2_table_reference is {ulps} ulp from the kernels' log2")

    # S2FP8: constants and outputs
    big = torch.randn(12_582_912 + 8, generator=gen, device=device)
    wide = torch.randn(1_000_000, generator=gen, device=device)
    wide[::7] = 0.0
    wide[1::11] *= 1e-20
    wide[2::13] *= 1e15
    wide[3::17] = 1e-39  # a bf16 subnormal
    cases = [("8388608", big[:8_388_608] * 1.7 + 0.3), ("12582912", big[:12_582_912] * 0.05),
             (f"SMALL_MAX - 1 {S.SMALL_MAX - 1}", big[:S.SMALL_MAX - 1]),
             (f"SMALL_MAX + 1 {S.SMALL_MAX + 1}", big[:S.SMALL_MAX + 1] * 3.0),
             ("16385", big[:16_385]), ("300001", big[:300_001] * 2.5 - 0.7),
             *((f"{label} {n}", big[:n] * 0.7) for label, n in (
                 ("BF16_WINDOW_MIN - 1", S.BF16_WINDOW_MIN - 1),
                 ("BF16_WINDOW_MIN", S.BF16_WINDOW_MIN),
                 ("BF16_TABLE_MIN - 1", S.BF16_TABLE_MIN - 1),
                 ("BF16_TABLE_MIN", S.BF16_TABLE_MIN))),
             ("wide range 1000000", wide)]
    sms = S.sm_count(device)
    for name, x in cases:
        xb = x.to(bf)
        xw = xb.float()
        for label, xin in (("", xb), (", 2 bytes off", torch.cat([xb[:1], xb])[1:])):
            form = S.s2fp8_plan(xin.numel(), sms)[0]
            table, window = S.split_forms(xin.numel(), bf) if form == "split" else (False, False)
            want_launched = dict.fromkeys(s2fp8_counters, 0)
            want_launched["s2fp8_quantize_window_bf16" if window else "s2fp8_quantize_bf16"] = 1
            if form == "split":
                want_launched["s2fp8_stats_table_bf16" if table else "s2fp8_stats_bf16"] = 1
                cb, cw = S.read_consts(S.s2fp8_stats(xin)), S.read_consts(S.s2fp8_stats(xw))
                if not all(bitwise_equal(cb[k], cw[k]) for k in cb):
                    fail(f"bf16 s2fp8_stats {name}{label}: constants apart from the float32 form's")
            for st in (False, True):
                for ci in (True, False):
                    before = dict(S.LAUNCHES)
                    yb = S.s2fp8_fused(xin, fresh_key(device) if st else None, stochastic=st,
                                       check_inf=ci)
                    launched = {k: S.LAUNCHES[k] - before[k] for k in s2fp8_counters}
                    if launched != want_launched:
                        fail(f"bf16 s2fp8 {name}{label} did not take the {form} form "
                             f"{want_launched}: {launched}")
                    same_bits(f"s2fp8 {name}{label} stochastic={st} check_inf={ci}", yb,
                              S.s2fp8_fused(xw, fresh_key(device) if st else None,
                                            stochastic=st, check_inf=ci))
        if name != "wide range 1000000":
            y_ref = S.s2fp8_fused_reference(xb, stochastic=False)
            yb = S.s2fp8_fused(xb, None, stochastic=False)
            mu_r, m_r = S.stats_reference(xw)
            alpha, beta = (v.double() for v in squeeze_coefs_of(mu_r, m_r))

            def squeezed(y):
                a = y.reshape(-1).double().abs()
                return torch.where(a == 0, a, torch.exp2(alpha * torch.log2(a) + beta))

            diff = (yb.view(torch.int16) != y_ref.view(torch.int16)).reshape(-1)
            n_diff = int(diff.sum())
            steps = (float(e5m2_steps(squeezed(yb)[diff], squeezed(y_ref)[diff]).max())
                     if n_diff else 0.0)
            if n_diff > max(1e-3 * xb.numel(), 1) or steps > 1.01:
                fail(f"bf16 s2fp8 {name}: {n_diff} apart from the plain version, {steps:.3f} "
                     "e5m2 steps")
            qk = ("s2fp8_quantize_window_bf16" if S.split_forms(xb.numel(), bf)[1]
                  else "s2fp8_quantize_bf16")
            errs[qk] = max(errs[qk], float((yb.float() - y_ref.float()).abs().max()))
            if S.split_forms(xb.numel(), bf)[0]:
                c = S.read_consts(S.s2fp8_stats(xb))
                errs["s2fp8_stats_table_bf16"] = max(
                    errs["s2fp8_stats_table_bf16"], float((c["mu"] - mu_r).abs()),
                    float((c["m"] - m_r).abs()))
        say(f"  bf16 s2fp8 {name} ({S.s2fp8_plan(xb.numel(), sms)[0]} form): constants and "
            "outputs (nearest, stochastic; check_inf on and off; aligned and 2 bytes off) "
            "bitwise the float32 form rounded -> ok")

    # inf and NaN: the stats' table gives them 128 or more, and a thread
    # that meets one sums again by log2f (the outputs are NaN, whose bf16
    # bits the two roundings need not share: the constants only)
    for label, vals in (("inf", (float("inf"),)), ("inf and NaN", (float("-inf"), float("nan")))):
        xi = big[:S.BF16_TABLE_MIN].clone()
        xi[12_345:12_345 + len(vals)] = torch.tensor(vals, device=device)
        cb = S.read_consts(S.s2fp8_stats(xi.to(bf)))
        cw = S.read_consts(S.s2fp8_stats(xi.to(bf).float()))
        if not all(bitwise_equal(cb[k], cw[k]) for k in cb):
            fail(f"bf16 s2fp8_stats with {label}: constants apart from the float32 form's")
    say("  bf16 s2fp8_stats with an inf, and with -inf and a NaN: constants bitwise the float32 "
        "form's -> ok")

    # BN: outputs and sizes
    def affine(c):
        return (torch.randn(c, generator=gen, device=device) * 0.3 + 1.0,
                torch.randn(c, generator=gen, device=device) * 0.2)

    g, b = affine(BN_SHAPE[1])
    g_zero = g.clone()
    g_zero[::3] = 0.0
    x = big[:math.prod(BN_SHAPE)].view(BN_SHAPE) * 1.3 + 0.2
    bn_cases = [("128x64x32x32", x, g, b), ("zero gamma", x, g_zero, b),
                ("scalar pair", x, g.mean(), b.mean()),
                ("ragged 3x10x7x5", big[:math.prod(RAGGED_BN_SHAPE)].view(RAGGED_BN_SHAPE),
                 *affine(RAGGED_BN_SHAPE[1])),
                ("inner 9 (128x64x3x3)", big[:128 * 64 * 9].view(128, 64, 3, 3), g, b),
                ("inner 4 (128x64x2x2)", big[:128 * 64 * 4].view(128, 64, 2, 2), g, b),
                ("one channel", x.reshape(128, 1, -1), g[:1], b[:1])]
    modes = (("trunc", trunc, {}), ("stochastic", stoch, {}),
             ("all_positive", trunc, {"all_positive": True}),
             ("compute_size=False", stoch, {"compute_size": False}))
    for name, xx, gg, bb in bn_cases:
        xb = xx.to(bf)
        flat = xb.reshape(-1)
        for label, xin in (("", xb), (", 2 bytes off", torch.cat([flat[:1], flat])[1:].view(xb.shape))):
            for mode, p, kw in modes:
                xi = xin - 0.2 if kw.get("all_positive") else xin
                yb, sb = K.smaq_fused_bn(xi, fresh_key(device) if p.stochastic_rounding else None,
                                         gg, bb, p, **kw)
                yw, sw = K.smaq_fused_bn(xi.float(), fresh_key(device) if p.stochastic_rounding
                                         else None, gg, bb, p, **kw)
                same_bits(f"bn {name}{label} {mode}", yb, yw)
                if not bitwise_equal(sb, sw):
                    fail(f"bf16 bn {name}{label} {mode}: size {float(sb)} against {float(sw)}")
        y_ref, s_ref = K.smaq_fused_bn_reference(xb, None, gg, bb, trunc)
        yb, sb = K.smaq_fused_bn(xb, None, gg, bb, trunc)
        std = K.pivot_stats_reference(xb.float().reshape(-1), trunc)[1]
        g_safe = torch.where(gg == 0, torch.ones_like(gg), gg)
        errs["smaq_quantize_bn_bf16"] = max(errs["smaq_quantize_bn_bf16"], flip_check(
            f"bf16 bn {name} against its plain version", yb.float(), y_ref.float(), sb, s_ref,
            std * g_safe.abs().max() / trunc.range_main))
        say(f"  bf16 bn {name}: outputs and sizes ({', '.join(m for m, _, _ in modes)}; aligned "
            "and 2 bytes off) bitwise the float32 form rounded -> ok")

    # tensors of other stats in turn: a second kernel that read the
    # constants before its stats kernel wrote them would read the last call's
    xa, xc = (big[:math.prod(BN_SHAPE)].view(BN_SHAPE) * s + t
              for s, t in ((1.0, 0.0), (300.0, 40.0)))
    want = {}
    for name, xx in (("a", xa), ("c", xc)):
        xr = xx.to(bf).float()
        want[name] = (S.s2fp8_fused(xr, None, stochastic=False), S.s2fp8_fused(xr, host_key(5)),
                      *K.smaq_fused_bn(xr, None, g, b, trunc))
    for turn in range(3):
        for name, xx in (("a", xa), ("c", xc)):
            xq = xx.to(bf)
            got = (S.s2fp8_fused(xq, None, stochastic=False), S.s2fp8_fused(xq, host_key(5)),
                   *K.smaq_fused_bn(xq, None, g, b, trunc))
            for label, gv, wv in zip(("s2fp8 nearest", "s2fp8 stochastic", "bn", "bn size"),
                                     got, want[name]):
                if label == "bn size":
                    if not bitwise_equal(gv, wv):
                        fail(f"bf16 {label} of tensor {name}, turn {turn}: {float(gv)} against "
                             f"{float(wv)}")
                else:
                    same_bits(f"{label} of tensor {name}, turn {turn}", gv, wv)
    say("  bf16 S2FP8 and BN on two tensors of other stats in turn (3 turns): each call bitwise "
        "the float32 form of its own tensor -> ok")

    # in a CUDA graph, captured on a side stream as train/graph.py does
    xb8, gb, bbn = x.to(bf), g, b
    key = key_tensor(33, device)

    def both():
        return [S.s2fp8_quantize(xb8.reshape(-1), S.s2fp8_stats(xb8.reshape(-1)), key=key,
                                 call=3, stochastic=True, check_inf=True),
                *K.smaq_quantize_bn(xb8.reshape(-1), gb, bbn, BN_SHAPE[1],
                                    math.prod(BN_SHAPE[2:]), stoch, key=key, call=3,
                                    consts=K.smaq_stats(xb8.reshape(-1), stoch))]

    eager = both()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        both()  # the side stream's workspaces
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = both()
    for replay in range(2):
        for o in captured:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize(device)
        if not all(bitwise_equal(a, c) for a, c in zip(eager, captured)):
            fail(f"replay {replay} of a captured bf16 S2FP8 / BN call differs from the eager call")
    say("  bf16 S2FP8 and BN calls captured in a CUDA graph: two replays bitwise the eager "
        "calls -> ok")
    del graph

    # 1000 back-to-back calls: the tickets and counters reset themselves
    split, small = big[:300_001].to(bf), big[:1728].to(bf)
    calls = [lambda: (S.s2fp8_fused(split, None, stochastic=False),),
             lambda: (S.s2fp8_fused(small, None, stochastic=False),),
             lambda: K.smaq_fused_bn(xb8, None, g, b, trunc)]
    firsts = [fn() for fn in calls]
    bad = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(1000 - len(calls)):
        for out, first in zip(calls[i % len(calls)](), firsts[i % len(calls)]):
            bad += (out.reshape(-1).view(torch.int16 if out.dtype == bf else torch.int32)
                    != first.reshape(-1).view(torch.int16 if first.dtype == bf
                                              else torch.int32)).sum()
    words = (S.workspace(split)[:S._COUNTER_WORDS].tolist()
             + K.workspace(split)[:K._COUNTER_WORDS].tolist())
    say(f"  1000 back-to-back bf16 calls (s2fp8 split and small, bn): {int(bad)} elements or "
        f"sizes apart from the first of their kind; counters after them {words} -> "
        f"{'ok' if int(bad) == 0 and not any(words) else 'MISMATCH'}")
    if int(bad) or any(words):
        fail("a bf16 S2FP8 or BN call changed over back-to-back calls, or a counter kept its count")
    return errs


def squeeze_coefs_of(mu, m):
    from smart_quantization_tpu_torch.ops.s2fp8 import squeeze_coefs

    return squeeze_coefs(mu, m)


# ---------------------------------------------------------------- phase 4
# the suffix of a bfloat16 tap's form in step_calls, and of a bfloat16
# form's launch counter
BF16_FORM = "_bf16"


def per_step_calls(trainer, model_name: str) -> int:
    """Encoder calls per training step: every tap forward and backward, every
    gradient, every non-exempt weight and every momentum buffer (SGD's
    trace, or Adam's mu and nu)."""
    from smart_quantization_tpu_torch.optim.compressed import norm_param_mask

    names = [n for n, _ in trainer.model.named_parameters()]
    kept = sum(not v for v in norm_param_mask(names).values())
    # BERT: 8 a layer, the embeddings' norm, the pooler's tanh, the
    # classifier (99 in bert-base)
    if model_name == "bert":
        taps = 8 * trainer.model.cfg.num_layers + 3
    else:
        taps = INCEPTION_TAPS if model_name == "inception" else RESNET18_TAPS
    return 2 * taps + len(names) + kept + len(names) * len(trainer.spec.momentum_buffers)


def draws_noise(args) -> bool:
    """Whether a command line's training step draws tensor-op noise through
    the Philox fill: BERT's and Inception's dropout, the row-wise codecs'
    and the packed state's rounding."""
    return (args.model in ("bert", "inception") or getattr(args, "momentum_rowwise", False)
            or getattr(args, "momentum_log_nu_rowwise", False) or args.packed_momentum
            or args.packed_weights)


def path_kernels(args) -> tuple[str, ...]:
    """The kernels a parsed command line's training runs through.  Under
    ``--compute_dtype bfloat16`` the taps' feature and gradient maps go to
    the bfloat16 forms and the optimizer's float32 leaves to the float32
    ones.  A bfloat16 SmaQ map takes ``smaq_plan``'s form: the one-launch
    form for every map of ResNet-18 at batch 128 but the small ones (the
    logits), whose small form is ``smaq_quantize`` alone; bert-base's
    largest maps (the FFN's 50 331 648 elements, the attention
    probabilities) and Inception's (its 32x32 stages, up to 37 748 736
    elements) are above the one-launch capacity and take the two launches,
    as the BN kernel's stats do."""
    fill = ("philox_fill",) if draws_noise(args) else ()
    if args.compress in ("fp8", "fp16", "bf16"):
        opt, taps = ("float_quantize",), ()
    elif args.compress == "s2fp8":
        opt, taps = ("s2fp8_stats", "s2fp8_quantize"), ()
        if args.compute_dtype == "bfloat16":
            # ResNet-18's maps at batch 128 reach both tables' sizes
            # (s2fp8_kernel.split_forms), and the smaller ones stay below
            return (*opt, *(f"{k}_bf16" for k in opt), "s2fp8_stats_table_bf16",
                    "s2fp8_quantize_window_bf16")
    else:
        # sampled stats take the TPU kernel's fixed positions: no stats launch
        opt = (() if args.use_sample_stats else ("smaq_stats",)) + ("smaq_quantize",)
        taps = ("smaq_quantize_bn",) if args.use_batch_norm else ()
        if args.compute_dtype == "bfloat16" and not args.use_sample_stats:
            split = args.model in ("bert", "inception") or args.use_batch_norm
            bf16 = (("smaq_stats",) if split else ()) + ("smaq_quantize",) + taps
            return (*opt, "smaq_onepass_bf16", *(f"{k}_bf16" for k in bf16), *fill)
    if args.compute_dtype == "bfloat16":
        return (*opt, *(f"{k}_bf16" for k in opt + taps), *fill)
    return (*opt, *taps, *fill)


def step_calls(trainer, model_args) -> list[tuple[int, str]]:
    """Every encoder call of one training step as (elements, form): each
    tap site forward and backward (the sites read off one forward pass of
    the model on ``model_args``, a batch's arguments, with the taps
    recording instead of compressing), every gradient, every non-exempt
    weight and every momentum buffer.  The form says what a SmaQ call
    launches: ``plain`` (``smaq_plan``'s form), ``bn`` (the BN kernel),
    ``given`` (the log2 codec's per-tensor call with its own stats: the
    quantize kernel alone), ``rows`` (the row-wise codecs: tensor ops, no
    SmaQ kernel; its size is a row's) or ``encode`` (packed state: the
    stats kernel, then tensor ops); a tap's form on a bfloat16 map ends in
    ``BF16_FORM`` (its launches are the bfloat16 forms')."""
    import torch

    from smart_quantization_tpu_torch.compress.base import SizeStats
    from smart_quantization_tpu_torch.convert import jax_axes
    from smart_quantization_tpu_torch.inject import tap
    from smart_quantization_tpu_torch.optim.compressed import by_rows, norm_param_mask

    taps = []

    def record(x, gen, compressor, *, gamma=None, **_):
        form = "bn" if gamma is not None else "plain"
        taps.append((x.numel(), form + BF16_FORM * (x.dtype == torch.bfloat16)))
        return x, SizeStats.of(x.numel(), 32, 32, x.device)

    model, real = trainer.model, tap.compression_tap
    tap.compression_tap = record
    try:
        model.eval()
        with torch.no_grad():
            model(*model_args, tap.TapContext(torch.Generator()))
    finally:
        tap.compression_tap = real
    comp, spec = trainer.optim_comp, trainer.spec
    named = dict(model.named_parameters())
    exempt = norm_param_mask(list(named))
    weights = [(p.numel(), "encode" if comp.packed_weights else "plain")
               for k, p in named.items() if not exempt[k]]
    momentum = []
    for _, all_positive in spec.momentum_buffers:
        log_nu = all_positive and comp.momentum_log_nu
        rows = comp.momentum_log_nu_rowwise if log_nu else comp.momentum_rowwise
        for k, p in named.items():
            if comp.packed_momentum:
                form = "encode"
            elif rows and by_rows(k, p):
                momentum.append((p.numel() // p.shape[jax_axes(k, p.dim())[0]], "rows"))
                continue
            else:
                form = "given" if log_nu else "plain"
            momentum.append((p.numel(), form))
    # a gradient map has its feature map's dtype; a BN tap's backward is plain
    return (taps + [(n, "plain" + BF16_FORM * f.endswith(BF16_FORM)) for n, f in taps]
            + [(p.numel(), "plain") for p in named.values()] + weights + momentum)


def expected_launches(args, calls) -> dict:
    """Launches of each kernel in one training step: one per encoder call
    for the float formats; for S2FP8 and SmaQ, a stats launch where
    ``s2fp8_plan`` or ``smaq_plan`` takes the split form (and for every
    BN-kernel call) and one quantize launch per call, in the element form
    of the call (``BF16_FORM``; a large bfloat16 S2FP8 call's are the table
    kernels where ``s2fp8_kernel.split_forms`` says), or one ``smaq_onepass`` launch where
    ``smaq_plan`` takes the one-launch form (bfloat16 only); for SmaQ's other
    forms (``step_calls``) the quantize alone (``given``), the stats alone
    (``encode``) or nothing (``rows``); none for a SmaQ call below
    ``--min_size`` elements (it passes through); under --use_batch_norm
    the forward taps of the BatchNorms go to the BN kernel.  Philox fills:
    one for each of BERT's dropout sites (3 a layer, the embeddings', the
    pooler's) and for Inception's pre-fc dropout, one for the rounding of
    each ``rows`` and ``encode`` call of ``--min_size`` elements (a row's,
    for ``rows``) or more, and one more for its offset under
    ``--use_sample_stats``."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda.launch import sm_count
    from smart_quantization_tpu_torch.ops.cuda.s2fp8_kernel import s2fp8_plan, split_forms
    from smart_quantization_tpu_torch.ops.cuda.smaq_kernel import onepass_slots, smaq_plan

    device = torch.device("cuda", torch.cuda.current_device())
    sms = sm_count(device)
    kernels = path_kernels(args)
    out = dict.fromkeys(kernels, 0)

    def add(name, form, k=1):
        name += BF16_FORM * form.endswith(BF16_FORM)
        out[name] = out.get(name, 0) + k

    forms = [(n, form.removesuffix(BF16_FORM), form) for n, form in calls]
    fills = {}
    if "philox_fill" in kernels:
        draws = 1 + int(args.use_sample_stats)
        fills["philox_fill"] = sum(
            draws for n, form in calls if form in ("rows", "encode") and n >= args.min_size)
        if args.model == "bert":
            fills["philox_fill"] += 3 * BERT_LAYERS + 2
        elif args.model == "inception":
            fills["philox_fill"] += 1
    if args.compress == "s2fp8":
        for n, _, form in forms:
            if s2fp8_plan(n, sms)[0] == "small":
                add("s2fp8_quantize", form)
                continue
            table, window = split_forms(
                n, torch.bfloat16 if form.endswith(BF16_FORM) else torch.float32)
            add("s2fp8_stats_table" if table else "s2fp8_stats", form)
            add("s2fp8_quantize_window" if window else "s2fp8_quantize", form)
    elif args.compress in ("fp8", "fp16", "bf16"):
        for _, _, form in forms:
            add("float_quantize", form)
    else:
        stats = 0 if args.use_sample_stats else 1
        for n, base, form in forms:
            if n < args.min_size or base == "rows":
                continue
            if base == "bn":
                add("smaq_stats", form, stats)
                add("smaq_quantize_bn", form)
            elif base == "encode":
                add("smaq_stats", form, stats)
            elif base == "given":
                add("smaq_quantize", form)
            elif not stats:
                add("smaq_quantize", form)
            else:
                plan = smaq_plan(n, sms, onepass_slots(device) if form != base else 0)[0]
                if plan == "onepass":
                    add("smaq_onepass", form)
                else:
                    add("smaq_stats", form, int(plan == "split"))
                    add("smaq_quantize", form)
    out.update(fills)
    return {k: v for k, v in out.items() if k in kernels}


def run_main_path(extra_argv=(), ratio_range=(4.5, 5.5), finite_loss=True,
                  train_batches=10, label="smart", base_argv=MAIN_ARGV):
    """The user's entry point, with the launch counts read around it."""
    from smart_quantization_tpu_torch.train.__main__ import main
    from smart_quantization_tpu_torch.utils.config import parse_args

    argv = base_argv + list(extra_argv) + [
        "--limit_train_batches", str(train_batches), "--limit_val_batches", "2",
        "--logdir", os.path.join(OUT, "smoke_logs")]
    kernels = path_kernels(parse_args(argv))
    reset_counts()
    final = main(argv)
    counts = read_counts()
    say(f"  [{label}] main path launches: {counts}")
    if any(counts[k] == 0 for k in kernels):
        fail(f"[{label}] the main path launched a kernel of {kernels} no time")
    stray = {k: v for k, v in counts.items() if k not in kernels and v}
    if stray:
        fail(f"[{label}] the main path launched kernels off its path: {stray}")
    tags = ("forward_autograd", "backward_autograd", "optimizer_grad",
            "optimizer_weight", "optimizer_momentum")
    missing = [t for t in tags if f"compression_ratio_{t}" not in final]
    if missing:
        fail(f"[{label}] missing compression_ratio tags: {missing}")
    ratio = final.get("compression_ratio", float("nan"))
    loss = final.get("val_loss", float("nan"))
    say(f"  [{label}] compression ratios: " + ", ".join(
        f"{t}={final[f'compression_ratio_{t}']:.4f}" for t in tags)
        + f", overall={ratio!r}; val_loss={loss!r} (finite: {math.isfinite(loss)})")
    lo, hi = ratio_range
    if not lo <= ratio <= hi:
        fail(f"[{label}] overall compression ratio {ratio} outside {lo}-{hi}")
    if finite_loss and not math.isfinite(loss):
        fail(f"[{label}] non-finite validation loss")
    return {k: counts[k] for k in kernels}, final


def nondeterministic() -> None:
    """PyTorch's default kernels (the trainer's ``make_reproducible``
    undone)."""
    import torch

    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


@contextlib.contextmanager
def default_kernels():
    """Trainers built inside keep PyTorch's default kernels: the control of
    the seeded-run check and the determinism cost only."""
    from smart_quantization_tpu_torch.train import loop

    real, loop.make_reproducible = loop.make_reproducible, nondeterministic
    try:
        yield
    finally:
        loop.make_reproducible = real
        real()


@contextlib.contextmanager
def casts_in_encoder_calls():
    """Count the dtype casts (``aten._to_copy``, a ``copy_`` across dtypes)
    that run inside the encoders' kernel paths (``smaq_fused``,
    ``smaq_fused_bn``, ``float_quantize_fused``, ``s2fp8_fused``): a bf16
    map must reach its kernel's bf16 form with none around it.  Yields a
    one-element list holding the count."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K

    count = [0]
    aten = torch.ops.aten

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is aten._to_copy.default or (
                    func is aten.copy_.default and args[0].dtype != args[1].dtype):
                count[0] += 1
            return func(*args, **kwargs)

    def watched(fn):
        def call(*a, **kw):
            with Casts():
                return fn(*a, **kw)
        return call

    patched = [(K, "smaq_fused"), (K, "smaq_fused_bn"), (F, "float_quantize_fused"),
               (S, "s2fp8_fused")]
    real = [getattr(m, name) for m, name in patched]
    for (m, name), fn in zip(patched, real):
        setattr(m, name, watched(fn))
    try:
        yield count
    finally:
        for (m, name), fn in zip(patched, real):
            setattr(m, name, fn)


def time_steps(extra_argv, check_launches: bool, finite_loss: bool = True,
               base_argv=MAIN_ARGV, timed=10):
    """Steps of the trainer a command line builds: 2 warm-up steps, then
    (with ``check_launches``) 5 steps whose launches must equal the plan,
    with no dtype cast around an encoder call and no sync with the host,
    then ``timed`` timed steps.  Returns the median step (ms), the loss
    after the last step, the launches of a step, the step's encoder calls,
    the peak device memory of the timed steps and the memory held between
    steps (GB), the last step's compression sizes by tag and its
    ``avg_grad_norm`` (None without ``--measure_average_grad_norm``)."""
    import gc

    import torch

    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    gc.collect()  # the last run's trainer, before this one's peak is read
    torch.manual_seed(0)
    # no logdir: these steps are timed, not logged
    args = parse_args(base_argv + list(extra_argv) + ["--logdir", ""])
    trainer = build_trainer(args)
    state = trainer.init_state()
    # slice every batch first: an epoch's start uploads its order, which is
    # a host-to-device copy the sync check would flag
    batches = []
    epoch = 0
    while len(batches) < 7 + timed:
        batches.extend(trainer.data.device_train_batches(epoch, trainer.device))
        epoch += 1
    batches = iter(batches)
    calls, expected = [], {}
    if check_launches:
        inputs, _ = next(iter(trainer.data.device_train_batches(0, trainer.device)))
        calls = step_calls(trainer, trainer.task.model_args(trainer.task.prepare_eval(inputs)))
        want_calls = per_step_calls(trainer, args.model)
        if len(calls) != want_calls:
            fail(f"{len(calls)} encoder calls per step, not {want_calls}")
        expected = expected_launches(args, calls)

    def step():
        inputs, labels = next(batches)
        x = trainer.task.prepare_train(inputs, trainer.data_gen)
        return trainer.train_step(state, x, labels)

    for _ in range(2):  # warm-up: cuDNN autotuning, the allocator
        step()
    torch.cuda.synchronize()
    if check_launches:
        # non-logging steps: any device-to-host sync raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            with casts_in_encoder_calls() as casts:
                for _ in range(5):
                    before = read_counts()
                    metrics = step()
                    got = {k: v - before[k] for k, v in read_counts().items()}
                    want = {k: expected.get(k, 0) for k in got}
                    if got != want:
                        fail(f"a step launched {got}; expected {want}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if casts[0]:
            fail(f"{casts[0]} dtype casts ran inside encoder calls in 5 steps")
        say(f"  launches on every step: {expected} for {len(calls)} encoder calls; "
            "no host sync and no cast around an encoder call in 5 non-logging steps")
        if finite_loss and not math.isfinite(float(metrics["train_loss"])):
            fail("non-finite training loss")
    else:
        for _ in range(5):
            step()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    loss = float(metrics["train_loss"])
    if finite_loss and not math.isfinite(loss):
        fail("non-finite training loss")
    return {"ms": statistics.median(times), "loss": loss, "launches": expected,
            "calls": calls, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "resident_gb": torch.cuda.memory_allocated() / 1e9,
            "sizes": {k.split("/", 1)[1]: v.tolist() for k, v in metrics.items()
                      if k.startswith("_ratio/")},
            "avg_grad_norm": (float(metrics["avg_grad_norm"]) if "avg_grad_norm" in metrics
                              else None)}


def seeded_run(base_argv, extra, steps, out_dir, checkpoint="epoch_0000.pt"):
    """The CLI's ``main`` for ``steps`` steps an epoch with every loss logged
    and a checkpoint at each epoch's end; returns the logged losses by step
    and the tensors of ``checkpoint``."""
    import torch

    from smart_quantization_tpu_torch.train.__main__ import main

    main(base_argv + list(extra) + [
        "--limit_train_batches", str(steps), "--limit_val_batches", "2", "--log_every", "1",
        "--logdir", out_dir, "--name", "run", "--checkpoint_dir", out_dir])
    with open(os.path.join(out_dir, "run.metrics.jsonl")) as f:
        losses = {r["step"]: r["train_loss"] for r in map(json.loads, f) if "train_loss" in r}
    flat = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(tree, torch.Tensor):
            flat[prefix] = tree
        else:
            flat[prefix] = torch.tensor(tree)

    walk("", torch.load(os.path.join(out_dir, checkpoint), map_location="cpu",
                        weights_only=True))
    return losses, flat


def seeded_twice(label, base_argv, extra=(), steps=5, control=False):
    """The same seeded command twice in this process; returns whether the
    losses at every step and every tensor of the checkpoints agree bit for
    bit, and a line that says how.  ``control`` keeps PyTorch's default
    kernels."""
    import shutil

    runs = []
    for i in range(2):
        out_dir = os.path.join(ROOT, "tmp_chip_smoke", f"{label}_{int(control)}_{i}")
        shutil.rmtree(out_dir, ignore_errors=True)
        with default_kernels() if control else contextlib.nullcontext():
            runs.append(seeded_run(base_argv, extra, steps, out_dir))
        shutil.rmtree(os.path.dirname(out_dir), ignore_errors=True)
    (la, ta), (lb, tb) = runs
    if len(la) != steps or set(ta) != set(tb):
        fail(f"[{label}] seeded runs logged {len(la)} and {len(lb)} losses")
    diff_steps = [s for s in sorted(la) if la[s] != lb.get(s)]
    diff_tensors = [k for k in ta if not torch_equal(ta[k], tb[k])]
    line = (f"losses at steps {sorted(la)} {'equal' if not diff_steps else 'differ from step ' + str(diff_steps[0])}"
            f" ({la[min(la)]!r} .. {la[max(la)]!r} / {lb[max(lb)]!r}); "
            f"{len(ta) - len(diff_tensors)} of {len(ta)} checkpoint tensors bitwise equal")
    if diff_tensors:
        line += f" (first differing: {diff_tensors[:3]})"
    return not diff_steps and not diff_tensors, line


def torch_equal(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


# ------------------------------------------------------ phase 4: bfloat16
def ratio_of(sizes: dict) -> float:
    """The overall compression ratio of one step's sizes by tag."""
    return sum(v[0] for v in sizes.values()) / sum(v[1] for v in sizes.values())


def check_ratio(label, sizes, ratio_range) -> float:
    ratio = ratio_of(sizes)
    lo, hi = ratio_range
    if not lo <= ratio <= hi:
        fail(f"[{label}] overall compression ratio {ratio} outside {lo}-{hi}")
    return ratio


def bf16_cells(card) -> tuple[dict, dict, dict]:
    """Phase 4 under ``--compute_dtype bfloat16``: ResNet-18 SmaQ 6/8 through
    the CLI and its steps (with ``--measure_average_grad_norm``), FP8,
    FP16, BF16, S2FP8 and SmaQ ``--use_batch_norm`` steps, and bert-base's
    codecs cell beside its ``--no_compress`` step: each cell's ratio, a
    finite loss, launches per step equal to the plan with no cast around an
    encoder call and no host sync (``time_steps``), and bert-base's loss
    after 17 steps within 1.25x of the plain bf16 run's.  Returns the main
    path's launches, the median steps (ms) and the encoder calls of a
    ResNet-18 and of a bert-base codecs step (``step_calls``)."""
    launches, steps = {}, {}
    got, _ = run_main_path(BF16_ARGV, label="bf16 smart")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    run = time_steps(BF16_ARGV + ["--measure_average_grad_norm"], check_launches=True)
    norm = run["avg_grad_norm"]
    if norm is None or not math.isfinite(norm) or norm <= 0:
        fail(f"[bf16 smart] avg_grad_norm {norm} is not a finite positive number")
    steps["bf16 smart"] = run["ms"]
    calls = {"ResNet-18 bf16": run["calls"]}
    say(f"  [bf16 smart] median step {run['ms']:.2f} ms (loss {run['loss']:.4f}, avg_grad_norm "
        f"{norm:.4f}), peak memory {run['peak_gb']:.2f} GB, held {run['resident_gb']:.2f} GB "
        f"on {card}")
    for label, extra, ratio_range, finite in BF16_PATHS:
        got, _ = run_main_path(BF16_ARGV + extra, ratio_range, finite, train_batches=3,
                               label=label)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        run = time_steps(BF16_ARGV + extra, check_launches=True, finite_loss=finite, timed=3)
        ratio = check_ratio(label, run["sizes"], ratio_range)
        steps[label] = run["ms"]
        say(f"  [{label}] ratio {ratio!r}; median step {run['ms']:.2f} ms (loss "
            f"{run['loss']:.4f}, finite: {math.isfinite(run['loss'])}) on {card}")
    codec = time_steps(BF16_ARGV + CODEC_ARGV, check_launches=True, base_argv=BERT_ARGV)
    plain = time_steps(BF16_ARGV + ["--no_compress"], check_launches=False, base_argv=BERT_ARGV)
    ratio = check_ratio("bert codecs bf16", codec["sizes"], (4.5, 5.5))
    say(f"  [bert codecs bf16] ratio {ratio!r}; train loss after 17 steps {codec['loss']!r}, "
        f"{plain['loss']!r} --no_compress; median step {codec['ms']:.2f} ms against "
        f"{plain['ms']:.2f} ms; peak memory {codec['peak_gb']:.2f} / {plain['peak_gb']:.2f} GB, "
        f"held {codec['resident_gb']:.2f} / {plain['resident_gb']:.2f} GB on {card}")
    if not math.isfinite(codec["loss"]) or codec["loss"] > 1.25 * plain["loss"]:
        fail(f"[bert codecs bf16] loss {codec['loss']} is not finite or above 1.25x the plain "
             f"loss {plain['loss']}")
    steps.update({"bert codecs bf16": codec["ms"], "bert no_compress bf16": plain["ms"]})
    calls["bert-base codecs bf16"] = codec["calls"]
    for label, extra, ratio_range in (
            ("bf16 smart compress_loss", [], (4.5, 5.5)),
            ("bf16 fp8 compress_loss", ["--compress", "fp8"], (4.0, 4.0))):
        got, _ = run_main_path(BF16_ARGV + extra + ["--compress_loss"], ratio_range,
                               train_batches=3, label=label)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    return launches, steps, calls


def tuned_run(card) -> dict:
    """``--auto_lr_find`` on ResNet-18 under bfloat16 at K=8: the range test
    (50 steps, six groups in the probe's own CUDA graph and two single
    steps) leaves the model's weights and the trainer's cached graphs as
    they were and a constant learning rate; then the run trains, capturing
    its own graph, to a finite loss.  Returns the run's launches."""
    import torch

    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.train.loop import run
    from smart_quantization_tpu_torch.train.tune import tune_from_args
    from smart_quantization_tpu_torch.utils.config import parse_args

    args = parse_args(MAIN_ARGV + BF16_ARGV + [
        "--auto_lr_find", "--steps_per_call", str(K_RESNET), "--limit_train_batches", "8",
        "--limit_val_batches", "2", "--logdir", os.path.join(OUT, "smoke_logs")])
    torch.manual_seed(args.seed)
    trainer = build_trainer(args)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    t0 = time.perf_counter()
    tune_from_args(trainer, args)
    took = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(trainer.model.parameters(), before))
    lr = trainer.spec.lr(0)
    if not same or trainer._train_graph is not None or lr != trainer.spec.lr(10**6):
        fail("--auto_lr_find did not put the model and its step graphs back, or left a schedule")
    reset_counts()
    final = run(trainer)
    counts = read_counts()
    kernels = path_kernels(args)
    say(f"  [auto_lr_find] suggestion {lr!r} after {took:.1f} s (50 steps at K={K_RESNET}); "
        f"weights and graphs put back; the run at it: val_loss {final['val_loss']!r}, its own "
        f"graph captured ({trainer._train_graph is not None}), launches {counts}")
    if not math.isfinite(final["val_loss"]) or trainer._train_graph is None:
        fail("the run after --auto_lr_find did not train through its own graph")
    if any(counts[k] == 0 for k in kernels):
        fail(f"the run after --auto_lr_find launched a kernel of {kernels} no time")
    return {k: counts[k] for k in kernels}


def scaled_batch(card) -> int:
    """``--auto_scale_batch_size`` on ResNet-18 under bfloat16, doubling from
    batch 128: on the whole card with the CLI's (JAX's) eight trials, then
    with the caching allocator capped at a quarter of the card, so that a
    trial runs out of memory (batch 16 384 still fits the whole card, and
    32 768 would put 2^31 elements in one activation).  After the
    out-of-memory trial the trial's memory is given back (the allocator
    holds what it held before), and one step at batch 128 trains on the
    same card.  Returns the size found on the whole card."""
    import torch

    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.train.tune import scale_batch_size, trial_batch
    from smart_quantization_tpu_torch.utils.config import parse_args

    args = parse_args(MAIN_ARGV + BF16_ARGV + ["--logdir", ""])
    torch.manual_seed(args.seed)
    trainer = build_trainer(args)
    next(iter(trainer.data.device_train_batches(0, trainer.device)))  # the data on the card
    t0 = time.perf_counter()
    best = scale_batch_size(trainer, args.batch_size)
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    held, held_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    cap = 0.25
    torch.cuda.set_per_process_memory_fraction(cap)
    try:
        capped = scale_batch_size(trainer, args.batch_size)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    after, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    m = trainer.train_step(trainer.init_state(), *trial_batch(trainer, args.batch_size))
    loss = float(m["train_loss"])
    say(f"  [auto_scale_batch_size] {best} on the whole card ({took:.1f} s, eight trials from "
        f"{args.batch_size}); {capped} under a {cap:.0%} memory cap, then out of memory; "
        f"allocated {held / 1e9:.2f} GB before and {after / 1e9:.2f} GB after, reserved "
        f"{held_reserved / 1e9:.2f} GB before and {reserved / 1e9:.2f} GB after; then a step "
        f"at batch {args.batch_size}: loss {loss:.4f} on {card}")
    if capped >= args.batch_size * 2**7 or capped < 2 * args.batch_size:
        fail(f"--auto_scale_batch_size found {capped} under the cap: no out-of-memory trial")
    if after > held + 2**28 or reserved > held_reserved + 2**30 or not math.isfinite(loss):
        fail("--auto_scale_batch_size kept the failed trial's memory, or the step after it failed")
    return best


# ------------------------------------------------------ phase 4: K steps
K_RESNET, K_BERT = 8, 4
# the other encoders and options: K=2 against K=1 on ResNet-18, 5 steps
# (a group that warms up and captures, a replayed group, a leftover step)
K2_PATHS = [
    ("fp8", ["--compress", "fp8"]),
    ("fp16", ["--compress", "fp16"]),
    ("bf16", ["--compress", "bf16"]),
    ("s2fp8", ["--compress", "s2fp8", "--no_terminate_on_nan"]),
    ("smart bn", ["--use_batch_norm"]),
    ("smart accumulator", ["--use_weight_accumulator"]),
    ("smart packed momentum", ["--packed_momentum"]),
    ("smart sample stats", ["--use_sample_stats"]),
]


def k_equals_eager(label, base_argv, extra, k, steps, epochs=1):
    """The seeded command at K=1 and at K=k through the CLI's ``main``,
    every loss logged and a checkpoint at each epoch's end: fails unless
    every loss and every tensor of the last checkpoint are bitwise equal.
    Returns the K=k run's launch counts (the slice's main path: the counts
    are set to 0 just before it and read just after)."""
    import shutil

    from smart_quantization_tpu_torch.utils.config import parse_args

    import gc

    import torch

    runs = []
    argv = base_argv + list(extra) + ["--max_epochs", str(epochs)]
    for spc in (1, k):
        gc.collect()  # the last run's trainer and its graphs' memory pools
        torch.cuda.empty_cache()
        out_dir = os.path.join(ROOT, "tmp_chip_smoke", f"k_{label.replace(' ', '_')}_{spc}")
        shutil.rmtree(out_dir, ignore_errors=True)
        reset_counts()
        t0 = time.perf_counter()
        runs.append(seeded_run(argv, ["--steps_per_call", str(spc)], steps, out_dir,
                               checkpoint=f"epoch_{epochs - 1:04d}.pt"))
        counts = read_counts()
        wall = time.perf_counter() - t0
        shutil.rmtree(os.path.dirname(out_dir), ignore_errors=True)
    kernels = path_kernels(parse_args(argv))
    if any(counts[name] == 0 for name in kernels):
        fail(f"[{label} K={k}] a kernel of {kernels} was launched no time: {counts}")
    (la, ta), (lb, tb) = runs
    diff_steps = [s for s in sorted(la) if la[s] != lb.get(s)]
    diff_tensors = [name for name in ta if name not in tb or not bitwise_equal(ta[name], tb[name])]
    say(f"  [{label}] K={k} against K=1, {len(la)} steps ({epochs} epoch(s) of {steps}): losses "
        f"{'equal' if not diff_steps and len(la) == len(lb) else 'differ at ' + str(diff_steps[:3])}"
        f" ({la[min(la)]!r} .. {la[max(la)]!r}); {len(ta) - len(diff_tensors)} of {len(ta)} "
        f"checkpoint tensors bitwise equal; K={k} run {wall:.1f} s")
    if diff_steps or diff_tensors or len(la) != len(lb) or len(la) != steps * epochs:
        fail(f"[{label}] the K={k} run is not bitwise the K=1 run: {diff_tensors[:3]}")
    return {name: counts[name] for name in kernels}


def state_tensors(trainer, state) -> dict:
    """Every tensor a run keeps: parameters (packed ones as their codes),
    buffers and the optimizer state."""
    import torch

    from smart_quantization_tpu_torch.train.state import to_saved

    flat = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for name, v in tree.items():
                walk(f"{prefix}/{name}", v)
        elif isinstance(tree, torch.Tensor):
            flat[prefix] = tree
        else:
            flat[prefix] = torch.tensor(tree)

    params = state.packed_params
    if params is None:
        params = {n: p.detach() for n, p in trainer.model.named_parameters()}
    walk("params", to_saved(params))
    walk("buffers", dict(trainer.model.named_buffers()))
    walk("opt", to_saved(state.opt_state))
    return flat


def resume_and_replay(k=K_RESNET):
    """ResNet-18 SmaQ at K=k through the trainer: the first group's
    launches are k eager (warm-up) steps and k captured ones, each equal to
    the launch plan of one step, and a replay launches nothing from the
    host and makes no host sync; a run resumed from a checkpoint after the
    first group ends its next two groups bitwise where the straight run
    does; the grouped evaluation (K=4, 13 batches: three groups and a
    leftover) equals the single one."""
    import torch

    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    args = parse_args(MAIN_ARGV + ["--steps_per_call", str(k), "--logdir", ""])
    torch.manual_seed(0)
    straight = build_trainer(args)
    state = straight.init_state()
    batches, epoch = [], 0
    while len(batches) < 3 * k:
        for inputs, labels in straight.data.device_train_batches(epoch, straight.device):
            batches.append((straight.task.prepare_train(inputs, straight.data_gen), labels))
        epoch += 1
    groups = [batches[i * k:(i + 1) * k] for i in range(3)]
    inputs, _ = next(iter(straight.data.device_train_batches(0, straight.device)))
    calls = step_calls(straight, straight.task.model_args(straight.task.prepare_eval(inputs)))
    per_step = expected_launches(args, calls)

    reset_counts()
    straight.train_steps(state, groups[0])
    first = {name: v for name, v in read_counts().items() if v}
    if first != {name: 2 * k * v for name, v in per_step.items() if v}:
        fail(f"the first group launched {first}; expected {2 * k} x {per_step}")
    path = os.path.join(ROOT, "tmp_chip_smoke", "resume", "group_1.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    straight.save_checkpoint(path, state)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [straight.train_steps(state, g)["train_loss"] for g in groups[1:]]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    replayed = {name: v for name, v in read_counts().items() if v}
    if replayed:
        fail(f"a replay launched kernels from the host: {replayed}")
    say(f"  [resnet18 K={k}] first group: {first} = {k} eager warm-up steps + {k} captured "
        f"steps, {per_step} each (a replayed step runs the captured launches / K); two "
        "replays: no launch from the host, no host sync")

    torch.manual_seed(0)
    resumed = build_trainer(args)
    s2 = resumed.load_checkpoint(path)
    got = [resumed.train_steps(s2, g)["train_loss"] for g in groups[1:]]
    want_t, got_t = state_tensors(straight, state), state_tensors(resumed, s2)
    same = (all(bitwise_equal(a, b) for a, b in zip(losses, got)) and set(want_t) == set(got_t)
            and all(bitwise_equal(v, got_t[name]) for name, v in want_t.items()))
    say(f"  [resnet18 K={k}] resumed after the first group: the next {2 * k} losses and "
        f"{len(want_t)} state tensors {'bitwise equal' if same else 'differ'} at step "
        f"{s2.step} (straight {state.step})")
    if not same or s2.step != state.step:
        fail("the resumed K-step run does not end where the straight run ends")

    straight.cfg.limit_val_batches = 13
    straight.cfg.steps_per_call = 1
    single = straight.evaluate(state)
    straight.cfg.steps_per_call = 4
    grouped = straight.evaluate(state)
    say(f"  [resnet18] evaluation of 13 batches in groups of 4 (a graph) and singly: "
        f"{'equal' if grouped == single else 'differ'} (val_loss {single['val_loss']!r}, "
        f"val_accuracy {single['val_accuracy']!r})")
    if grouped != single:
        fail(f"grouped evaluation {grouped} differs from single evaluation {single}")


def profile_dir_run():
    """A ``--profile_dir`` run of 2 steps: its trace names the five regions
    and holds device kernels."""
    import glob
    import shutil

    from smart_quantization_tpu_torch.train.__main__ import main
    from smart_quantization_tpu_torch.utils.profiling import REGIONS

    out_dir = os.path.join(ROOT, "tmp_chip_smoke", "profile")
    shutil.rmtree(out_dir, ignore_errors=True)
    main(MAIN_ARGV + ["--limit_train_batches", "2", "--limit_val_batches", "1",
                      "--profile_dir", out_dir, "--profile_steps", "2", "--logdir", out_dir])
    traces = glob.glob(os.path.join(out_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"--profile_dir wrote {len(traces)} traces")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = sum(e.get("cat") == "kernel" for e in events)
    missing = [r for r in REGIONS if r not in names]
    say(f"  --profile_dir: {os.path.basename(traces[0])} names "
        f"{len(REGIONS) - len(missing)} of the {len(REGIONS)} regions, {kernels} device kernels")
    shutil.rmtree(os.path.dirname(out_dir), ignore_errors=True)
    if missing or not kernels:
        fail(f"the trace lacks the regions {missing} or device kernels ({kernels})")


# the K-step cells: (label, the command line, K, and at K=1 and at K the
# warm-up, timed and profiled dispatches)
# (bert-base at K=1: 1 warm-up, 2 timed, 1 profiled step; at K=4: 1, 1 and
# 1 dispatches of 4 steps)
# (ResNet-18 at K=1: 2 warm-up, 6 timed, 2 profiled steps; at K=8: 1, 3
# and 1 dispatches.)  The bert-base z-score, packed and bf16 --no_compress
# cells (rows of PERF.md section 5) are no longer timed here: their trainer
# builds and graph captures took 90 s of a script that must end in 900 s.
BERT_K_COUNTS = ((1, 2, 1), (1, 1, 1))
RESNET_K_COUNTS = ((2, 6, 2), (1, 3, 1))
K_CELLS = [
    ("ResNet-18 smart", MAIN_ARGV, K_RESNET, RESNET_K_COUNTS),
    ("bert-base codecs", BERT_ARGV + CODEC_ARGV, K_BERT, BERT_K_COUNTS),
    ("ResNet-18 smart bf16", MAIN_ARGV + BF16_ARGV, K_RESNET, RESNET_K_COUNTS),
    ("bert-base codecs bf16", BERT_ARGV + CODEC_ARGV + BF16_ARGV, K_BERT, BERT_K_COUNTS),
]


def k_timings(card, cells=K_CELLS, out_name="k_step_times.json") -> dict:
    """Each K-step cell at K=1 and at its K, in turns, by
    ``profile_step.profile``: the median step, device busy and idle share,
    kernels and host launch calls a step, peak memory and the memory held
    between steps; into ``chiprun_out/<out_name>``."""
    import gc

    import torch

    from smart_quantization_tpu_torch.profile_step import profile
    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    out = {"card": card, "cells": {}}
    for label, argv, k, counts in cells:
        cell = {}
        for spc, (warmup, steps, profiled) in zip((1, k), counts):
            gc.collect()
            torch.cuda.empty_cache()
            torch.manual_seed(0)
            trainer = build_trainer(parse_args(argv + ["--steps_per_call", str(spc),
                                                       "--logdir", ""]))
            r = profile(trainer, steps=steps, warmup=warmup, profiled=profiled)
            del trainer
            r.pop("top")
            cell[f"K={spc}"] = r
            say(f"  [{label} K={spc}] step {r['step_ms']:.2f} ms, device busy "
                f"{r['device_busy_ms']:.2f} ms, idle {r['device_idle_share']:.1%}, "
                f"{r['launches_per_step']:.0f} kernels and {r['host_launches_per_step']:.2f} "
                f"host launch calls a step, peak {r['peak_memory_gb']:.2f} GB from the first "
                f"step, held {r['held_memory_gb']:.2f} GB allocated and "
                f"{r['reserved_memory_gb']:.2f} GB reserved between steps (the graph's pool "
                f"under K > 1) on {card}")
        out["cells"][label] = cell
    with open(os.path.join(OUT, out_name), "w") as f:
        json.dump(out, f, indent=1)
    return out


# ------------------------------------------------------ phase 4: Inception-v3
# its K-step timings: (label, command line, K, and at K=1 and at K the
# warm-up, timed and profiled dispatches)
INCEPTION_K_COUNTS = ((1, 4, 1), (1, 2, 1))
INCEPTION_K_CELLS = [
    ("Inception-v3 smart", INCEPTION_ARGV, K_RESNET, INCEPTION_K_COUNTS),
    ("Inception-v3 smart bf16", INCEPTION_ARGV + BF16_ARGV, K_RESNET, INCEPTION_K_COUNTS),
]


def graph_capture(argv, k=K_RESNET) -> dict:
    """A K-step trainer's first dispatch (K eager warm-up steps, then the
    capture of K steps) and its second (one replay), on the host clock,
    with the memory the caching allocator and the graph's pool hold after
    them."""
    import gc

    import torch

    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    gc.collect()
    torch.cuda.empty_cache()
    torch.manual_seed(0)
    trainer = build_trainer(parse_args(argv + ["--steps_per_call", str(k), "--logdir", ""]))
    state = trainer.init_state()
    batches, epoch = [], 0
    while len(batches) < 2 * k:
        for inputs, labels in trainer.data.device_train_batches(epoch, trainer.device):
            batches.append((trainer.task.prepare_train(inputs, trainer.data_gen), labels))
        epoch += 1
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    out = {}
    for name, group in (("first_s", batches[:k]), ("replay_s", batches[k:2 * k])):
        t0 = time.perf_counter()
        trainer.train_steps(state, group)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    out["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    out["reserved_added_gb"] = (torch.cuda.memory_reserved() - reserved0) / 1e9
    return out


def inception_cell(card) -> dict:
    """Inception-v3 on CIFAR-10 at batch 128, SmaQ 6/8 on every structure:
    through the CLI's ``main`` (the main path's launches, the five ratio
    tags, a ratio of 4.5-5.5, a finite loss) in float32 and under
    ``--compute_dtype bfloat16``; each one's steps (``time_steps``: launches
    a step equal to the plan for its 1226 encoder calls, no host sync, no
    cast around an encoder call, a finite loss, its ratio); K=8 against
    K=1 in both, every loss and checkpoint tensor bitwise; the seeded
    command twice, bitwise; a short ``--use_batch_norm`` run (the BN
    kernel launched, a finite loss); the K=8 graph's first dispatch
    (warm-up and capture), a replay and its memory; and each form at K=1
    and K=8 by ``profile_step.profile`` (``chiprun_out/inception_times.json``).
    Returns the main-path runs' launches."""
    t_start = time.perf_counter()
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for label, extra in (("inception", []), ("inception bf16", BF16_ARGV)):
        got, _ = run_main_path(extra, train_batches=3, label=label, base_argv=INCEPTION_ARGV)
        add(got)
        run = time_steps(extra, check_launches=True, base_argv=INCEPTION_ARGV, timed=5)
        ratio = check_ratio(label, run["sizes"], (4.5, 5.5))
        say(f"  [{label}] {len(run['calls'])} encoder calls a step over "
            f"{sum(n for n, _ in run['calls'])} elements; ratio {ratio!r}; median step "
            f"{run['ms']:.2f} ms (loss {run['loss']:.4f}), peak memory {run['peak_gb']:.2f} GB, "
            f"held {run['resident_gb']:.2f} GB on {card}")
    for label, extra in (("inception", []), ("inception bf16", BF16_ARGV)):
        add(k_equals_eager(label, INCEPTION_ARGV, extra, K_RESNET, 9, epochs=2))
    same, line = seeded_twice("inception", INCEPTION_ARGV, steps=3)
    say(f"  [inception] the same seeded command twice: {line}")
    if not same:
        fail("[inception] two runs of one seeded command differ")
    got, _ = run_main_path(["--use_batch_norm"], train_batches=3, label="inception bn",
                           base_argv=INCEPTION_ARGV)
    add(got)
    cap = graph_capture(INCEPTION_ARGV)
    say(f"  [inception K={K_RESNET}] first dispatch ({K_RESNET} eager steps and the capture) "
        f"{cap['first_s']:.2f} s, a replay {cap['replay_s']:.3f} s; reserved "
        f"{cap['reserved_gb']:.2f} GB ({cap['reserved_added_gb']:.2f} GB added by the trainer "
        f"and its graph) on {card}")
    k_timings(card, INCEPTION_K_CELLS, "inception_times.json")
    say(f"  Inception-v3 phase: {time.perf_counter() - t_start:.0f} s")
    return launches


# ------------------------------------------------------ phase 4b: the mesh
# the mesh cells: ResNet-18 at the main path's global batch of 128, SmaQ
# 6/8 full coverage, int8 gradient payloads (gather, then psum), each at
# K=1 (8 checked steps, then timed ones) and K=8 (one group of 8, checked
# against the K=1 run, then timed replays); bert-base STSB 3 steps; with
# two or more cards the fused FSDP path with packed state the same way, and
# the command line's own spawn of its ranks
MESH_STEPS = 8
MESH_TIMED = {1: 10, 8: 16}


@functools.lru_cache(maxsize=None)
def _rank_mesh(dp, fsdp):
    from smart_quantization_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp, fsdp)


def _digest(trainer, state) -> str:
    """A hash of every parameter this rank holds (the model's, gathered
    from the shards under FSDP)."""
    import hashlib

    trainer._sync_model(state)
    h = hashlib.sha256()
    for _, p in sorted(trainer.model.named_parameters()):
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_rank_cell(argv, dp, fsdp, k, steps, timed, probe):
    """One rank's part of a mesh cell: the trainer the command line builds,
    on a (dp, fsdp) mesh of the pool's NCCL ranks, ``steps`` steps K at a
    time with the launch counts read around them, a digest of the
    parameters, then ``timed`` steps timed; with ``probe`` the steps of
    one more group of K under the profiler (two steps at K=1) and at K=1
    the gradient exchange alone timed with CUDA events."""
    import gc

    import torch

    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.train.metrics import (
        RatioAccumulator,
        merge_compression_metrics,
    )
    from smart_quantization_tpu_torch.utils.config import parse_args

    gc.collect()
    torch.cuda.empty_cache()
    mesh = _rank_mesh(dp, fsdp)
    args = parse_args(argv + ["--steps_per_call", str(k), "--logdir", ""])
    torch.manual_seed(args.seed)
    trainer = build_trainer(args, mesh)
    state = trainer.init_state()
    batches, epoch = [], 0
    while len(batches) < steps + timed:
        for inputs, labels in trainer.data.device_train_batches(epoch, trainer.device):
            batches.append(trainer.prepare_batch(inputs, labels))
        epoch += 1

    def run(group):
        if k > 1:
            return trainer.train_steps(state, group)
        return {n: v[None] for n, v in trainer.train_step(state, *group[0]).items()}

    reset_counts()
    outs = [run(batches[i:i + k]) for i in range(0, steps, k)]
    torch.cuda.synchronize()
    counts = read_counts()
    acc = RatioAccumulator()
    losses = []
    for m in outs:
        host = {n: v.cpu().numpy() for n, v in m.items()}
        for j in range(len(host["train_loss"])):
            losses.append(float(host["train_loss"][j]))
            merge_compression_metrics(acc, {n.split("/", 1)[1]: v[j] for n, v in host.items()
                                            if n.startswith("_ratio/")})
    out = {"losses": losses, "ratio": acc.summary().get("compression_ratio", float("nan")),
           "digest": _digest(trainer, state), "counts": counts,
           "kernels": list(path_kernels(args))}
    times = []
    rest = batches[steps:]
    torch.cuda.reset_peak_memory_stats()
    for i in range(0, timed, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(rest[i:i + k])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / k)
    out["step_ms"] = statistics.median(times) if times else None
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if probe:
        groups = [batches[:1], batches[1:2]] if k == 1 else [batches[:k]]
        out.update(profile_mesh_steps(run, groups, k))
        if k == 1:
            out.update(mesh_exchange_alone(trainer))
    del trainer, state
    return out


def profile_mesh_steps(run, groups, k) -> dict:
    """The groups' steps under the profiler: a step's device time in all
    kernels and in NCCL's (waits for the other ranks included), NCCL's
    kernels by name (launches and ms a step), and the host's kernel launch
    calls and collectives a step, with the host time inside the
    collectives."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smart_quantization_tpu_torch.profile_step import _device_time_us

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for group in groups:
            run(group)
        torch.cuda.synchronize()
    n = len(groups) * k
    # kernels only: ProcessGroupNCCL's "nccl:<op>" ranges show on the
    # device's timeline too, as user annotations as long as their kernel
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_time_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    by_name = sorted(((e.key[:60], e.count / n, _device_time_us(e) / 1e3 / n) for e in nccl),
                     key=lambda t: -t[2])
    host = {e.key: e for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    comms = host.get("record_param_comms")
    return {"nccl_ms": sum(t[2] for t in by_name),
            "busy_ms": sum(_device_time_us(e) for e in kernels) / 1e3 / n,
            "nccl_kernels": by_name[:6],
            "launch_calls": sum(host[c].count for c in ("cudaLaunchKernel", "cudaLaunchKernelExC")
                                if c in host) / n,
            "collectives": comms.count / n if comms else 0.0,
            "collective_host_ms": comms.cpu_time_total / 1e3 / n if comms else 0.0}


def mesh_exchange_alone(trainer) -> dict:
    """The gradient exchange alone on the model's gradient shapes (CUDA
    events, median of 20 after 3 warm-ups; the ranks enter it together)."""
    import torch

    from smart_quantization_tpu_torch.ops.keys import DeviceKey, key_tensor

    gen = torch.Generator(device=trainer.device).manual_seed(3)
    grads = {n: torch.randn(p.shape, generator=gen, device=trainer.device)
             for n, p in trainer.model.named_parameters()}
    key = DeviceKey(key_tensor(11, trainer.device))
    exchange = (trainer._fsdp.exchange_grads if trainer._fsdp is not None
                else trainer._dp.exchange)
    ms = []
    for i in range(23):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        exchange(grads, key)
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            ms.append(start.elapsed_time(end))
    return {"exchange_ms": statistics.median(ms),
            "elements": sum(g.numel() for g in grads.values())}


def mesh_phase(card, single_ms=None) -> dict:
    """The mesh path on W = min(cards, 4) NCCL ranks, one card each (the
    ranks of a ``RankPool``, started once): ResNet-18 with int8 gradient
    payloads in gather and psum mode at K=1 and K=8 (finite losses, the
    overall ratio in 4.5-5.5, K=8 bitwise eight K=1 steps, every rank's
    parameters bitwise equal), bert-base STSB for 3 steps, and with W >= 2
    the fused FSDP path (``--fsdp W --param_gather_bits 8 --packed_momentum
    --packed_weights``) at K=1 and K=8 under the same checks, its
    single-card counterpart timed, and the command line itself
    (``mesh_cli_runs``).  Prints each run's step time, a step's device time
    in all kernels and in NCCL's, the exchange's time alone and the bytes
    it moves a step by the traffic table; returns the launch counts of the
    pool's cells, summed over the ranks."""
    import torch

    from smart_quantization_tpu_torch.parallel.distributed import RankPool
    from smart_quantization_tpu_torch.parallel.train_dp import exchange_bytes

    t_start = time.perf_counter()
    w = min(torch.cuda.device_count(), 4)
    say(f"  W = {w} rank(s), one card each, NCCL (torch.cuda.device_count() = "
        f"{torch.cuda.device_count()})")
    if w == 1:
        say("  --dp 1 is no mesh on the command line: the cells build the trainer with a "
            "one-rank mesh, so the int8 quantize, the NCCL collective (over one rank) and the "
            "dequantize run")
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    launches: dict = {}
    results = {"card": card, "ranks": w, "cells": {}}

    def add(rank_outs, label):
        kernels = rank_outs[0]["kernels"]
        for r, o in enumerate(rank_outs):
            if any(o["counts"].get(name, 0) == 0 for name in kernels):
                fail(f"[{label}] rank {r} launched a kernel of {kernels} no time: {o['counts']}")
            for name in kernels:
                launches[name] = launches.get(name, 0) + o["counts"][name]
        digests = {o["digest"] for o in rank_outs}
        if len(digests) != 1:
            fail(f"[{label}] the ranks' parameters differ after the run")
        if any(o["losses"] != rank_outs[0]["losses"] for o in rank_outs):
            fail(f"[{label}] the ranks' losses differ")
        loss = rank_outs[0]["losses"]
        if not all(math.isfinite(v) for v in loss):
            fail(f"[{label}] non-finite loss: {loss}")

    def k_cells(name, argv, dp, fsdp, traffic_of):
        cell = {}
        for k in (1, 8):
            label = f"mesh resnet18 {name} K={k}"
            outs = pool.run(mesh_rank_cell, argv, dp, fsdp, k, MESH_STEPS, MESH_TIMED[k], True)
            add(outs, label)
            o = outs[0]
            if not 4.5 <= o["ratio"] <= 5.5:
                fail(f"[{label}] overall compression ratio {o['ratio']} outside 4.5-5.5")
            cell[f"K={k}"] = o
            line = (f"  [{label}] {MESH_STEPS} steps, losses {o['losses'][0]!r} .. "
                    f"{o['losses'][-1]!r}, ratio {o['ratio']!r}, ranks bitwise equal; "
                    f"median step {o['step_ms']:.2f} ms")
            if k == 1 and single_ms is not None:
                line += f" (the single-card K=1 step of phase 4: {single_ms:.2f} ms)"
            say(line + f"; a step's device time {o['busy_ms']:.2f} ms, NCCL's kernels "
                f"{o['nccl_ms']:.3f} ms of it, waits for the other ranks included (profiler) "
                f"on {card}")
            say(f"  [{label}] NCCL kernels a step (name, launches, ms): {o['nccl_kernels']}")
            if k == 1:
                per_step = {n: o["counts"][n] / MESH_STEPS for n in o["kernels"]}
                say(f"  [{label}] launches a step on a rank: {per_step}")
                say(f"  [{label}] the exchange alone on ResNet-18's {o['elements']} gradient "
                    f"elements, the ranks entering together: {o['exchange_ms']:.3f} ms (CUDA "
                    f"events); it moves {traffic_of(o['elements']):.0f} B a rank a step by the "
                    f"traffic table on {card}")
        same = (cell["K=1"]["losses"] == cell["K=8"]["losses"]
                and cell["K=1"]["digest"] == cell["K=8"]["digest"])
        say(f"  [mesh resnet18 {name}] K=8 against eight K=1 steps: losses and parameters "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            fail(f"[mesh resnet18 {name}] the K=8 run is not bitwise eight K=1 steps")
        results["cells"][f"resnet18 {name}"] = cell

    pool = RankPool(w, "cuda", timeout_s=600.0)
    try:
        for mode in ("gather", "psum"):
            k_cells(mode, MAIN_ARGV + ["--dp", str(w), "--grad_allreduce_bits", "8",
                                       "--grad_allreduce_mode", mode], w, 1,
                    lambda n, mode=mode: exchange_bytes(n, w, 8, mode))
        label = "mesh bert stsb"
        outs = pool.run(mesh_rank_cell, BERT_ARGV + ["--dp", str(w), "--grad_allreduce_bits", "8"],
                        w, 1, 1, 3, 0, False)
        add(outs, label)
        say(f"  [{label}] 3 steps, losses {outs[0]['losses']!r}, ratio {outs[0]['ratio']!r}, "
            f"ranks bitwise equal on {card}")
        results["cells"]["bert stsb"] = outs[0]
        if w >= 2:
            # the ring model: an int8 gather of the parameters and an int8
            # reduce-scatter of the gradients, (n-1)/n B an element each
            k_cells(f"fsdp {w}", MAIN_ARGV + ["--fsdp", str(w), "--grad_allreduce_bits", "8",
                                              "--param_gather_bits", "8", *PACKED_ARGV],
                    1, w, lambda n: 2 * (w - 1) / w * n)
        else:
            say("  FSDP: not run on the card (--fsdp needs 2 ranks or more and this machine has "
                "one card); the fused FSDP path is held against JAX on gloo only "
                "(tests/test_torch_fsdp.py)")
        fsdp_cell = results["cells"].get(f"resnet18 fsdp {w}", {}).get("K=1")
        whole = whole_batch_cells(pool, w, card, single_ms, fsdp_cell)
        results["cells"]["resnet18 whole batch"] = whole["cell"]
        for name, v in whole["launches"].items():
            launches[name] = launches.get(name, 0) + v
    finally:
        pool.close()
    for cell in results["cells"].values():
        for o in ([cell] if "losses" in cell else cell.values()):
            o.pop("counts", None)
    if w >= 2:
        single = {"packed": time_steps(PACKED_ARGV, check_launches=False)["ms"]}
        if single_ms is None:
            single["smart"] = time_steps([], check_launches=False)["ms"]
        say(f"  single-card K=1 steps of the same command lines without a mesh (ms; packed: "
            f"the FSDP cell's): {single} on {card}")
        results["single_card_k1_ms"] = single
        results["cli"] = mesh_cli_runs(card, w)
    else:
        say("  the command line's own spawn of its ranks (--dp/--fsdp on W cards): left to a "
            "machine of two cards or more (a mesh of one rank is no mesh on the command line)")
    with open(os.path.join(OUT, "mesh_times.json"), "w") as f:
        json.dump(results, f, indent=1)
    say(f"  mesh phase: {time.perf_counter() - t_start:.0f} s")
    return launches


def mesh_cli_runs(card, w) -> dict:
    """``python -m smart_quantization_tpu_torch.train`` as a user runs it on
    W cards: the CLI spawns its W ranks itself (NCCL, one card each).
    ResNet-18 ``--dp W`` with int8 gradients at K=8 for 16 steps and 8
    eval batches of 32 (one eval graph, its rows split over the ranks),
    then ``--fsdp W --param_gather_bits 8`` with packed state at K=1 for 4
    steps and 2 eval batches; each must exit 0 with one ``final:`` line, one metrics log and one
    checkpoint holding its fsdp size and every rank's augmentation state.
    Returns each run's seconds and final metrics."""
    import shutil

    import torch

    runs = {
        f"dp {w} K=8": (["--dp", str(w), "--grad_allreduce_bits", "8", "--steps_per_call", "8",
                         "--log_every", "8"], 16, 8, 1),
        f"fsdp {w}": (["--fsdp", str(w), "--grad_allreduce_bits", "8", "--param_gather_bits",
                       "8", *PACKED_ARGV], 4, 2, w),
    }
    out = {}
    for label, (extra, steps, evals, fsdp_size) in runs.items():
        label = f"cli {label}"
        out_dir = os.path.join(ROOT, "tmp_chip_smoke", label.replace(" ", "_"))
        shutil.rmtree(out_dir, ignore_errors=True)
        cmd = [sys.executable, "-m", "smart_quantization_tpu_torch.train", *MAIN_ARGV, *extra,
               "--limit_train_batches", str(steps), "--limit_val_batches", str(evals),
               "--logdir", out_dir, "--name", "run", "--checkpoint_dir", out_dir]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        except subprocess.TimeoutExpired:
            fail(f"[{label}] did not end within 300 s")
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"[{label}] exited {proc.returncode}: {proc.stderr[-3000:]}")
        finals = [ln for ln in proc.stdout.splitlines() if ln.startswith("final:")]
        logs = [f for f in os.listdir(out_dir) if f.endswith(".metrics.jsonl")]
        ckpts = sorted(f for f in os.listdir(out_dir) if f.endswith(".pt"))
        if len(finals) != 1 or len(logs) != 1 or ckpts != ["epoch_0000.pt"]:
            fail(f"[{label}] {len(finals)} final lines, metrics logs {logs}, checkpoints {ckpts}")
        ck = torch.load(os.path.join(out_dir, ckpts[0]), map_location="cpu", weights_only=True)
        if ck.get("fsdp_size") != fsdp_size or len(ck.get("data_gens") or ()) != w:
            fail(f"[{label}] checkpoint fsdp_size {ck.get('fsdp_size')}, "
                 f"{len(ck.get('data_gens') or ())} ranks' augmentation states (want "
                 f"{fsdp_size} and {w})")
        final = json.loads(finals[0].split(":", 1)[1])
        if not math.isfinite(final.get("val_loss", math.nan)) or not (
                4.5 <= final.get("compression_ratio", 0.0) <= 5.5):
            fail(f"[{label}] final metrics without a finite loss or with a ratio outside "
                 f"4.5-5.5: {final}")
        say(f"  [{label}] exit 0 in {secs:.1f} s (the ranks' start included): one final line, "
            f"one metrics log, one checkpoint (step {ck['step']}, fsdp_size {ck['fsdp_size']}, "
            f"{w} augmentation states); final {finals[0][len('final: '):][:300]} on {card}")
        out[label] = {"seconds": secs, "final": final}
        shutil.rmtree(out_dir, ignore_errors=True)
    return out


# ------------------------------------------- phase 4b: the whole-batch step
# parallel/train_fsdp.py, the XLA-managed float32 FSDP step of the JAX
# package: ResNet-18 at the global batch of 128, SmaQ 6/8 full coverage,
# SGD momentum 0.9, float32; every statistic the whole batch's
WHOLE_STEPS = 4
WHOLE_TIMED = 6
WHOLE_COMPARED = 1
# the cells whose draws are one card's on any mesh (W = 4 against W = 1
# with the same keys under --mesh_only): (label, stochastic, taps,
# --use_sample_stats, packed state); taps off where a flip of a tap would
# travel on through the layers (with full statistics a tap's statistics
# are summed in another order on W ranks), on with sampled statistics,
# which are bitwise one card's on any mesh: there every tap call is held
# bitwise to one card's call on its gathered input (tap_trace_check)
WHOLE_CELLS = (("stochastic, taps off", True, False, False, False),
               ("sampled statistics, stochastic taps", True, True, True, False),
               ("packed state, stochastic, taps off", True, False, False, True))
WHOLE_CELL_TIMED = 2


def whole_batch_plan() -> tuple[int, int]:
    """(smaq_stats, smaq_quantize) launches of a whole-batch ResNet-18
    step: every tap call takes a stats launch for its sums (the small form
    computes its stats inside the quantize block, where no sum comes out),
    the optimizer's calls on whole leaves the stats launch of the split
    form above ``SMALL_MAX``; each of the 282 calls one quantize launch."""
    from smart_quantization_tpu_torch.models.resnet import resnet18
    from smart_quantization_tpu_torch.ops.cuda.smaq_kernel import SMALL_MAX
    from smart_quantization_tpu_torch.optim.compressed import norm_param_mask

    named = [(n, p.numel()) for n, p in resnet18(num_classes=10).named_parameters()]
    exempt = norm_param_mask(n for n, _ in named)
    opt = ([k for _, k in named] * 2 + [k for n, k in named if not exempt[n]])
    taps = 2 * RESNET18_TAPS
    return taps + sum(k > SMALL_MAX for k in opt), taps + len(opt)


def _whole_batch_setup(stochastic, taps, n_batches, sample=False, packed=False):
    """The whole-batch cells' model (ResNet-18, seeded, SmaQ 6/8 on the
    optimizer's structures and with ``taps`` on the feature and gradient
    maps, ``--use_sample_stats`` as ``sample``), optimizer (SGD momentum
    0.9; packed momentum and weights as ``packed``) and seeded global
    batches of 128, on this process's card."""
    import gc

    import torch

    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.inject.tap import TapConfig
    from smart_quantization_tpu_torch.models.resnet import resnet18
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
    )

    gc.collect()
    torch.cuda.empty_cache()
    device = torch.device("cuda", torch.cuda.current_device())
    torch.manual_seed(0)
    comp = build_compressor("smart", stochastic_rounding=stochastic, use_sample_stats=sample)
    model = resnet18(num_classes=10, tap=TapConfig(compressor=comp) if taps else None)
    gen = torch.Generator().manual_seed(5)
    batches = [(torch.randint(0, 256, (128, 32, 32, 3), generator=gen, dtype=torch.uint8)
                .to(device), torch.randint(0, 10, (128,), generator=gen).to(device))
               for _ in range(n_batches)]
    return (model.to(device), build_optimizer("sgd", 0.1, momentum=0.9),
            OptimizerCompression(compressor=comp, packed_momentum=packed, packed_weights=packed),
            batches)


def _whole_batch_run(step, tensors_of, batches, steps, timed, arrays, base=0) -> dict:
    """``steps`` calls ``step(images_u8, labels, key)`` with the launch
    counts read around them, a digest of ``tensors_of()`` (and with
    ``arrays`` the arrays), then ``timed`` calls timed (median ms, peak
    memory, and the memory held after them above ``base``, what was
    allocated before the cell's model was made)."""
    import hashlib

    import torch

    reset_counts()
    metrics = [step(x, y, 1000 + i) for i, (x, y) in enumerate(batches[:steps])]
    torch.cuda.synchronize()
    counts = {k: v / steps for k, v in read_counts().items() if v}
    tensors = tensors_of()
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(tensors[name].detach().float().cpu().numpy().tobytes())
    out = {"losses": [float(m["train_loss"]) for m in metrics], "digest": h.hexdigest(),
           "counts": counts,
           "ratio": float(sum(v[0] for k, v in metrics[-1].items() if k.startswith("_ratio/"))
                          / sum(v[1] for k, v in metrics[-1].items() if k.startswith("_ratio/")))}
    if arrays:
        out["tensors"] = {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}
    del tensors  # gathered and decoded copies: not what the step holds
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, (x, y) in enumerate(batches[steps:]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y, 2000 + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = statistics.median(times) if times else None
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["held_gb"] = (torch.cuda.memory_allocated() - base) / 1e9
    return out


def _state_bytes(*trees) -> tuple[int, int, int]:
    """The bytes of every tensor in the trees (packed leaves' codes and
    statistics included), and the elements and leaves stored as uint8
    codes."""
    import torch

    from smart_quantization_tpu_torch.ops.codebook import SmaQCodes
    from smart_quantization_tpu_torch.optim.compressed import CompressedOptState

    total = [0, 0, 0]

    def walk(t):
        if isinstance(t, SmaQCodes):
            total[1] += t.codes.numel()
            total[2] += 1
        if isinstance(t, torch.Tensor):
            total[0] += t.numel() * t.element_size()
        elif isinstance(t, (dict, SmaQCodes, CompressedOptState)):
            for v in (t.values() if isinstance(t, dict) else t):
                walk(v)

    for t in trees:
        walk(t)
    return tuple(total)


def whole_batch_rank_cell(mesh_shape, stochastic, taps, steps, timed, arrays=False,
                          sample=False, packed=False):
    """ResNet-18's whole-batch step (``make_fsdp_train_step``) on a
    (data, fsdp) mesh of the pool's ranks, or of this process alone at (1,
    1) (``_whole_batch_setup``): ``_whole_batch_run`` over the global
    parameters, momentum (packed leaves decoded) and BatchNorm statistics,
    and with ``timed`` two profiled steps.  With ``arrays`` and ``taps``
    the first step's first tap output (conv1's, bn1's input) on this
    rank's rows as ``probe``."""
    import gc

    import torch

    from smart_quantization_tpu_torch.optim.compressed import _decode_tree, packed_smaq_params
    from smart_quantization_tpu_torch.parallel.train_fsdp import make_fsdp_train_step

    gc.collect()
    base = torch.cuda.memory_allocated()
    model, spec, optim_comp, batches = _whole_batch_setup(stochastic, taps, steps + timed,
                                                          sample, packed)
    fsdp_step = make_fsdp_train_step(model, spec, optim_comp, _rank_mesh(*mesh_shape))
    state = fsdp_step.init_state()
    probe = []
    hook = model.bn1.register_forward_pre_hook(
        lambda m, args: probe.append(args[0].detach().float().cpu().numpy())
        if arrays and taps and not probe else None)

    def tensors():
        trace = fsdp_step.global_opt_state(state)["trace"]
        if packed:
            trace = _decode_tree(trace, packed_smaq_params(optim_comp), False)
        return {**fsdp_step.global_params(state), **dict(model.named_buffers()),
                **{f"momentum/{k}": v for k, v in trace.items()}}

    out = _whole_batch_run(lambda x, y, key: fsdp_step(state, x, y, key), tensors, batches,
                           steps, timed, arrays, base)
    state_bytes, out["code_elements"], out["code_leaves"] = _state_bytes(state.shards,
                                                                          state.opt_state)
    out["state_mb"] = state_bytes / 1e6
    hook.remove()
    if probe:
        out["probe"] = probe[0]
    if timed:
        out.update(profile_mesh_steps(lambda g: fsdp_step(state, *g[0], 3000),
                                      [batches[:1], batches[1:2]], 1))
    del fsdp_step, state, model
    return out


def _tensor_digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _key_copy(key):
    """A key that draws what ``key`` draws next: a step key's call indices,
    or a host generator's state."""
    import torch

    from smart_quantization_tpu_torch.ops.keys import DeviceKey

    if isinstance(key, DeviceKey):
        return DeviceKey(key.key, key._next, key._stop)
    gen = torch.Generator()
    gen.set_state(key.get_state())
    return gen


def trace_taps(step, blocks: int, replay: bool) -> list:
    """Wrap the whole-batch step's ``StatsGroup.compress``, through which
    every tap call goes, forward and backward: each call's log entry holds
    its direction, the input's shape on this rank, the module that ran
    last before a forward call, whether its statistics are sampled (SmaQ
    ``--use_sample_stats`` above ``num_samples`` elements: one card's
    sample on any mesh), and the SHA-256 of its input and output
    on each of ``blocks`` blocks of rows (one: this rank's own).  With
    ``replay`` each call is also made as one device makes it, on the
    whole input gathered from the ranks with a copy of the call's key
    (``StatsGroup()``), and ``apart`` counts the elements of this rank's
    output that differ from its rows of that call, bit for bit.  Returns
    the log, filled by the steps that follow."""
    import torch

    from smart_quantization_tpu_torch.parallel.whole_batch import StatsGroup

    stats, log, where = step.stats, [], {"phase": "forward", "after": None}
    inner = stats.compress

    def seen(name):
        def hook(module, args, out):
            where["after"] = name
        return hook

    for name, m in step.model.named_modules():
        if not list(m.children()):
            m.register_forward_hook(seen(name))
    step.model.register_forward_hook(lambda *a: where.update(phase="backward", after=None))

    def compress(compressor, x, key, *, gamma=None, beta=None):
        copy = _key_copy(key) if replay else None
        y, sizes = inner(compressor, x, key, gamma=gamma, beta=beta)
        p = compressor.params
        entry = {"phase": where["phase"], "shape": tuple(x.shape), "after": where["after"],
                 "sampled": p.use_sample_stats and x.numel() * stats.size > p.num_samples,
                 "in": [_tensor_digest(c) for c in x.chunk(blocks)],
                 "out": [_tensor_digest(c) for c in y.chunk(blocks)]}
        if replay:
            whole = stats.gather(x.contiguous()).reshape(-1, *x.shape[1:])
            one, _ = StatsGroup().compress(compressor, whole, copy, gamma=gamma, beta=beta)
            mine = one.chunk(stats.size)[stats.rank]
            entry["apart"] = int((mine.view(torch.int32) != y.view(torch.int32)).sum())
        log.append(entry)
        if where["phase"] == "backward":
            where["after"] = None
        return y, sizes

    stats.compress = compress
    return log


def conv_rows_apart(model, blocks: int) -> dict:
    """Forward hooks on every convolution of ``model``: the elements of its
    output that its ``blocks`` blocks of rows, each convolved alone as a
    rank convolves its rows, give otherwise, bit for bit; filled by the
    steps that follow."""
    import torch

    apart = {}

    def hook(name):
        def run(m, args, out):
            with torch.no_grad():
                parts = torch.cat([m._conv_forward(c, m.weight, m.bias)
                                   for c in args[0].chunk(blocks)])
            apart[name] = (int((parts.view(torch.int32) != out.view(torch.int32)).sum()),
                           out.numel())
        return run

    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook(name))
    return apart


def whole_batch_trace_cell(mesh_shape, blocks, sample):
    """One step of the tapped stochastic whole-batch cell (``--use_sample_stats``
    as ``sample``) with its first compared key, its tap calls traced
    (``trace_taps``: replayed as one device's above one rank); at (1, 1)
    the tap calls cut into ``blocks`` blocks of rows and every
    convolution's output against its blocks of rows convolved alone
    (``conv_rows_apart``)."""
    from smart_quantization_tpu_torch.parallel.train_fsdp import make_fsdp_train_step

    model, spec, optim_comp, batches = _whole_batch_setup(True, True, 1, sample)
    fsdp_step = make_fsdp_train_step(model, spec, optim_comp, _rank_mesh(*mesh_shape))
    state = fsdp_step.init_state()
    one = mesh_shape == (1, 1)
    log = trace_taps(fsdp_step, blocks if one else 1, not one)
    convs = conv_rows_apart(model, blocks) if one else None
    x, y = batches[0]
    fsdp_step(state, x, y, 1000)
    del fsdp_step, state, model
    return {"log": log, "convs": convs}


def trainer_reference_cell(stochastic, taps, steps, timed, arrays=False):
    """The port's single-card step, ``Trainer.train_step``, on the whole-batch
    cell's model, optimizer and batches, each batch's input the whole-batch
    step's (``train_fsdp.global_inputs`` of its key): ``_whole_batch_run``
    over the same tensors."""
    from smart_quantization_tpu_torch.parallel.train_fsdp import global_inputs
    from smart_quantization_tpu_torch.train.loop import TrainConfig, Trainer

    model, spec, optim_comp, batches = _whole_batch_setup(stochastic, taps, steps + timed)
    trainer = Trainer(model, None, spec, optim_comp=optim_comp, device=model.fc.weight.device,
                      config=TrainConfig(measure_compression_ratio=True))
    state = trainer.init_state()

    def tensors():
        return {**dict(model.named_parameters()), **dict(model.named_buffers()),
                **{f"momentum/{k}": v for k, v in state.opt_state["trace"].items()}}

    def step(x, y, key):
        return trainer.train_step(state, global_inputs(x, key), y)

    out = _whole_batch_run(step, tensors, batches, steps, timed, arrays)
    if timed:
        out.update(profile_mesh_steps(lambda g: step(*g[0], 3000), [batches[:1], batches[1:2]], 1))
    del trainer, state, model
    return out


def flip_rule(got: dict, want: dict, label: str, strict: bool = True) -> tuple[float, float]:
    """``tests/test_torch_parallel.py``'s rule for a leaf after the
    optimizer's truncation SmaQ: at most 1 % of the elements beyond float32's
    wiggle (1e-4 of the leaf's largest value), none more than one
    main-bucket quantum (its std / 15) apart; ``strict=False`` measures
    without failing.  Returns the largest share apart and the largest
    difference in quanta."""
    import numpy as np

    worst, quanta = 0.0, 0.0
    for name, b in want.items():
        a = np.asarray(got[name], np.float64)
        b = np.asarray(b, np.float64)
        diff = np.abs(a - b)
        wiggle = 1e-4 * np.abs(b).max() + 1e-6
        share = float((diff > wiggle).mean())
        worst = max(worst, share)
        quanta = max(quanta, float(diff.max() / max(np.std(b) / 15, 1e-30)))
        if strict and (not np.isfinite(a).all() or share > 0.01
                       or diff.max() > np.std(b) / 15 * (1 + 1e-4) + wiggle):
            fail(f"[{label}] {name}: {share:.4%} of the elements apart, the largest "
                 f"{diff.max()!r} (a quantum {np.std(b) / 15!r})")
    return worst, quanta


def whole_batch_cells(pool, w, card, single_ms, fsdp_cell) -> dict:
    """The whole-batch step on the pool's W ranks (a (1, W) mesh): its
    launches a step against the plan, every rank's parameters, momentum,
    BatchNorm statistics and losses bitwise equal, and one step with the
    optimizer's truncation SmaQ (taps off) against the single-card
    trainer's step (``Trainer.train_step``) on the same batch by the flip
    rule: its BatchNorm normalizes through ``var_mean`` and its loss is a
    mean, where the whole-batch step folds float64 sums (all-reduced from
    W = 2) and sums its rows' losses.  Prints the step's median time, peak
    memory, a step's device time in all kernels and in NCCL's, beside the
    single-card trainer's step with the same taps and, at W >= 2, the fused
    FSDP cell's.  Returns the launches summed over the ranks."""
    import numpy as np

    plan_stats, plan_quant = whole_batch_plan()
    outs = pool.run(whole_batch_rank_cell, (1, w), True, True, WHOLE_STEPS, WHOLE_TIMED)
    o = outs[0]
    label = f"whole-batch resnet18 W={w}"
    for r, ro in enumerate(outs):
        per = (ro["counts"].get("smaq_stats", 0), ro["counts"].get("smaq_quantize", 0))
        if per != (plan_stats, plan_quant):
            fail(f"[{label}] rank {r} launched {per} smaq_stats + smaq_quantize a step, the "
                 f"plan {plan_stats} + {plan_quant}: {ro['counts']}")
    if len({ro["digest"] for ro in outs}) != 1 or any(ro["losses"] != o["losses"] for ro in outs):
        fail(f"[{label}] the ranks' parameters, momentum, BatchNorm statistics or losses differ")
    if not all(math.isfinite(v) for v in o["losses"]) or not 4.5 <= o["ratio"] <= 5.5:
        fail(f"[{label}] losses {o['losses']}, ratio {o['ratio']}")
    say(f"  [{label}] {WHOLE_STEPS} steps, losses {o['losses'][0]!r} .. {o['losses'][-1]!r}, "
        f"ratio {o['ratio']!r}, launches a step {plan_stats} smaq_stats + {plan_quant} "
        f"smaq_quantize (the plan: every tap call's sums from smaq_stats), ranks bitwise equal")
    # taps off: a tap's truncation flip travels on through the layers (the
    # tapped steps are held to the trainer's on the CPU, at TinyCNN's size:
    # tests/test_torch_train_fsdp.py; the tap path's kernels in phase 3)
    trunc = pool.run(whole_batch_rank_cell, (1, w), False, False, WHOLE_COMPARED, 0, True)
    ref = trainer_reference_cell(False, False, WHOLE_COMPARED, 0, True)
    one = trainer_reference_cell(True, True, 1, WHOLE_TIMED)
    if len({t["digest"] for t in trunc}) != 1:
        fail(f"[{label}] truncation: the ranks' parameters differ")
    got, want = trunc[0]["tensors"], ref["tensors"]
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        if not np.allclose(got[k], want[k], rtol=1e-5, atol=1e-6):
            fail(f"[{label}] BatchNorm statistics {k} differ from the trainer's")
    leaves = [k for k in want if k not in stats and "batches" not in k]
    moved = flip_rule({k: got[k] for k in leaves}, {k: want[k] for k in leaves},
                      f"{label} truncation")[0]
    same = sum(np.array_equal(got[k], want[k]) for k in leaves)
    rel = abs(trunc[0]["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    if rel > 1e-5:
        fail(f"[{label}] truncation loss {trunc[0]['losses']} against the trainer's "
             f"{ref['losses']}")
    say(f"  [{label}] the optimizer's truncation SmaQ, taps off, one step against the "
        f"single-card trainer's (Trainer.train_step; var_mean BatchNorm, mean loss): loss "
        f"within {rel:.2e}, BatchNorm statistics within 1e-5, parameters and momentum by the "
        f"flip rule ({moved:.4%} of a leaf apart at most; {same} of {len(leaves)} leaves "
        f"bitwise)")
    line = (f"  [{label}] median step {o['step_ms']:.2f} ms, peak memory {o['peak_gb']:.2f} GB "
            f"a rank, a step's device time {o['busy_ms']:.2f} ms, NCCL's kernels "
            f"{o['nccl_ms']:.3f} ms of it (profiler, waits included), host: "
            f"{o['launch_calls']:.0f} kernel launch calls and {o['collectives']:.0f} "
            f"collectives a step, {o['collective_host_ms']:.2f} ms inside the collectives; the "
            f"single-card trainer's step, the same taps: {one['step_ms']:.2f} ms, peak "
            f"{one['peak_gb']:.2f} GB, device time {one['busy_ms']:.2f} ms, "
            f"{one['launch_calls']:.0f} launch calls, SmaQ launches a step {one['counts']}")
    if single_ms is not None:
        line += f"; phase 4's single-card CLI step {single_ms:.2f} ms"
    if fsdp_cell is not None:
        line += (f"; the fused FSDP cell (packed state, int8 exchanges) K=1 "
                 f"{fsdp_cell['step_ms']:.2f} ms, peak {fsdp_cell['peak_gb']:.2f} GB a rank")
    say(line + f" on {card}")
    o["single_card"] = {k: one[k] for k in ("step_ms", "peak_gb", "counts", "busy_ms",
                                            "launch_calls")}
    launches = {}
    for ro in outs:
        for k, v in ro.pop("counts").items():
            launches[k] = launches.get(k, 0) + int(round(v * WHOLE_STEPS))
    o["cells"] = {}
    for name, stochastic, taps, sample, packed in WHOLE_CELLS:
        cell, got = whole_batch_draw_cell(pool, w, card, name, stochastic, taps, sample, packed)
        o["cells"][name] = cell
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    plain, packed = o["cells"][WHOLE_CELLS[0][0]], o["cells"][WHOLE_CELLS[2][0]]
    expected = plain["state_mb"] - (3 * packed["code_elements"] - 8 * packed["code_leaves"]) / 1e6
    if packed["state_mb"] >= plain["state_mb"] or packed["held_gb"] >= plain["held_gb"]:
        fail(f"[{label}] packed state holds {packed['held_gb']!r} GB a rank (its state "
             f"{packed['state_mb']!r} MB), float32 state {plain['held_gb']!r} GB "
             f"({plain['state_mb']!r} MB)")
    say(f"  [{label}] packed state against float32 state, both stochastic with taps off: held "
        f"between steps {packed['held_gb'] * 1e3:.1f} MB a rank against "
        f"{plain['held_gb'] * 1e3:.1f} MB, above what the process held before each cell; the "
        f"state's own tensors {packed['state_mb']:.2f} MB against {plain['state_mb']:.2f} MB "
        f"(uint8 codes for {packed['code_elements']} elements of {packed['code_leaves']} "
        f"leaves, 8 bytes of statistics each: {expected:.2f} MB expected)")
    return {"cell": o, "launches": launches}


def tap_trace_check(pool, w, label, sample) -> tuple[str, dict]:
    """The tapped cell's first compared step traced (``whole_batch_trace_cell``)
    at W ranks and at (1, 1): fails unless every tap call takes sampled
    statistics and, forward and backward, on every rank is bitwise one
    card's call on the input
    gathered from the ranks with the same key, and unless every call whose
    input is bitwise the (1, 1) step's has its output bitwise too.  Returns
    the text of its line (the calls, how many took the (1, 1) step's input
    bitwise, the first that did not, and the convolutions whose blocks of
    rows, convolved alone, differ from the whole batch's) and its
    summary."""
    ranks = [r["log"] for r in pool.run(whole_batch_trace_cell, (1, w), w, sample)]
    one = whole_batch_trace_cell((1, 1), w, sample)
    ref = one["log"]
    if any(len(log) != len(ref) for log in ranks):
        fail(f"[{label}] the ranks made {[len(log) for log in ranks]} tap calls, the (1, 1) "
             f"step {len(ref)}")
    if not all(e["sampled"] for e in ref):
        fail(f"[{label}] {sum(not e['sampled'] for e in ref)} tap calls take full statistics, "
             f"which W ranks fold in another order than one card: not a bitwise rule")
    apart = [sum(log[i]["apart"] for log in ranks) for i in range(len(ref))]
    if any(apart):
        i = next(i for i, a in enumerate(apart) if a)
        fail(f"[{label}] tap call {i} ({ref[i]['phase']}, {ranks[0][i]['shape']} a rank): "
             f"{apart[i]} elements of the ranks' outputs differ from one card's call on the "
             f"gathered input with the same key; {sum(a > 0 for a in apart)} calls apart")
    same_in = [all(log[i]["in"][0] == ref[i]["in"][r] for r, log in enumerate(ranks))
               for i in range(len(ref))]
    for i, same in enumerate(same_in):
        if same and any(log[i]["out"][0] != ref[i]["out"][r] for r, log in enumerate(ranks)):
            fail(f"[{label}] tap call {i} ({ref[i]['phase']}): its input bitwise the (1, 1) "
                 f"step's, its output not")
    first = next((i for i, same in enumerate(same_in) if not same), None)
    convs = {k: v for k, v in one["convs"].items() if v[0]}
    summary = {"calls": len(ref), "forward": sum(e["phase"] == "forward" for e in ref),
               "input_bitwise": sum(same_in), "first_apart": None, "convs_apart": convs,
               "convs": len(one["convs"])}
    text = (f"; its {len(ref)} tap calls ({summary['forward']} forward) each bitwise, on every "
            f"rank, one card's call on the input gathered from the ranks with the same key "
            f"(replayed), {sum(same_in)} of them with an input bitwise the (1, 1) step's and "
            f"each of those with its output bitwise")
    if first is not None:
        e = ref[first]
        summary["first_apart"] = {"call": first, "phase": e["phase"], "after": e["after"],
                                  "shape": ranks[0][first]["shape"]}
        text += (f"; the first input apart: call {first} ({e['phase']}, "
                 f"{ranks[0][first]['shape']} a rank"
                 + (f", after {e['after']}" if e["after"] else "") + ")")
    text += (f"; convolutions whose {w} blocks of rows, each convolved alone, differ bit for "
             f"bit from the whole batch's: {len(convs)} of {len(one['convs'])}"
             + "".join(f", {k} {a} of {n} elements" for k, (a, n) in list(convs.items())[:3]))
    return text, summary


def whole_batch_draw_cell(pool, w, card, name, stochastic, taps, sample, packed):
    """One of WHOLE_CELLS on the pool's W ranks (a (1, W) mesh): every
    rank's parameters, momentum, BatchNorm statistics and losses bitwise
    equal, finite losses and a ratio in 4.5-5.5 (packed state: its
    optimizer's 8 bits an element), and at W >= 2 the first step against
    the (1, 1) step in this process with the same key: its loss within
    1e-5, the BatchNorm statistics within 1e-5, and taps off the
    parameters and momentum by the flip rule; with taps the first tap's
    output (conv1's, every rank's rows) by the flip rule at FLIP_FRACTION,
    every tap call bitwise one card's on its gathered input
    (``tap_trace_check``), and the parameters and momentum measured only:
    the ranks' convolutions and reductions over their rows sum in other
    orders than one card's over the whole batch, and a tap's flip from
    that travels on through 20 layers and their gradients (PERF.md,
    section 6).  Prints its launches a step, median step, peak and held
    memory a rank, its state's bytes, device time and host launch calls.
    Returns the cell and its launches summed over the ranks."""
    import numpy as np

    label = f"whole-batch resnet18 W={w} {name}"
    outs = pool.run(whole_batch_rank_cell, (1, w), stochastic, taps, WHOLE_COMPARED,
                    WHOLE_CELL_TIMED, w > 1, sample, packed)
    o = outs[0]
    if len({ro["digest"] for ro in outs}) != 1 or any(ro["losses"] != o["losses"] for ro in outs):
        fail(f"[{label}] the ranks' parameters, momentum, BatchNorm statistics or losses differ")
    lo, hi = (3.9, 5.5) if packed else (4.5, 5.5)
    if not all(math.isfinite(v) for v in o["losses"]) or not lo <= o["ratio"] <= hi:
        fail(f"[{label}] losses {o['losses']}, ratio {o['ratio']}")
    compared = ""
    if w > 1:
        one = whole_batch_rank_cell((1, 1), stochastic, taps, WHOLE_COMPARED, 0, True,
                                    sample, packed)
        got, want = o.pop("tensors"), one["tensors"]
        for ro in outs[1:]:
            ro.pop("tensors", None)
        stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
        for k in stats:
            if not np.allclose(got[k], want[k], rtol=1e-5, atol=1e-6):
                fail(f"[{label}] BatchNorm statistics {k} differ from the (1, 1) step's")
        leaves = [k for k in want if k not in stats and "batches" not in k]
        moved, quanta = flip_rule({k: got[k] for k in leaves}, {k: want[k] for k in leaves},
                                  label, strict=not taps)
        same = sum(np.array_equal(got[k], want[k]) for k in leaves)
        rel = abs(o["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        if rel > 1e-5:
            fail(f"[{label}] loss {o['losses']} against the (1, 1) step's {one['losses']}")
        compared = (f"; one step against the (1, 1) step in one process with the same key: "
                    f"loss within {rel:.2e}, parameters and momentum "
                    f"{'by the flip rule' if not taps else 'measured'} ({moved:.4%} of a leaf "
                    f"apart at most, {quanta:.3f} quanta; {same} of {len(leaves)} leaves "
                    f"bitwise)")
        if taps:
            mesh_probe = np.concatenate([ro.pop("probe") for ro in outs])
            ref = one["probe"]
            diff = np.abs(mesh_probe - ref)
            apart = int((diff > 1e-5 + 2.5e-7 * np.abs(ref)).sum())
            step = np.std(ref) / 15
            if apart > FLIP_FRACTION * ref.size or diff.max() > step * (1 + 1e-4) + 1e-6:
                fail(f"[{label}] the first tap's output: {apart} of {ref.size} elements apart, "
                     f"the largest {diff.max()!r} (a quantum {step!r})")
            compared += (f"; the first tap's output (conv1's, {ref.size} elements) "
                         f"{apart} elements apart, {int((diff == 0).sum())} bitwise")
            text, o["trace"] = tap_trace_check(pool, w, label, sample)
            compared += text
    counts = {k: v for k, v in o["counts"].items()}
    say(f"  [{label}] ranks bitwise equal, loss {o['losses'][0]!r}, ratio {o['ratio']!r}, "
        f"launches a step {counts}{compared}")
    say(f"  [{label}] median step {o['step_ms']:.2f} ms, peak {o['peak_gb']:.2f} GB and held "
        f"between steps {o['held_gb'] * 1e3:.1f} MB a rank above the process's before the "
        f"cell (its state {o['state_mb']:.1f} MB), a step's device time {o['busy_ms']:.2f} "
        f"ms (NCCL {o['nccl_ms']:.3f}), {o['launch_calls']:.0f} kernel launch calls and "
        f"{o['collectives']:.0f} collectives a step on {card}")
    launches = {}
    for ro in outs:
        for k, v in ro.pop("counts").items():
            launches[k] = launches.get(k, 0) + int(round(v * WHOLE_COMPARED))
    return o, launches


def run_drivers() -> None:
    """Two of the experiment drivers on the card, as ``python -m`` runs
    them (their ``main`` in this process): ``memory_footprint`` (ResNet-18,
    Adam, per-shard bytes at fsdp 4, ``torch.cuda.memory_allocated``
    beside the tensor bytes) and a tiny ``bert_nan_probe`` (one warm-up
    and one fine-tune epoch of the tiny config); each prints its JSON
    line."""
    from smart_quantization_tpu_torch.experiments import bert_nan_probe, memory_footprint

    t0 = time.perf_counter()
    say("  experiments/memory_footprint --model resnet18 --opt adam --fsdp 4:")
    mem = memory_footprint.main(["--model", "resnet18", "--opt", "adam", "--fsdp", "4"])
    if mem["cuda_allocated_fp32_state_bytes"] < mem["fp32_state_bytes"]:
        fail(f"[memory_footprint] the card holds less than the float32 state's tensors: {mem}")
    say("  experiments/bert_nan_probe (tiny config, 1 + 1 epochs):")
    probe = bert_nan_probe.main(["--fp32_warmup_epochs", "1", "--epochs", "1", "--train_n",
                                 "256", "--val_n", "64", "--batch_size", "64"])
    if not probe["params_finite"]:
        fail(f"[bert_nan_probe] non-finite parameters: {probe}")
    say(f"  drivers: {time.perf_counter() - t0:.0f} s")


# ---------------------------------------------------------------- phase 5
def make_timer(device):
    """``timed(fn)``: the median of 25 CUDA-event timings of ``fn`` after one
    warm-up call, with 512 MB written before each: that evicts the 50 MB L2
    and keeps the queue about 0.2 ms ahead of the host, so the events time
    the kernels and not the launch (PR 2's timer).  ``per_call(fn, reps)``: ``fn``
    ``reps`` times in a CUDA graph, timed as above and divided by ``reps``:
    a call's device time in a stream of calls, gaps between kernels
    included, host excluded."""
    import torch

    flush = torch.empty(128 * 2**20, dtype=torch.float32, device=device)
    capture = torch.cuda.Stream(device)

    def timed(fn, runs=25):
        fn()
        out = []
        for _ in range(runs):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    def per_call(fn, reps=20):
        capture.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(capture):
            fn()  # the capture stream's first call allocates its workspace
        torch.cuda.current_stream(device).wait_stream(capture)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            for _ in range(reps):
                fn()
        return timed(graph.replay, runs=10) / reps

    return timed, per_call


def time_kernels(device, timed):
    import torch

    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.float_format import (
        BF16_FORMAT,
        FP8_FORMAT,
        FP16_FORMAT,
        float_quantize,
    )
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    params = SmaQParams()
    gen = torch.Generator(device=device).manual_seed(2)
    host = torch.Generator().manual_seed(3)
    dkey = call_key(device, 3)
    tkey = timing_key(device)  # made once: a fill inside a timed call would count
    x = torch.randn(ACT_SHAPE, generator=gen, device=device).reshape(-1)
    n = x.numel()
    consts = K.smaq_stats(x, params)
    mean, std = K.pivot_stats_reference(x, params)
    s2_consts = S.s2fp8_stats(x)
    xb = x.view(BN_SHAPE)
    channels = BN_SHAPE[1]
    gamma = torch.randn(channels, generator=gen, device=device) * 0.3 + 1.0
    beta = torch.randn(channels, generator=gen, device=device) * 0.2
    y = torch.empty_like(x)

    def fq(fmt, stochastic):
        return lambda: F.float_quantize_launch(x, fmt, key=tkey, stochastic=stochastic, check_inf=True)

    t = {
        "smaq_stats": timed(lambda: K.smaq_stats(x, params)),
        "smaq_quantize": timed(lambda: K.smaq_quantize(x, params, key=tkey, consts=consts)),
        "smaq_call": timed(lambda: K.smaq_fused(x, dkey, params)),
        "plain_stats": timed(lambda: K.pivot_stats_reference(x, params)),
        "plain_quantize": timed(lambda: K.smaq_fused_reference(x, host, params, mean=mean, std=std)),
        "plain_call": timed(lambda: K.smaq_fused_reference(x, host, params)),
        "float_quantize": timed(fq(FP8_FORMAT, True)),
        "float_fp8_nearest": timed(fq(FP8_FORMAT, False)),
        "float_fp16_nearest": timed(fq(FP16_FORMAT, False)),
        "float_bf16_nearest": timed(fq(BF16_FORMAT, False)),
        "plain_float": timed(lambda: float_quantize(x, FP8_FORMAT, host, stochastic=True)),
        "plain_float_nearest": timed(lambda: float_quantize(x, FP8_FORMAT, stochastic=False)),
        "library_fp8": timed(lambda: x.to(torch.float8_e5m2).float()),
        "library_fp16": timed(lambda: x.half().float()),
        "library_bf16": timed(lambda: x.bfloat16().float()),
        "s2fp8_stats": timed(lambda: S.s2fp8_stats(x)),
        "s2fp8_quantize": timed(lambda: S.s2fp8_quantize(
            x, s2_consts, key=tkey, stochastic=True, check_inf=True)),
        "s2fp8_pair": timed(lambda: S.s2fp8_fused(x, dkey)),
        "plain_s2fp8_stats": timed(lambda: S.stats_reference(x)),
        "plain_s2fp8": timed(lambda: S.s2fp8_fused_reference(x, host)),
        "smaq_quantize_bn": timed(lambda: K.smaq_quantize_bn(
            x, gamma, beta, channels, n // (BN_SHAPE[0] * channels), params,
            key=tkey, consts=consts)),
        "plain_bn": timed(lambda: K.smaq_fused_bn_reference(
            xb, host, gamma, beta, params, mean=mean, std=std)),
        # yardsticks that move the same bytes: a read, and a read and a write
        "torch_sum": timed(lambda: x.sum()),
        "torch_copy": timed(lambda: y.copy_(x)),
    }
    rate = HBM_BYTES_PER_S / 1e3  # bytes per ms
    # each input read once, each output written once
    bound = {
        "smaq_stats": 4 * n / rate,
        "smaq_quantize": 8 * n / rate,
        "smaq_call": 8 * n / rate,
        "float_quantize": 8 * n / rate,
        "s2fp8_stats": 4 * n / rate,
        "s2fp8_quantize": 8 * n / rate,
        "s2fp8_pair": 8 * n / rate,
        "smaq_quantize_bn": (8 * n + 8 * channels) / rate,
    }
    for k in ("float_fp8_nearest", "float_fp16_nearest", "float_bf16_nearest"):
        bound[k] = bound["float_quantize"]
    return t, bound, n


def time_offsets(device, timed, card) -> dict:
    """Each stochastic quantize kernel at 8 388 608 elements at element
    offset 0 and at offset 2 (every group of four across two of the
    whole's Philox groups: two Philox calls a group), timed 0, 2, 2, 0 in
    one process; printed and written to ``chiprun_out/offset_times.json``.
    Returns the medians in ms, ``{kernel: {offset: ms}}``."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.float_format import FP8_FORMAT
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    params = SmaQParams()
    gen = torch.Generator(device=device).manual_seed(6)
    tkey = timing_key(device)
    x = torch.randn(ACT_SHAPE, generator=gen, device=device).reshape(-1)
    xb = x.to(torch.bfloat16)
    channels = BN_SHAPE[1]
    inner = x.numel() // (BN_SHAPE[0] * channels)
    gamma = torch.randn(channels, generator=gen, device=device) * 0.3 + 1.0
    beta = torch.randn(channels, generator=gen, device=device) * 0.2
    calls = {}
    for t, tag in ((x, ""), (xb, "_bf16")):
        consts = K.smaq_stats(t, params)
        s2 = S.s2fp8_stats(t).clone()
        calls.update({
            "smaq_quantize" + tag: lambda o, t=t, c=consts: K.smaq_quantize(
                t, params, key=tkey, offset=o, consts=c),
            "smaq_quantize_bn" + tag: lambda o, t=t, c=consts: K.smaq_quantize_bn(
                t, gamma, beta, channels, inner, params, key=tkey, offset=o, consts=c),
            "float_quantize" + tag: lambda o, t=t: F.float_quantize_launch(
                t, FP8_FORMAT, key=tkey, offset=o, stochastic=True, check_inf=True),
            "s2fp8_quantize" + tag: lambda o, t=t, c=s2: S.s2fp8_quantize(
                t, c, key=tkey, offset=o, stochastic=True, check_inf=True, window=False),
        })
        if tag:
            calls["s2fp8_quantize_window_bf16"] = lambda o, c=s2: S.s2fp8_quantize(
                xb, c, key=tkey, offset=o, stochastic=True, check_inf=True, window=True)
            calls["smaq_onepass_bf16"] = lambda o: K.smaq_onepass(xb, params, key=tkey, offset=o)
    out = {}
    for name, fn in calls.items():
        got = {0: [], 2: []}
        for o in (0, 2, 2, 0):
            got[o].append(timed(lambda fn=fn, o=o: fn(o)))
        out[name] = {o: statistics.mean(v) for o, v in got.items()}
    say("  the element offset: each stochastic quantize kernel at offset 0 and at offset 2 "
        "(two Philox calls a group), us: " + ", ".join(
            f"{k} {v[0] * 1e3:.1f} / {v[2] * 1e3:.1f}" for k, v in out.items()) + f" on {card}")
    with open(os.path.join(OUT, "offset_times.json"), "w") as f:
        json.dump({"card": card, "ms": out}, f, indent=1)
    return out


def time_bf16_kernels(device, timed):
    """Phase 5 for the bfloat16 forms at 8 388 608 elements: each kernel,
    its plain version on the bf16 input, and the path they replace (the
    float32 form between a cast in and a cast out); the bound is 4 bytes an
    element for a call (2 read, 2 written), 2 for a stats pass.  Returns
    (times, bounds) in ms, keyed by the ``_bf16`` names."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.float_format import (
        BF16_FORMAT,
        FP8_FORMAT,
        FP16_FORMAT,
        float_quantize,
    )
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    bf = torch.bfloat16
    params = SmaQParams()
    gen = torch.Generator(device=device).manual_seed(4)
    host = torch.Generator().manual_seed(5)
    dkey = call_key(device, 5)
    tkey = timing_key(device)
    xb = torch.randn(ACT_SHAPE, generator=gen, device=device).reshape(-1).to(bf)
    n = xb.numel()
    consts = K.smaq_stats(xb, params)
    mean, std = K.read_consts(consts)
    s2_consts = S.s2fp8_stats(xb).clone()
    channels = BN_SHAPE[1]
    gamma = torch.randn(channels, generator=gen, device=device) * 0.3 + 1.0
    beta = torch.randn(channels, generator=gen, device=device) * 0.2

    def fq(fmt, stochastic, x=xb):
        return lambda: F.float_quantize_launch(x, fmt, key=tkey, stochastic=stochastic,
                                               check_inf=True)

    yb = torch.empty_like(xb)
    t = {
        "smaq_onepass_bf16": timed(lambda: K.smaq_onepass(xb, params, key=tkey)),
        "smaq_stats_bf16": timed(lambda: K.smaq_stats(xb, params)),
        "smaq_quantize_bf16": timed(lambda: K.smaq_quantize(xb, params, key=tkey, consts=consts)),
        "smaq_call_bf16": timed(lambda: K.smaq_fused(xb, dkey, params)),
        "smaq_call_cast": timed(lambda: K.smaq_fused(xb.float(), dkey, params)[0].to(bf)),
        "plain_stats_bf16": timed(lambda: K.pivot_stats_reference(xb.float(), params)),
        "plain_quantize_bf16": timed(lambda: K.smaq_fused_reference(
            xb, host, params, mean=mean, std=std)),
        "plain_call_bf16": timed(lambda: K.smaq_fused_reference(xb, host, params)),
        "float_quantize_bf16": timed(fq(FP8_FORMAT, True)),
        "float_quantize_cast": timed(lambda: fq(FP8_FORMAT, True, xb.float())().to(bf)),
        "float_fp8_nearest_bf16": timed(fq(FP8_FORMAT, False)),
        "float_fp16_nearest_bf16": timed(fq(FP16_FORMAT, False)),
        "float_bf16_nearest_bf16": timed(fq(BF16_FORMAT, False)),
        "plain_float_bf16": timed(lambda: float_quantize(xb, FP8_FORMAT, host).to(bf)),
        "library_fp8_bf16": timed(lambda: xb.to(torch.float8_e5m2).to(bf)),
        "library_fp16_bf16": timed(lambda: xb.half().to(bf)),
        # the float32 kernels' bf16 instances and the table kernels, each
        # at this size (the call takes the table kernels here)
        "s2fp8_stats_bf16": timed(lambda: S.s2fp8_stats(xb, table=False)),
        "s2fp8_quantize_bf16": timed(lambda: S.s2fp8_quantize(
            xb, s2_consts, key=tkey, stochastic=True, check_inf=True, window=False)),
        "s2fp8_stats_table_bf16": timed(lambda: S.s2fp8_stats(xb, table=True)),
        "s2fp8_quantize_window_bf16": timed(lambda: S.s2fp8_quantize(
            xb, s2_consts, key=tkey, stochastic=True, check_inf=True, window=True)),
        "s2fp8_pair_bf16": timed(lambda: S.s2fp8_fused(xb, dkey)),
        "s2fp8_pair_cast": timed(lambda: S.s2fp8_fused(xb.float(), dkey).to(bf)),
        "plain_s2fp8_stats_bf16": timed(lambda: S.stats_reference(xb.float())),
        "plain_s2fp8_bf16": timed(lambda: S.s2fp8_fused_reference(xb, host)),
        "smaq_quantize_bn_bf16": timed(lambda: K.smaq_quantize_bn(
            xb, gamma, beta, channels, n // (BN_SHAPE[0] * channels), params,
            key=tkey, consts=consts)),
        "smaq_quantize_bn_cast": timed(lambda: K.smaq_quantize_bn(
            xb.float(), gamma, beta, channels, n // (BN_SHAPE[0] * channels), params,
            key=tkey, consts=consts)[0].to(bf)),
        "plain_bn_bf16": timed(lambda: K.smaq_fused_bn_reference(
            xb.view(BN_SHAPE), host, gamma, beta, params, mean=mean, std=std)),
        # yardsticks that move the same bytes: a read, and a read and a write
        "torch_sum_bf16": timed(lambda: xb.sum()),
        "torch_copy_bf16": timed(lambda: yb.copy_(xb)),
    }
    rate = HBM_BYTES_PER_S / 1e3  # bytes per ms
    bound = {k: 4 * n / rate for k in t if not k.startswith(("plain", "library", "torch"))}
    bound["smaq_stats_bf16"] = bound["s2fp8_stats_bf16"] = 2 * n / rate
    bound["s2fp8_stats_table_bf16"] = 2 * n / rate
    bound["smaq_quantize_bn_bf16"] = (4 * n + 8 * channels) / rate
    bound["smaq_quantize_bn_cast"] = bound["smaq_quantize_bn_bf16"]
    return t, bound


CALL_SIZES = (8_388_608, 2_097_152, 147_456, 36_864, 8192, 512, 64)


def time_fill(device, timed):
    """The Philox fill of the largest dropout mask (bert-base's attention
    probabilities, FILL_SIZES' last) in uniforms, its plain version and
    ``torch.rand`` of the same size (a yardstick only: another generator's
    bits, not the same function); the bound is the 4 bytes an element
    written.  Returns (times, bound, n) in ms."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import philox_kernel as P

    n = FILL_SIZES[-1][1]
    key = timing_key(device)
    gen = torch.Generator(device=device).manual_seed(1)
    t = {
        "philox_fill": timed(lambda: P.philox_fill(n, key, 3, uniform=True)),
        "plain_fill": timed(lambda: P.philox_fill_reference(n, key, 3, uniform=True), runs=5),
        "torch_rand": timed(lambda: torch.rand(n, generator=gen, device=device)),
    }
    return t, 4 * n / (HBM_BYTES_PER_S / 1e3), n


def time_smaq(device, timed, per_call, step_calls_of, card):
    """Phase 5's SmaQ lines; returns them as a dict.  ``step_calls_of``
    maps a model's name to one training step's encoder calls."""
    tkey = timing_key(device)  # made once: a fill inside a timed call would count
    import ctypes

    import torch

    from smart_quantization_tpu_torch.ops.cuda import build
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    params, trunc = SmaQParams(), SmaQParams(stochastic_rounding=False)
    dkey = call_key(device, 5)
    largest = max(n for calls in step_calls_of.values() for n, _ in calls)
    x = torch.randn(max(largest, math.prod(ACT_SHAPE)), device=device,
                    generator=torch.Generator(device=device).manual_seed(4))
    x8m = x[:math.prod(ACT_SHAPE)]
    rate = HBM_BYTES_PER_S / 1e3  # bytes per ms
    sms = K.sm_count(device)
    out = {"card": card}

    def call(n):
        xn = x[:n]
        return lambda: K.smaq_fused(xn, dkey, params)

    # in a CUDA graph: a lone multi-launch call's events also catch the
    # host's delays between its launches
    say("  the SmaQ call (smaq_fused, stochastic, size counted) by size, in a stream "
        "of 20:")
    out["call_us"] = {}
    for n in CALL_SIZES:
        stream = per_call(call(n))
        b = 8 * n / rate
        out["call_us"][n] = stream * 1e3
        say(f"    {n}: {stream * 1e3:.2f} us ({K.smaq_plan(n, sms)[0]} form); bound "
            f"{b * 1e3:.3f} us (8 B/element), {b / stream:.1%} of it")

    consts = K.smaq_stats(x8m, params)
    q = {name: timed(lambda p=p: K.smaq_quantize(x8m, p, key=tkey, consts=consts)) * 1e3
         for name, p in (("trunc", trunc), ("stochastic", params))}
    out["quantize_us"] = q
    say(f"  smaq_quantize at {x8m.numel()}: truncation {q['trunc']:.2f} us, "
        f"stochastic {q['stochastic']:.2f} us")

    # each step's SmaQ calls (the BN kernel's aside; those under min_size
    # pass through) in one CUDA graph
    out["per_step_ms"], out["per_step_bound_ms"], out["per_step_calls"] = {}, {}, {}
    for model, calls in step_calls_of.items():
        sizes = [n for n, form in calls if form == "plain" and n >= params.min_size]
        step_fns = [call(n) for n in sizes]
        per_step = per_call(lambda: [f() for f in step_fns], reps=1)
        step_bound = sum(8 * n for n in sizes) / rate
        # the host's time to enqueue the same calls (no graph): what a step's
        # encoder calls cost the host before any tap or optimizer Python
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for f in step_fns:
                f()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize(device)
        enqueue_ms = statistics.median(enqueue)
        out["per_step_ms"][model], out["per_step_bound_ms"][model] = per_step, step_bound
        out["per_step_calls"][model] = len(sizes)
        out.setdefault("per_step_enqueue_ms", {})[model] = enqueue_ms
        out.setdefault("step_sizes", {})[model] = sizes
        say(f"  SmaQ kernels per {model} step, its {len(sizes)} calls in one CUDA graph: "
            f"{per_step:.3f} ms, bound {step_bound:.3f} ms (8 B/element), "
            f"{step_bound / per_step:.1%} of it; the host enqueues them in {enqueue_ms:.3f} ms "
            f"({enqueue_ms / len(sizes) * 1e3:.1f} us a call)")

    lib = build.library()
    out["blocks_per_sm"] = {}
    for kernel, label, threads, smem in ((0, "smaq_stats", 256, 0),
                                         (1, "smaq_quantize", 256, 0),
                                         (1, "smaq_quantize small form", K.SMALL_THREADS, 0),
                                         (2, "smaq_quantize_bn (64 channels)", 256, 64 * 16)):
        c = ctypes.c_int(0)
        rc = lib.smaq_occupancy(kernel, threads, smem, ctypes.addressof(c))
        if rc:
            fail(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: {rc}")
        out["blocks_per_sm"][label] = c.value
        say(f"  {label}: {c.value} blocks of {threads} threads resident per SM")
    if out["blocks_per_sm"]["smaq_quantize"] < K.BLOCKS_PER_SM or \
            out["blocks_per_sm"]["smaq_stats"] < K.BLOCKS_PER_SM:
        fail(f"a SmaQ kernel fits fewer than the planned {K.BLOCKS_PER_SM} blocks per SM")
    with open(os.path.join(OUT, "smaq_times.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def bf16_call_times(device, timed, per_call, step_calls_of, s2fp8_maps=(), bn_taps=()) -> dict:
    """The bfloat16 forms through the port's public calls only
    (``smaq_fused``, ``float_quantize_fused``, ``s2fp8_fused``,
    ``smaq_fused_bn``), so that it times any tree of the port the same way:
    the SmaQ call (stochastic, size counted) at 8 388 608 elements alone and
    in truncation, by size in a stream of 20 (a CUDA graph);
    ``float_quantize`` at 8 388 608 elements (FP8 stochastic, FP8/FP16/BF16
    nearest); for each model in ``step_calls_of`` (its calls as
    ``step_calls`` gives them) the SmaQ calls of one step (the ``plain``
    ones of ``--min_size`` or more, in their element form) in one CUDA
    graph, and with FP8 the ``float_quantize`` calls of the same step in one
    graph; the S2FP8 call (stochastic) at 8 388 608 elements alone and by
    size in a stream of 20, and ``s2fp8_maps`` (``model_s2fp8_maps``: the
    tensors the bf16 S2FP8 cell's calls take in a training step, by step)
    in one graph a step; the BN call at BN_SHAPE (stochastic,
    and in truncation) and ``bn_taps`` (``model_bn_taps``: a bf16
    ``--use_batch_norm`` step's BN calls) in one graph; and, so that two
    trees' float32 forms compare in one call, the float32 SmaQ call,
    float_quantize, the S2FP8 call and the BN call at the same sizes, with
    digests of S2FP8's and BN's outputs in both element types (truncation,
    and stochastic from fixed keys).  Times in µs, a step's in ms."""
    import hashlib

    import torch

    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.float_format import (
        BF16_FORMAT,
        FP8_FORMAT,
        FP16_FORMAT,
    )
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    params, trunc = SmaQParams(), SmaQParams(stochastic_rounding=False)
    dkey = call_key(device, 8)
    largest = max([math.prod(ACT_SHAPE)] + [n for calls in step_calls_of.values()
                                            for n, _ in calls])
    xw = torch.randn(largest, device=device,
                     generator=torch.Generator(device=device).manual_seed(12))
    xb = xw.to(torch.bfloat16)
    x8 = xb[:math.prod(ACT_SHAPE)]
    out = {
        "smaq_call_us": timed(lambda: K.smaq_fused(x8, dkey, params)) * 1e3,
        "smaq_call_trunc_us": timed(lambda: K.smaq_fused(x8, None, trunc)) * 1e3,
        "smaq_call_stream_us": {
            n: per_call((lambda xn: lambda: K.smaq_fused(xn, dkey, params))(xb[:n])) * 1e3
            for n in CALL_SIZES},
        "float_us": {
            name: timed((lambda fmt, st: lambda: F.float_quantize_fused(
                x8, fmt, dkey if st else None, stochastic=st))(fmt, st)) * 1e3
            for name, fmt, st in (("fp8 stochastic", FP8_FORMAT, True),
                                  ("fp8 nearest", FP8_FORMAT, False),
                                  ("fp16 nearest", FP16_FORMAT, False),
                                  ("bf16 nearest", BF16_FORMAT, False))},
        "step_smaq_ms": {}, "step_smaq_calls": {}, "step_float_ms": {},
    }
    xw8 = xw[:math.prod(ACT_SHAPE)]
    out["float32_us"] = {
        "smaq call": timed(lambda: K.smaq_fused(xw8, dkey, params)) * 1e3,
        "float_quantize fp8 stochastic": timed(
            lambda: F.float_quantize_fused(xw8, FP8_FORMAT, dkey)) * 1e3,
        "float_quantize fp8 nearest": timed(
            lambda: F.float_quantize_fused(xw8, FP8_FORMAT, None, stochastic=False)) * 1e3}
    for model, calls in step_calls_of.items():
        src = [(xb if form.endswith(BF16_FORM) else xw)[:n] for n, form in calls
               if form.removesuffix(BF16_FORM) == "plain" and n >= params.min_size]
        smaq = [(lambda xn: lambda: K.smaq_fused(xn, dkey, params))(xn) for xn in src]
        out["step_smaq_ms"][model] = per_call(lambda: [f() for f in smaq], reps=1)
        out["step_smaq_calls"][model] = len(smaq)
        if model.startswith("ResNet"):
            fp8 = [(lambda xn: lambda: F.float_quantize_fused(xn, FP8_FORMAT, dkey))(
                (xb if form.endswith(BF16_FORM) else xw)[:n]) for n, form in calls]
            out["step_float_ms"][model] = per_call(lambda: [f() for f in fp8], reps=1)

    # S2FP8 and BN
    def s2fp8(xn):
        return lambda: S.s2fp8_fused(xn, dkey)

    out["s2fp8_pair_us"] = timed(s2fp8(x8)) * 1e3
    out["s2fp8_pair_nearest_us"] = timed(lambda: S.s2fp8_fused(x8, None, stochastic=False)) * 1e3
    out["s2fp8_stream_us"] = {n: per_call(s2fp8(xb[:n])) * 1e3 for n in CALL_SIZES}
    if s2fp8_maps:
        out["step_s2fp8_ms"], out["step_s2fp8_calls"] = {}, {}
        for k, maps in s2fp8_maps.items():
            step = [s2fp8(t) for t in maps]
            out["step_s2fp8_ms"][k] = per_call(lambda: [f() for f in step], reps=1)
            out["step_s2fp8_calls"][k] = len(step)
    nbn = math.prod(BN_SHAPE)
    gen = torch.Generator(device=device).manual_seed(14)
    gamma = torch.randn(BN_SHAPE[1], generator=gen, device=device) * 0.3 + 1.0
    beta = torch.randn(BN_SHAPE[1], generator=gen, device=device) * 0.2
    xbn, xwn = xb[:nbn].view(BN_SHAPE), xw[:nbn].view(BN_SHAPE)
    out["bn_call_us"] = timed(lambda: K.smaq_fused_bn(xbn, dkey, gamma, beta, params)) * 1e3
    out["bn_call_trunc_us"] = timed(lambda: K.smaq_fused_bn(xbn, None, gamma, beta, trunc)) * 1e3
    if bn_taps:
        affine = {c: (torch.randn(c, generator=gen, device=device) * 0.3 + 1.0,
                      torch.randn(c, generator=gen, device=device) * 0.2)
                  for c in {c for _, c in bn_taps if c}}
        affine[0] = (gamma.mean(), beta.mean())  # a scalar pair
        step = [(lambda xn, gb: lambda: K.smaq_fused_bn(xn, dkey, *gb, params))(
            xb[:math.prod(shape)].view(shape), affine[c]) for shape, c in bn_taps]
        out["step_bn_ms"] = per_call(lambda: [f() for f in step], reps=1)
        out["step_bn_calls"] = len(step)
    out["float32_us"]["s2fp8 pair"] = timed(s2fp8(xw8)) * 1e3
    out["float32_us"]["bn call"] = timed(lambda: K.smaq_fused_bn(xwn, dkey, gamma, beta,
                                                                 params)) * 1e3

    def digest(y):
        y = y[0] if isinstance(y, tuple) else y
        return hashlib.sha256(y.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]

    def host(seed):
        return torch.Generator().manual_seed(seed)

    out["output_sha256"] = {
        "s2fp8 float32 nearest": digest(S.s2fp8_fused(xw8, None, stochastic=False)),
        "s2fp8 float32 stochastic": digest(S.s2fp8_fused(xw8, host(9))),
        "s2fp8 bf16 nearest": digest(S.s2fp8_fused(x8, None, stochastic=False)),
        "s2fp8 bf16 stochastic": digest(S.s2fp8_fused(x8, host(9))),
        "bn float32 trunc": digest(K.smaq_fused_bn(xwn, None, gamma, beta, trunc)),
        "bn float32 stochastic": digest(K.smaq_fused_bn(xwn, host(10), gamma, beta, params)),
        "bn float32 scalar stochastic": digest(K.smaq_fused_bn(
            xwn, host(11), gamma.mean(), beta.mean(), params)),
        "bn bf16 trunc": digest(K.smaq_fused_bn(xbn, None, gamma, beta, trunc)),
        "bn bf16 stochastic": digest(K.smaq_fused_bn(xbn, host(10), gamma, beta, params)),
    }
    return out


def time_bf16_redesign(device, timed, per_call, step_calls_of, card, s2fp8_maps=(),
                       bn_taps=()) -> dict:
    """Phase 5's lines for the redesigned bfloat16 forms: the public calls
    of ``bf16_call_times`` beside their 4 bytes an element (SmaQ,
    float_quantize, S2FP8 and BN, a step's calls of each in one graph), the
    one-launch SmaQ kernel alone in stochastic and truncation modes, the
    float32 calls at the same sizes for the same call's comparison, the
    output digests, and the blocks each new kernel has resident on an SM at
    its shared memory, and ``window_share`` of ``s2fp8_maps``; into
    ``bf16_redesign_times.json`` in OUT."""
    import ctypes

    import torch

    from smart_quantization_tpu_torch.ops.cuda import build
    from smart_quantization_tpu_torch.ops.cuda import float_kernel as F
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.cuda.launch import THREADS
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    rate = HBM_BYTES_PER_S / 1e3  # bytes per ms
    params, trunc = SmaQParams(), SmaQParams(stochastic_rounding=False)
    tkey = timing_key(device)
    out = {"card": card, **bf16_call_times(device, timed, per_call, step_calls_of, s2fp8_maps,
                                           bn_taps)}
    n8 = math.prod(ACT_SHAPE)
    b8 = 4 * n8 / rate * 1e3
    x8 = torch.randn(n8, device=device, generator=torch.Generator(device=device).manual_seed(13))
    xb8 = x8.to(torch.bfloat16)
    out["onepass_us"] = {
        "stochastic": timed(lambda: K.smaq_onepass(xb8, params, key=tkey)) * 1e3,
        "trunc": timed(lambda: K.smaq_onepass(xb8, trunc, key=None)) * 1e3}
    say(f"  bf16 SmaQ call (smaq_fused, stochastic) at {n8}: {out['smaq_call_us']:.2f} us, "
        f"truncation {out['smaq_call_trunc_us']:.2f} us; smaq_onepass alone stochastic "
        f"{out['onepass_us']['stochastic']:.2f} us, truncation {out['onepass_us']['trunc']:.2f} "
        f"us; bound {b8:.2f} us (4 B/element), {b8 / out['smaq_call_us']:.1%} of it, on {card}")
    say("  the bf16 SmaQ call by size, in a stream of 20:")
    sms, slots = K.sm_count(device), K.onepass_slots(device)
    for n, us in out["smaq_call_stream_us"].items():
        b = 4 * n / rate * 1e3
        say(f"    {n}: {us:.2f} us ({K.smaq_plan(n, sms, slots)[0]} form); bound {b:.3f} us "
            f"(4 B/element), {b / us:.1%} of it")
    for name, us in out["float_us"].items():
        say(f"  float_quantize bf16 {name} at {n8}: {us:.2f} us, bound {b8:.2f} us, "
            f"{b8 / us:.1%} of it, on {card}")
    for model, ms in out["step_smaq_ms"].items():
        say(f"  {model} step's SmaQ calls ({out['step_smaq_calls'][model]}: the bf16 maps' and "
            f"the float32 leaves') in one CUDA graph: {ms:.3f} ms on {card}")
    for model, ms in out["step_float_ms"].items():
        say(f"  {model} step's float_quantize calls under FP8 in one CUDA graph: {ms:.3f} ms "
            f"on {card}")
    lib = build.library()
    c, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    if lib.smaq_occupancy(3, THREADS, 0, ctypes.addressof(c)) or lib.smaq_onepass_smem(
            K.BLOCKS_PER_SM, THREADS, ctypes.addressof(smem)):
        fail("the occupancy or shared-memory query failed for smaq_onepass")
    out["blocks_per_sm"] = {"smaq_onepass by registers": c.value,
                            "float_quantize bf16": F.bf16_resident(device)}
    out["onepass_smem_bytes"] = smem.value
    say(f"  smaq_onepass: {c.value} blocks of {THREADS} resident per SM by registers, "
        f"{K.BLOCKS_PER_SM} with {smem.value} B of shared memory each (the SM's shared memory "
        f"split {K.BLOCKS_PER_SM} ways: {slots} slots a thread; phase 3: one slot more is "
        f"refused); float_quantize bf16: {out['blocks_per_sm']['float_quantize bf16']} blocks of "
        f"{THREADS} per SM")
    if c.value < K.BLOCKS_PER_SM or smem.value < slots * THREADS * K.SLOT_BYTES:
        fail(f"smaq_onepass fits fewer than the planned {K.BLOCKS_PER_SM} blocks per SM")
    say(f"  bf16 S2FP8 call (s2fp8_fused, stochastic) at {n8}: {out['s2fp8_pair_us']:.2f} us, "
        f"nearest {out['s2fp8_pair_nearest_us']:.2f} us; bound {b8:.2f} us (4 B/element), "
        f"{b8 / out['s2fp8_pair_us']:.1%} of it; float32 {out['float32_us']['s2fp8 pair']:.2f} us; "
        f"on {card}")
    say("  the bf16 S2FP8 call by size, in a stream of 20:")
    for n, us in out["s2fp8_stream_us"].items():
        b = 4 * n / rate * 1e3
        say(f"    {n}: {us:.2f} us ({S.s2fp8_plan(n, sms)[0]} form); bound {b:.3f} us "
            f"(4 B/element), {b / us:.1%} of it")
    nbn = math.prod(BN_SHAPE)
    bbn = (4 * nbn + 8 * BN_SHAPE[1]) / rate * 1e3
    say(f"  bf16 BN call (smaq_fused_bn, stochastic) at {BN_SHAPE}: {out['bn_call_us']:.2f} us, "
        f"truncation {out['bn_call_trunc_us']:.2f} us; bound {bbn:.2f} us (4 B/element), "
        f"{bbn / out['bn_call_us']:.1%} of it; float32 {out['float32_us']['bn call']:.2f} us; "
        f"on {card}")
    out["window_share"] = {}
    for k, ms in out.get("step_s2fp8_ms", {}).items():
        say(f"  bf16 S2FP8 ResNet-18 training step {k}'s S2FP8 calls "
            f"({out['step_s2fp8_calls'][k]}: its bf16 maps' and float32 leaves' real tensors) in "
            f"one CUDA graph: {ms:.3f} ms on {card}")
        w = out["window_share"][k] = window_share(s2fp8_maps[k], sms)
        say(f"    s2fp8_quantize_window on its {w['tensors']} bf16 tensors of "
            f"{w['elements']} elements: {w['off_share']:.6%} of the elements off the window "
            f"(maps {w['maps_off_share']:.6%}, gradients {w['grads_off_share']:.6%}), "
            f"{w['warp_share']:.4%} of the 256-element warp steps take the full expression; "
            f"the worst tensor {w['worst']}")
    if "step_bn_ms" in out:
        say(f"  bf16 --use_batch_norm ResNet-18 step's BN calls ({out['step_bn_calls']}) in one "
            f"CUDA graph: {out['step_bn_ms']:.3f} ms on {card}")
    say(f"  output digests (float32 forms: the parent's tree gives the same): "
        f"{out['output_sha256']}")
    q, st, b = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    if lib.s2fp8_occupancy(2, 1, 1, S.BF16_THREADS, ctypes.addressof(q)) or lib.s2fp8_occupancy(
            3, 0, 0, THREADS, ctypes.addressof(st)) or lib.smaq_occupancy(
            4, THREADS, BN_SHAPE[1] * 16, ctypes.addressof(b)):
        fail("the occupancy query failed for the bf16 S2FP8 table kernels or the BN kernel")
    out["blocks_per_sm"].update({"s2fp8_quantize_window": q.value, "s2fp8_stats_table": st.value,
                                 "smaq_quantize_bn bf16": b.value})
    say(f"  s2fp8_quantize_window: {q.value} block of {S.BF16_THREADS} resident per SM; "
        f"s2fp8_stats_table: {st.value} blocks of {THREADS}; smaq_quantize_bn bf16 "
        f"({BN_SHAPE[1]} channels): {b.value} blocks of {THREADS}")
    if q.value < 1 or st.value < K.BLOCKS_PER_SM or b.value < K.BLOCKS_PER_SM:
        fail("a bf16 S2FP8 table kernel or the BN kernel fits fewer blocks per SM than planned")
    with open(os.path.join(OUT, "bf16_redesign_times.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def times_of(root: str) -> int:
    """``--times_of DIR``: build the port in DIR and print, as one JSON
    line, phase 5's time of every kernel at 8 388 608 elements, float32
    (``time_kernels``) and bf16 (``time_bf16_kernels``), in us, its S2FP8
    call (``s2fp8_call_times``: by size, and a ResNet-18 step's calls in
    one CUDA graph) and its bf16 forms' calls (``bf16_call_times``: a bf16
    ResNet-18 step's, a bert-base codecs bf16 step's, a bf16 S2FP8 step's
    and a bf16 BN step's).  Run parent, change, change, parent in one
    call to hold a change against its parent on one card."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from smart_quantization_tpu_torch.ops.cuda import build
    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    build.library()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    timed, per_call = make_timer(device)
    t, _, _ = time_kernels(device, timed)
    t.update(time_bf16_kernels(device, timed)[0])
    trainer = build_trainer(parse_args(MAIN_ARGV + ["--compress", "s2fp8", "--logdir", ""]))
    s2fp8 = s2fp8_call_times(device, timed, per_call,
                             step_calls(trainer, (torch.zeros(128, 3, 32, 32, device=device),)))
    del trainer
    calls = {"ResNet-18 bf16": model_step_calls(MAIN_ARGV + BF16_ARGV),
             "bert-base codecs bf16": model_step_calls(BERT_ARGV + CODEC_ARGV + BF16_ARGV)}
    bf16 = bf16_call_times(device, timed, per_call, calls, *bf16_s2fp8_bn_steps())
    say(json.dumps({"tree": os.path.abspath(root), "card": card_line(),
                    "us": {k: round(v * 1e3, 2) for k, v in t.items()}, "s2fp8": s2fp8,
                    "bf16": bf16}))
    return 0


def bf16_s2fp8_bn_steps():
    """A bf16 S2FP8 ResNet-18 step's encoder inputs (``model_s2fp8_maps``)
    and a bf16 ``--use_batch_norm`` step's BN calls (``model_bn_taps``)."""
    return (model_s2fp8_maps(MAIN_ARGV + BF16_ARGV + ["--compress", "s2fp8"]),
            model_bn_taps(MAIN_ARGV + BF16_ARGV + ["--use_batch_norm"]))


# the training steps whose S2FP8 inputs model_s2fp8_maps keeps: the first,
# from the seeded weights, and the third, whose gradients already span more
# binades (S2FP8 at full coverage turns the loss NaN within a few steps, on
# the TPU as well: BF16_PATHS)
S2FP8_MAPS_STEPS = (1, 3)


def model_s2fp8_maps(argv, steps=S2FP8_MAPS_STEPS) -> dict:
    """The tensors the S2FP8 encoder takes in each of the training steps
    ``steps`` (counted from 1) of the trainer that ``argv`` builds, copied
    as they come (the bf16 feature maps, then their gradients, then the
    float32 gradients, weights and momentum), on its data and weights from
    the seed; by step."""
    import gc

    import torch

    from smart_quantization_tpu_torch.compress import encoders
    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    torch.manual_seed(0)
    trainer = build_trainer(parse_args(argv + ["--logdir", ""]))
    state = trainer.init_state()
    batches = iter(trainer.data.device_train_batches(0, trainer.device))
    real, seen = encoders.s2fp8_fused_or_reference, {}

    def record(x, gen, **kw):
        seen[k].append(x.detach().clone())
        return real(x, gen, **kw)

    encoders.s2fp8_fused_or_reference = record
    try:
        for k in range(1, max(steps) + 1):
            inputs, labels = next(batches)
            x = trainer.task.prepare_train(inputs, trainer.data_gen)
            seen[k] = []
            trainer.train_step(state, x, labels)
            if k not in steps:
                del seen[k]
    finally:
        encoders.s2fp8_fused_or_reference = real
    torch.cuda.synchronize()
    if not all(seen.values()):
        fail("no S2FP8 call in a training step: the encoder's call site moved")
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return seen


def window_share(tensors, sms) -> dict:
    """How much of ``tensors`` (a step's S2FP8 inputs) ``s2fp8_quantize_window``
    takes by its full expression on a card of ``sms`` SMs: for each bf16
    tensor of BF16_WINDOW_MIN elements or more, the nonzero elements off
    their block's window of WINDOW_BINADES binades, placed as
    csrc/s2fp8.cu places it (at the binade of the stats' max; where that
    max is 0, from the block's first chunks, BF16_THREADS x
    BF16_LOAD_ELEMS elements: at their largest nonzero exponent, or
    WINDOW_ABOVE_MEAN above their mean where that is lower), and the
    256-element warp steps (32 lanes of 8 consecutive elements) that hold
    one; by count, over all such tensors, the maps (the first half of the
    bf16 calls) and their gradients apart.  Each tensor's histogram of its
    elements' binades below its largest goes into the JSON, so that
    another placement can be weighed without a run."""
    import torch

    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S

    bf = [t for t in tensors if t.dtype == torch.bfloat16]
    half = len(bf) // 2
    span = S.BF16_THREADS * S.BF16_LOAD_ELEMS  # a block's first chunks
    rows, tot = [], {"all": [0, 0], "maps": [0, 0], "grads": [0, 0]}
    warps = [0, 0]
    for i, t in enumerate(bf):
        n = t.numel()
        if n < S.BF16_WINDOW_MIN:
            continue
        flat = t.reshape(-1)
        idx = flat.view(torch.int16).long() & 0x7FFF
        nz = (idx != 0) & ((idx >> 7) != 255)
        exps = torch.where(nz, idx >> 7, 0)
        blocks = S.window_blocks(n, sms)
        whole = (n // S.BF16_LOAD_ELEMS) * S.BF16_LOAD_ELEMS  # the chunks' elements
        ns = min(blocks * span, whole)
        pad = blocks * span - ns
        se = torch.cat([exps[:ns], exps.new_zeros(pad)]).view(blocks, span)
        sn = torch.cat([nz[:ns], nz.new_zeros(pad)]).view(blocks, span)
        cnt = sn.sum(1)
        mean = (se.sum(1) + cnt // 2) // cnt.clamp(min=1)
        m = float(S.read_consts(S.s2fp8_stats(flat))["m"])
        m_c = -200.0 if math.isnan(m) else min(max(m, -200.0), 200.0)  # fminf(fmaxf(m, ..))
        top = torch.where((cnt > 0) & (m == 0.0),
                          torch.minimum(se.max(1).values, mean + S.WINDOW_ABOVE_MEAN),
                          math.floor(m_c) + 127).clamp(S.WINDOW_BINADES - 1, 254)
        base = (top - S.WINDOW_BINADES + 1) << 7
        pos = torch.arange(n, device=t.device)
        eb = base[(pos // span) % blocks]
        off = (idx != 0) & ((idx < eb) | (idx >= eb + S.WINDOW_BINADES * 128) | (pos >= whole))
        k = int(off.sum())
        w = int(torch.cat([off, off.new_zeros((-n) % 256)]).view(-1, 256).any(1).sum())
        below = (int(exps.max()) - exps[nz]).clamp(0, 63)
        rows.append({"n": n, "kind": "map" if i < half else "gradient", "m": m,
                     "nonfinite": int((~torch.isfinite(flat)).sum()), "off": k,
                     "warp_steps": -(-n // 256), "warp_steps_off": w,
                     "binades_below_largest": torch.bincount(below, minlength=64).tolist()})
        for kind in ("all", "maps" if i < half else "grads"):
            tot[kind][0] += k
            tot[kind][1] += n
        warps[0] += w
        warps[1] += -(-n // 256)
    worst = max(rows, key=lambda r: r["off"] / r["n"], default=None)
    return {"tensors": len(rows), "elements": tot["all"][1],
            "off_share": tot["all"][0] / max(tot["all"][1], 1),
            "maps_off_share": tot["maps"][0] / max(tot["maps"][1], 1),
            "grads_off_share": tot["grads"][0] / max(tot["grads"][1], 1),
            "warp_share": warps[0] / max(warps[1], 1),
            "worst": None if worst is None else {
                k: worst[k] for k in ("n", "kind", "m", "off", "warp_steps_off")},
            "per_tensor": rows}


def model_bn_taps(argv) -> list[tuple[tuple[int, ...], int]]:
    """The calls the BN kernel takes in one training step of the trainer
    that ``argv`` builds: each BatchNorm tap's forward, as (the map's shape,
    its gamma's size; 0 for a scalar pair), read off one forward pass on a
    batch of its data with the taps recording instead of compressing."""
    import gc

    import torch

    from smart_quantization_tpu_torch.compress.base import SizeStats
    from smart_quantization_tpu_torch.inject import tap
    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    torch.manual_seed(0)
    trainer = build_trainer(parse_args(argv + ["--logdir", ""]))
    inputs, _ = next(iter(trainer.data.device_train_batches(0, trainer.device)))
    taps = []

    def record(x, gen, compressor, *, gamma=None, **_):
        if gamma is not None:
            taps.append((tuple(x.shape), gamma.numel() if gamma.dim() else 0))
        return x, SizeStats.of(x.numel(), 32, 32, x.device)

    real = tap.compression_tap
    tap.compression_tap = record
    try:
        trainer.model.eval()
        with torch.no_grad():
            trainer.model(*trainer.task.model_args(trainer.task.prepare_eval(inputs)),
                          tap.TapContext(torch.Generator()))
    finally:
        tap.compression_tap = real
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return taps


def model_step_calls(argv) -> list[tuple[int, str]]:
    """``step_calls`` of the trainer that ``argv`` builds, on a batch of its
    data."""
    import gc

    import torch

    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    torch.manual_seed(0)
    trainer = build_trainer(parse_args(argv + ["--logdir", ""]))
    inputs, _ = next(iter(trainer.data.device_train_batches(0, trainer.device)))
    calls = step_calls(trainer, trainer.task.model_args(trainer.task.prepare_eval(inputs)))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return calls


def s2fp8_call_times(device, timed, per_call, calls) -> dict:
    """The S2FP8 call (``s2fp8_fused``, stochastic) alone at 8 388 608
    elements, by size in a stream of 20 (CUDA graph), and ``calls``' sizes
    (a ResNet-18 step's) in one CUDA graph, and a digest of its output at
    8 388 608 elements in both modes (the stochastic one from a fixed
    seed); through the port's public call only, so it times and digests
    any tree of the port the same way."""
    import hashlib

    import torch

    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S

    dkey = call_key(device, 6)
    x = torch.randn(math.prod(ACT_SHAPE), device=device,
                    generator=torch.Generator(device=device).manual_seed(7))

    def call(n):
        xn = x[:n]
        return lambda: S.s2fp8_fused(xn, dkey)

    def digest(gen):
        y = S.s2fp8_fused(x, gen, stochastic=gen is not None)
        return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]

    step_fns = [call(n) for n, _ in calls]
    return {
        "output_sha256": {"nearest": digest(None),
                          "stochastic": digest(torch.Generator().manual_seed(9))},
        "pair_alone_us": timed(call(x.numel())) * 1e3,
        "call_us": {n: per_call(call(n)) * 1e3 for n in CALL_SIZES},
        "per_step_ms": per_call(lambda: [f() for f in step_fns], reps=1),
        "per_step_bound_ms": sum(8 * n for n, _ in calls) / (HBM_BYTES_PER_S / 1e3),
        "per_step_calls": len(calls),
    }


def time_s2fp8(device, timed, per_call, calls, card):
    """Phase 5's S2FP8 lines; returns them as a dict."""
    import ctypes

    import torch

    from smart_quantization_tpu_torch.ops.cuda import build
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.cuda.launch import (
        BLOCKS_PER_SM,
        THREADS,
        raise_on,
        sm_count,
    )

    tkey = timing_key(device)  # made once: a fill inside a timed call would count
    rate = HBM_BYTES_PER_S / 1e3  # bytes per ms
    sms = sm_count(device)
    out = {"card": card, **s2fp8_call_times(device, timed, per_call, calls)}
    say("  the S2FP8 call (s2fp8_fused, stochastic) by size, in a stream of 20:")
    for n, us in out["call_us"].items():
        b = 8 * n / rate * 1e3
        say(f"    {n}: {us:.2f} us ({S.s2fp8_plan(n, sms)[0]} form); bound {b:.3f} us "
            f"(8 B/element), {b / us:.1%} of it")
    say(f"  the call alone at 8388608: {out['pair_alone_us']:.2f} us; output digests "
        f"{out['output_sha256']}")

    lib = build.library()
    x = torch.randn(math.prod(ACT_SHAPE), device=device,
                    generator=torch.Generator(device=device).manual_seed(8))
    out["forms_us"] = {}
    for n in (S.SMALL_MAX, 8192):
        xn = x[:n]
        yn = torch.empty_like(xn)

        # the small form through the C entry point: the wrapper refuses it
        # above SMALL_MAX
        def small(xn=xn, yn=yn, n=n):
            raise_on(lib.s2fp8_quantize(xn.data_ptr(), yn.data_ptr(), n, 0, None,
                                        tkey.data_ptr(), 0, 0, 1, 1, 1, S.SMALL_THREADS,
                                        torch.cuda.current_stream(device).cuda_stream),
                     "s2fp8_quantize")

        def split(xn=xn):
            S.s2fp8_quantize(xn, S.s2fp8_stats(xn), key=tkey, stochastic=True, check_inf=True)

        forms = {"small": per_call(small) * 1e3, "split": per_call(split) * 1e3}
        out["forms_us"][n] = forms
        say(f"  both forms at {n}, in a stream of 20: small {forms['small']:.2f} us, "
            f"split {forms['split']:.2f} us ({S.s2fp8_plan(n, sms)[0]} form planned)")

    consts = S.s2fp8_stats(x)
    q = {name: timed(lambda s=s: S.s2fp8_quantize(x, consts, key=tkey, stochastic=s,
                                                  check_inf=True)) * 1e3
         for name, s in (("nearest", False), ("stochastic", True))}
    out["quantize_us"] = q
    say(f"  s2fp8_quantize at {x.numel()}: nearest {q['nearest']:.2f} us, "
        f"stochastic {q['stochastic']:.2f} us")
    say(f"  S2FP8 kernels per ResNet-18 step, its {out['per_step_calls']} calls in one CUDA "
        f"graph: {out['per_step_ms']:.3f} ms, bound {out['per_step_bound_ms']:.3f} ms "
        f"(8 B/element), {out['per_step_bound_ms'] / out['per_step_ms']:.1%} of it")

    out["blocks_per_sm"] = {}
    for kernel, label, threads, stoch, ci in (
            (0, "s2fp8_stats", THREADS, 0, 0),
            (1, "s2fp8_quantize stochastic", THREADS, 1, 1),
            (1, "s2fp8_quantize nearest", THREADS, 0, 1),
            (1, "s2fp8_quantize small form stochastic", S.SMALL_THREADS, 1, 1)):
        c = ctypes.c_int(0)
        rc = lib.s2fp8_occupancy(kernel, stoch, ci, threads, ctypes.addressof(c))
        if rc:
            fail(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: {rc}")
        out["blocks_per_sm"][label] = c.value
        say(f"  {label}: {c.value} blocks of {threads} threads resident per SM")
    if min(v for k, v in out["blocks_per_sm"].items() if "small" not in k) < BLOCKS_PER_SM:
        fail(f"an S2FP8 kernel fits fewer than the planned {BLOCKS_PER_SM} blocks per SM")
    with open(os.path.join(OUT, "s2fp8_times.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main() -> int:
    # cuBLAS reads this at its first call: before torch touches the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if len(sys.argv) == 3 and sys.argv[1] == "--times_of":
        return times_of(sys.argv[2])
    mesh_only = sys.argv[1:] == ["--mesh_only"]
    if len(sys.argv) > 1 and not mesh_only:
        fail(f"usage: {sys.argv[0]} [--times_of DIR | --mesh_only]")
    sys.path.insert(0, ROOT)
    try:
        from smart_quantization_tpu_torch.ops.cuda import build
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    os.makedirs(OUT, exist_ok=True)
    t_start = time.perf_counter()

    card = card_line()
    name = torch.cuda.get_device_name(0)
    say(f"[1] card: {card} | torch: {name} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    path = build.build()
    build.library()
    say(f"[2] built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.1f} s")
    kernel = "?"
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            names = [k for k in KERNEL_NAMES if f"{k}_kernel" in line] or (
                ["smaq_onepass_bf16"] if "smaq_onepass_kernel" in line else [])
            kernel = names[0] if names else line.split("'")[1]
        elif "registers" in line or "spill" in line:
            say(f"    ptxas {kernel}: {line.strip().removeprefix('ptxas info    : ')}")

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if mesh_only:
        say("[4b] the mesh alone: data parallelism and the fused FSDP path over NCCL")
        mesh_phase(card)
        say(card)
        say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": torch.cuda.device_count()}}))
        return 0
    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say("[3] kernels against their plain version")
    errs = check_kernels(device)
    errs["smaq_quantize"] = max(errs["smaq_quantize"], check_small_form(device))
    check_counter_reset(device)
    errs.update(check_float_kernels(device))
    errs.update(check_s2fp8_kernels(device))
    check_s2fp8_back_to_back(device)
    errs.update(check_bn_kernel(device))
    check_codebook(device)
    errs["philox_fill"] = check_philox_fill(device)
    check_golden(device)
    say("  the whole-batch step's entries: the stats kernels' sums, their folds over ranks, "
        "the quantize kernels on given statistics")
    for k, v in check_whole_tensor_stats(device).items():
        errs[k] = max(errs.get(k, 0.0), v)
    say("  the element offset of every stochastic kernel (a rank's rows in the whole tensor)")
    for k, v in check_offsets(device).items():
        errs[k] = max(errs.get(k, 0.0), v)
    say("  the bfloat16 forms (--compute_dtype bfloat16)")
    errs.update(check_bf16_kernels(device))
    say("  the redesigned bfloat16 forms: one-launch SmaQ, two-launch SmaQ, float_quantize")
    errs.update(check_bf16_redesign(device))
    say("  the redesigned bfloat16 forms: S2FP8's split path and the BN kernel")
    for k, v in check_bf16_s2fp8_bn(device).items():
        errs[k] = max(errs.get(k, 0.0), v)

    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say("[4] training: ResNet-18, batch 128, full coverage")
    launches, _ = run_main_path()
    res = time_steps([], check_launches=True)
    res_plain = time_steps(["--no_compress"], check_launches=False)
    per_step, calls = res["launches"], res["calls"]
    say(f"  median step: {res['ms']:.2f} ms compressed (loss {res['loss']:.4f}), "
        f"{res_plain['ms']:.2f} ms --no_compress (loss {res_plain['loss']:.4f}) on {card}")
    steps = {"smart": res["ms"], "no_compress": res_plain["ms"]}
    for label, extra, ratio_range, finite in PATHS:
        got, _ = run_main_path(extra, ratio_range, finite, train_batches=5, label=label)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        run = time_steps(extra, check_launches=True, finite_loss=finite, timed=5)
        steps[label] = run["ms"]
        say(f"  [{label}] median step: {run['ms']:.2f} ms (loss {run['loss']:.4f}, finite: "
            f"{math.isfinite(run['loss'])}) on {card}")
    resnet_sizes = param_sizes("resnet")
    for label, extra in (("smart accumulator", ["--use_weight_accumulator"]),
                         ("smart packed momentum", ["--packed_momentum"])):
        got, final = run_main_path(extra, train_batches=5, label=label)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if "packed" in label:
            check_packed_ratio(label, [final["orig_size_optimizer_momentum"],
                                       final["new_size_optimizer_momentum"]], resnet_sizes, 1)

    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say("  bert-base, batch 32 x 512, synthetic GLUE STSB, SmaQ 6/8 full coverage, AdamW")
    got, final = run_main_path([], train_batches=5, label="bert stsb", base_argv=BERT_ARGV)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    say(f"  [bert stsb] val_pearson={final.get('val_pearson')!r} "
        f"val_spearmanr={final.get('val_spearmanr')!r}")
    bert = time_steps([], check_launches=True, base_argv=BERT_ARGV)
    bert_plain = time_steps(["--no_compress"], check_launches=False, base_argv=BERT_ARGV)
    bert_per_step, bert_calls = bert["launches"], bert["calls"]
    say(f"  [bert stsb] median step: {bert['ms']:.2f} ms compressed (loss {bert['loss']:.4f}, "
        f"peak memory {bert['peak_gb']:.2f} GB), {bert_plain['ms']:.2f} ms --no_compress (loss "
        f"{bert_plain['loss']:.4f}, peak memory {bert_plain['peak_gb']:.2f} GB) on {card}")
    steps.update({"bert stsb": bert["ms"], "bert stsb no_compress": bert_plain["ms"]})

    say(f"  bert-base with the stable momentum codecs ({' '.join(CODEC_ARGV)})")
    got, final = run_main_path(CODEC_ARGV, train_batches=5, label="bert codecs",
                               base_argv=BERT_ARGV)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    codec = time_steps(CODEC_ARGV, check_launches=True, base_argv=BERT_ARGV)
    say(f"  [bert codecs] train loss after 17 steps: {codec['loss']!r} with the codecs, "
        f"{bert['loss']!r} z-score, {bert_plain['loss']!r} --no_compress; median step "
        f"{codec['ms']:.2f} ms, peak memory {codec['peak_gb']:.2f} GB on {card}")
    if not math.isfinite(codec["loss"]) or codec["loss"] > 1.25 * bert_plain["loss"]:
        fail(f"[bert codecs] loss {codec['loss']} is not finite or above 1.25x the plain "
             f"loss {bert_plain['loss']}")
    steps["bert stsb codecs"] = codec["ms"]

    say(f"  bert-base with packed state ({' '.join(PACKED_ARGV)})")
    packed = time_steps(PACKED_ARGV, check_launches=True, base_argv=BERT_ARGV)
    check_packed_ratio("bert packed", packed["sizes"]["optimizer_momentum"],
                       param_sizes("bert"), 2)
    say(f"  [bert packed] peak memory {packed['peak_gb']:.2f} GB against {bert['peak_gb']:.2f} GB "
        f"unpacked; held between steps {packed['resident_gb']:.2f} GB against "
        f"{bert['resident_gb']:.2f} GB; median step {packed['ms']:.2f} ms (loss "
        f"{packed['loss']:.4f}) on {card}")
    if not packed["peak_gb"] < bert["peak_gb"]:
        fail("[bert packed] the packed run's peak memory is not below the unpacked run's")
    steps["bert stsb packed"] = packed["ms"]

    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say("  --compute_dtype bfloat16: ResNet-18 batch 128 (SmaQ 6/8 and the other encoders) "
        "and bert-base 32 x 512 (SmaQ 6/8 with the stable codecs, AdamW 2e-5)")
    got, bf16_steps, bf16_calls = bf16_cells(card)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    steps.update(bf16_steps)
    for k, v in tuned_run(card).items():
        launches[k] = launches.get(k, 0) + v
    scaled_batch(card)

    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say(f"  --steps_per_call: K steps in one CUDA graph against K single steps, bitwise "
        f"(each cell's seeded command at K=1 and at K; a run's first group warms up and "
        f"captures, later groups replay, a leftover runs as single steps)")
    for label, base, extra, k, n_steps, epochs in (
            ("resnet18 smart", MAIN_ARGV, [], K_RESNET, 10, 2),
            ("bert stsb", BERT_ARGV, [], K_BERT, 9, 1),
            ("bert codecs", BERT_ARGV, CODEC_ARGV, K_BERT, 9, 1),
            ("bert packed", BERT_ARGV, PACKED_ARGV, K_BERT, 9, 1),
            ("resnet18 smart bf16", MAIN_ARGV, BF16_ARGV + ["--measure_average_grad_norm"],
             K_RESNET, 10, 2),
            ("bert codecs bf16", BERT_ARGV, CODEC_ARGV + BF16_ARGV, K_BERT, 9, 1),
            *((f"resnet18 {name}", MAIN_ARGV, extra, 2, 5, 1) for name, extra in K2_PATHS)):
        for kname, v in k_equals_eager(label, base, extra, k, n_steps, epochs).items():
            launches[kname] = launches.get(kname, 0) + v
    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    resume_and_replay()
    profile_dir_run()
    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say(f"  K-step timings (profile_step.profile; K={K_RESNET} ResNet-18, K={K_BERT} bert-base)")
    k_timings(card)

    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say("  the same seeded command twice (5 steps, 3 in bfloat16, a checkpoint each, every "
        "loss logged)")
    for label, base, extra in (("resnet18", MAIN_ARGV, []), ("bert stsb", BERT_ARGV, []),
                               ("resnet18 bf16", MAIN_ARGV, BF16_ARGV),
                               ("bert codecs bf16", BERT_ARGV, CODEC_ARGV + BF16_ARGV)):
        same, line = seeded_twice(label, base, extra, steps=3 if "bf16" in label else 5)
        say(f"  [{label}] deterministic kernels: {line}")
        if not same:
            fail(f"[{label}] two runs of one seeded command differ")
        if "bf16" not in label:
            _, line = seeded_twice(label, base, extra, steps=3, control=True)
            say(f"  [{label}] PyTorch's default kernels: {line}")
    with default_kernels():
        before = {"smart": time_steps([], check_launches=False, timed=5)["ms"],
                  "bert stsb": time_steps([], check_launches=False, base_argv=BERT_ARGV,
                                          timed=5)["ms"]}
    say(f"  determinism's cost, median step: ResNet-18 {before['smart']:.2f} -> "
        f"{steps['smart']:.2f} ms, bert-base {before['bert stsb']:.2f} -> "
        f"{steps['bert stsb']:.2f} ms (default kernels -> deterministic) on {card}")
    say("  median steps (ms): " + json.dumps(steps))

    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say("  Inception-v3, batch 128, synthetic CIFAR-10, SmaQ 6/8 full coverage, SGD")
    for k, v in inception_cell(card).items():
        launches[k] = launches.get(k, 0) + v

    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say("[4b] the mesh: data parallelism and the fused FSDP path over NCCL")
    for k, v in mesh_phase(card, res["ms"]).items():
        launches[k] = launches.get(k, 0) + v
    run_drivers()
    # phase 5 times kernels under PyTorch's defaults, as before
    nondeterministic()

    say(f"  ({time.perf_counter() - t_start:.0f} s into the run)")
    say("[5] kernel times at 8388608 elements (median of 25, L2 flushed)")
    timed, per_call = make_timer(device)
    t, bound, n = time_kernels(device, timed)
    rows = [
        ("smaq_stats", "plain_stats", None),
        ("smaq_quantize", "plain_quantize", None),
        ("smaq_call", "plain_call", None),
        ("float_quantize", "plain_float", "library_fp8"),
        ("float_fp8_nearest", "plain_float_nearest", "library_fp8"),
        ("float_fp16_nearest", None, "library_fp16"),
        ("float_bf16_nearest", None, "library_bf16"),
        ("s2fp8_stats", "plain_s2fp8_stats", None),
        ("s2fp8_quantize", None, None),
        ("s2fp8_pair", "plain_s2fp8", None),
        ("smaq_quantize_bn", "plain_bn", None),
    ]
    for k, plain, lib in rows:
        line = f"  {k}: {t[k] * 1e3:.1f} us"
        if plain:
            line += f", plain {t[plain] * 1e3:.1f} us"
        if lib:
            line += f", {lib} {t[lib] * 1e3:.1f} us"
        say(line + f", bound {bound[k] * 1e3:.1f} us (bytes), {bound[k] / t[k]:.1%} of it, on {card}")
    say("  library_ms: none for SmaQ, S2FP8 and BN (no single PyTorch call computes them)")
    say(f"  PyTorch moving the same bytes: x.sum() {t['torch_sum'] * 1e3:.1f} us (a read, as "
        f"smaq_stats), y.copy_(x) {t['torch_copy'] * 1e3:.1f} us (a read and a write, as "
        f"smaq_quantize)")
    tf, bound["philox_fill"], fill_n = time_fill(device, timed)
    t.update(tf)
    say(f"  philox_fill ({fill_n} uniforms, bert-base's attention dropout): "
        f"{t['philox_fill'] * 1e3:.1f} us, plain {t['plain_fill'] * 1e3:.1f} us, torch.rand "
        f"{t['torch_rand'] * 1e3:.1f} us (a yardstick: another generator's bits), bound "
        f"{bound['philox_fill'] * 1e3:.1f} us (bytes), "
        f"{bound['philox_fill'] / t['philox_fill']:.1%} of it, on {card}")
    time_smaq(device, timed, per_call, {"ResNet-18": calls, "bert-base": bert_calls}, card)
    time_s2fp8(device, timed, per_call, calls, card)
    say("  the bfloat16 forms at 8388608 elements, beside the float32 form between two casts "
        "(the path they replace) and their plain versions")
    tb, bound_b = time_bf16_kernels(device, timed)
    t.update(tb)
    bound.update(bound_b)
    for k, plain, lib, cast in (
            ("smaq_onepass_bf16", "plain_call_bf16", None, "smaq_call_cast"),
            ("smaq_stats_bf16", "plain_stats_bf16", None, None),
            ("smaq_quantize_bf16", "plain_quantize_bf16", None, None),
            ("smaq_call_bf16", "plain_call_bf16", None, "smaq_call_cast"),
            ("float_quantize_bf16", "plain_float_bf16", "library_fp8_bf16", "float_quantize_cast"),
            ("float_fp8_nearest_bf16", None, "library_fp8_bf16", None),
            ("float_fp16_nearest_bf16", None, "library_fp16_bf16", None),
            ("float_bf16_nearest_bf16", None, None, None),
            ("s2fp8_stats_bf16", "plain_s2fp8_stats_bf16", None, None),
            ("s2fp8_quantize_bf16", None, None, None),
            ("s2fp8_stats_table_bf16", "plain_s2fp8_stats_bf16", None, None),
            ("s2fp8_quantize_window_bf16", None, None, None),
            ("s2fp8_pair_bf16", "plain_s2fp8_bf16", None, "s2fp8_pair_cast"),
            ("smaq_quantize_bn_bf16", "plain_bn_bf16", None, "smaq_quantize_bn_cast")):
        line = f"  {k}: {t[k] * 1e3:.1f} us"
        if cast:
            line += f", float32 form with its casts {t[cast] * 1e3:.1f} us"
        if plain:
            line += f", plain {t[plain] * 1e3:.1f} us"
        if lib:
            line += f", {lib} {t[lib] * 1e3:.1f} us"
        say(line + f", bound {bound[k] * 1e3:.1f} us (bytes), {bound[k] / t[k]:.1%} of it, on {card}")
    say(f"  PyTorch moving the same bf16 bytes: xb.sum() {t['torch_sum_bf16'] * 1e3:.1f} us (a "
        f"read), yb.copy_(xb) {t['torch_copy_bf16'] * 1e3:.1f} us (a read and a write)")
    time_bf16_redesign(device, timed, per_call, bf16_calls, card, *bf16_s2fp8_bn_steps())
    time_offsets(device, timed, card)
    with open(os.path.join(OUT, "bf16_times.json"), "w") as f:
        json.dump({"card": card, "ms": tb, "bound_ms": bound_b}, f, indent=1)

    def row(kname, source, replaces, plain, lib=None):
        return {"name": kname, "route": "cuda", "source": f"{CSRC}/{source}",
                "replaces": f"{TPU}/{replaces}", "launches": launches[kname],
                "max_abs_err": errs[kname], "ms": t[kname], "plain_ms": t[plain],
                "bound_ms": bound[kname], "bound_by": "bytes",
                "library_ms": None if lib is None else t[lib]}

    kernels = [
        row("smaq_stats", "smaq.cu", "smaq_kernel.py:268", "plain_stats"),
        row("smaq_quantize", "smaq.cu", "smaq_kernel.py:212", "plain_quantize"),
        row("smaq_quantize_bn", "smaq.cu", "smaq_kernel.py:486", "plain_bn"),
        row("float_quantize", "float_quantize.cu", "float_kernel.py:137", "plain_float",
            "library_fp8"),
        row("s2fp8_stats", "s2fp8.cu", "s2fp8_kernel.py:226", "plain_s2fp8_stats"),
        # the plain version computes its own stats: its time is the pair's
        row("s2fp8_quantize", "s2fp8.cu", "s2fp8_kernel.py:190", "plain_s2fp8"),
        # no TPU kernel: the fill stands in for the JAX package's jax.random
        # draws of tensor-op noise (its stochastic rounding's, for one)
        {**row("philox_fill", "philox_fill.cu", "", "plain_fill"),
         "replaces": "smart_quantization_tpu/ops/rounding.py:25"},
        # the bfloat16 forms (--compute_dtype bfloat16): the same kernels
        # and TPU functions, bf16 in and out
        # the one-launch bf16 form: the whole call, stats and quantize
        row("smaq_onepass_bf16", "smaq.cu", "smaq_kernel.py:212", "plain_call_bf16"),
        row("smaq_stats_bf16", "smaq.cu", "smaq_kernel.py:268", "plain_stats_bf16"),
        row("smaq_quantize_bf16", "smaq.cu", "smaq_kernel.py:212", "plain_quantize_bf16"),
        row("smaq_quantize_bn_bf16", "smaq.cu", "smaq_kernel.py:486", "plain_bn_bf16"),
        row("float_quantize_bf16", "float_quantize.cu", "float_kernel.py:137",
            "plain_float_bf16", "library_fp8_bf16"),
        row("s2fp8_stats_bf16", "s2fp8.cu", "s2fp8_kernel.py:226", "plain_s2fp8_stats_bf16"),
        row("s2fp8_quantize_bf16", "s2fp8.cu", "s2fp8_kernel.py:190", "plain_s2fp8_bf16"),
        # the bf16 split form's table kernels (a large call's: split_forms)
        row("s2fp8_stats_table_bf16", "s2fp8.cu", "s2fp8_kernel.py:226",
            "plain_s2fp8_stats_bf16"),
        row("s2fp8_quantize_window_bf16", "s2fp8.cu", "s2fp8_kernel.py:190", "plain_s2fp8_bf16"),
    ]
    say(f"  per step: {per_step} (ResNet-18 smart), {bert_per_step} (bert-base), "
        f"{codec['launches']} (bert-base codecs), {packed['launches']} (bert-base packed); launches "
        "summed over the main-path runs, the K-step ones included (a K-step run launches "
        "from the host in its first group's warm-up and capture and in its leftover steps "
        "only); "
        f"whole run {time.perf_counter() - t_start:.0f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
