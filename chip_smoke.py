#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. build the CUDA kernels from ``smart_quantization_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (the largest ResNet-18 batch-128 activation, a ragged
   tensor, a BatchNorm leaf, the fc bias, an ill-conditioned tensor), in
   truncation, stochastic, ``all_positive`` and ``compute_size=False`` modes;
4. the main path: ``python -m smart_quantization_tpu_torch.train``'s
   ``main`` on full-width ResNet-18, batch 128, synthetic CIFAR-10, SmaQ 6/8
   with every structure compressed, launch counts read around it; then
   single steps: launches per step, no host sync between logging points,
   and the median step time beside the uncompressed step;
5. kernel times at 8 388 608 elements (CUDA events, L2 flushed between
   runs) beside the memory bound;
6. the kernel table as one JSON line, then the result as the last line.

Needs the repository beside it and one CUDA card.
"""

from __future__ import annotations

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
# flip rule (tests/test_smaq.py:144-152): elements more than 1e-5 apart
# (plus 4 ulp of the value) are bucket flips from the folded reciprocals
FLIP_FRACTION = 1e-4
MAIN_ARGV = [
    "--device", "cuda", "--model", "resnet", "--resnet_model", "resnet18",
    "--dataset", "cifar10", "--compress", "smart", "--measure_compression_ratio",
    "--batch_size", "128", "--log_every", "5",
]


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


def ill_conditioned_check(name, x, y, y_ref, bits, bits_ref, quantum):
    """|mean| >> std (tests/test_smaq.py:154-176): x * a + b with a = 1/std
    cancels to within a few percent of a grid step, so flips are many and
    the flip rule does not apply.  Instead: the error is no larger than the
    plain version's, the output follows the input, and the bits agree."""
    import torch

    flat, yk, yr = x.reshape(-1).double(), y.reshape(-1).double(), y_ref.reshape(-1).double()
    err_k, err_r = float((yk - flat).std()), float((yr - flat).std())
    dev, dev_y = flat - flat.mean(), yk - yk.mean()
    corr = float((dev * dev_y).sum() / (dev.norm() * dev_y.norm()))
    max_diff = float((yk - yr).abs().max())
    dbits = abs(float(bits) - float(bits_ref))
    ok = (
        err_k < 2 * err_r + 1e-6
        and corr > 0.99
        and dbits < 0.02 * float(bits_ref)
        and max_diff <= 1.1 * float(quantum)
        and bool(torch.isfinite(y).all())
    )
    say(f"  {name}: err std {err_k:.3e} vs plain {err_r:.3e}, corr={corr:.5f}, "
        f"max|d|={max_diff:.3e} quantum={float(quantum):.3e} "
        f"bits {float(bits):.0f} vs {float(bits_ref):.0f} -> {'ok' if ok else 'MISMATCH'}")
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
    ]
    errs = {"smaq_stats": 0.0, "smaq_quantize": 0.0}
    for name, x in cases:
        n = x.numel()
        flat = x.reshape(-1)
        # the stats kernel alone, against its plain version
        mean_k, std_k = K.fold_partials(K.smaq_stats(flat), n, trunc)
        mean_p, std_p = K.pivot_stats_reference(flat, trunc)
        d_mean, d_std = float((mean_k - mean_p).abs()), float((std_k - std_p).abs())
        stat_ok = d_mean <= 1e-6 * (1 + abs(float(mean_p))) and d_std <= 1e-5 * float(std_p) + 1e-12
        say(f"  {name}: stats |d mean|={d_mean:.2e} |d std|={d_std:.2e} "
            f"-> {'ok' if stat_ok else 'MISMATCH'}")
        if not stat_ok:
            fail(f"smaq_stats disagrees with its plain version: {name}")
        errs["smaq_stats"] = max(errs["smaq_stats"], d_mean, d_std)
        quantum = std_p / trunc.range_main

        # truncation: the whole fused call against the plain version
        y, bits = K.smaq_fused_or_reference(x, host, trunc)
        y_ref, bits_ref = K.smaq_fused_reference(x, None, trunc)
        check = ill_conditioned_check if name.startswith("ill") else flip_check
        args = (x,) if name.startswith("ill") else ()
        errs["smaq_quantize"] = max(errs["smaq_quantize"], check(
            f"{name} trunc", *args, y, y_ref, bits, bits_ref, quantum))

        # the other two stats modes: the range estimator folded from the
        # stats kernel's min/max, and the sampled stats given to the kernel
        if not name.startswith("ill"):
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
        ys, bs = K.smaq_fused(x, host, stoch)
        lo, _ = K.smaq_fused_reference(x, None, stoch, u=torch.zeros_like(flat))
        hi, _ = K.smaq_fused_reference(x, None, stoch, u=torch.ones_like(flat))
        tol = 1e-5 + 2.5e-7 * lo.abs()
        off_grid = int((((ys - lo).abs() > tol) & ((ys - hi).abs() > tol)).sum())
        # an element off its grid point is a flip: never more than one
        # quantum outside the pair; as many flips as the trunc mode allows
        # (the ill-conditioned tensor's cancellation flips ~2 % of them)
        slack = quantum * 1.01 + tol
        far = int(((ys < torch.minimum(lo, hi) - slack) | (ys > torch.maximum(lo, hi) + slack)).sum())
        allowed = (0.05 if name.startswith("ill") else FLIP_FRACTION) * n
        ok = off_grid <= allowed and far == 0 and bool(torch.isfinite(ys).all())
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

    counts = dict(K.LAUNCHES)
    say(f"  launches during the checks: {counts}")
    if min(counts.values()) == 0:
        fail("a kernel was never launched by the checks")
    return errs


# ---------------------------------------------------------------- phase 4
def per_step_launches(model) -> int:
    """SmaQ calls per training step: every tap forward and backward, every
    gradient, every non-BN weight and every momentum buffer."""
    from smart_quantization_tpu_torch.optim.compressed import norm_param_mask

    names = [n for n, _ in model.named_parameters()]
    non_bn = sum(not v for v in norm_param_mask(names).values())
    return 2 * RESNET18_TAPS + len(names) + non_bn + len(names)


def run_main_path():
    """The user's entry point, with the launch counts read around it."""
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.train.__main__ import main

    argv = MAIN_ARGV + ["--limit_train_batches", "10", "--limit_val_batches", "2",
                        "--logdir", os.path.join(OUT, "smoke_logs")]
    K.reset_launch_counts()
    final = main(argv)
    counts = dict(K.LAUNCHES)
    say(f"  main path launches: {counts}")
    if min(counts.values()) == 0:
        fail("the main path launched a kernel no time")
    tags = ("forward_autograd", "backward_autograd", "optimizer_grad",
            "optimizer_weight", "optimizer_momentum")
    missing = [t for t in tags if f"compression_ratio_{t}" not in final]
    if missing:
        fail(f"missing compression_ratio tags: {missing}")
    ratio = final.get("compression_ratio", float("nan"))
    say("  compression ratios: " + ", ".join(
        f"{t}={final[f'compression_ratio_{t}']:.4f}" for t in tags)
        + f", overall={ratio:.4f}")
    if not 4.5 <= ratio <= 5.5:
        fail(f"overall compression ratio {ratio} outside 4.5-5.5")
    if not math.isfinite(final.get("val_loss", float("nan"))):
        fail("non-finite validation loss")
    return counts


def time_steps(extra_argv, check_launches: bool):
    import torch

    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    torch.manual_seed(0)
    # no logdir: these steps are timed, not logged
    trainer = build_trainer(parse_args(MAIN_ARGV + extra_argv + ["--logdir", ""]))
    state = trainer.init_state()
    # slice every batch first: an epoch's start uploads its order, which is
    # a host-to-device copy the sync check would flag
    batches = []
    epoch = 0
    while len(batches) < 17:
        batches.extend(trainer.data.device_train_batches(epoch, trainer.device))
        epoch += 1
    batches = iter(batches)
    expected = per_step_launches(trainer.model)

    def step():
        images, labels = next(batches)
        x = trainer.task.prepare_train(images, trainer.data_gen)
        return trainer.train_step(state, x, labels)

    for _ in range(2):  # warm-up: cuDNN autotuning, the allocator
        step()
    torch.cuda.synchronize()
    if check_launches:
        # non-logging steps: any device-to-host sync raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(5):
                before = K.LAUNCHES["smaq_quantize"], K.LAUNCHES["smaq_stats"]
                metrics = step()
                got = (K.LAUNCHES["smaq_quantize"] - before[0],
                       K.LAUNCHES["smaq_stats"] - before[1])
                if got != (expected, expected):
                    fail(f"a step launched {got} (quantize, stats); expected {expected} each")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        say(f"  {expected} quantize + {expected} stats launches on every step; "
            "no host sync in 5 non-logging steps")
        if not math.isfinite(float(metrics["train_loss"])):
            fail("non-finite training loss")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    loss = float(metrics["train_loss"])
    if not math.isfinite(loss):
        fail("non-finite training loss")
    return statistics.median(times), loss, expected


# ---------------------------------------------------------------- phase 5
def time_kernels(device):
    import torch

    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    params = SmaQParams()
    gen = torch.Generator(device=device).manual_seed(2)
    host = torch.Generator().manual_seed(3)
    x = torch.randn(ACT_SHAPE, generator=gen, device=device).reshape(-1)
    n = x.numel()
    # 512 MB written between runs: evicts the 50 MB L2 and keeps the queue
    # ahead of the host, so the events time the kernel and not the launch
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device=device)
    partials = K.smaq_stats(x)
    mean, std = K.pivot_stats_reference(x, params)

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

    t = {
        "smaq_stats": timed(lambda: K.smaq_stats(x)),
        "smaq_quantize": timed(lambda: K.smaq_quantize(x, params, seed=7, partials=partials)),
        "pair": timed(lambda: K.smaq_fused(x, host, params)),
        "plain_stats": timed(lambda: K.pivot_stats_reference(x, params)),
        "plain_quantize": timed(lambda: K.smaq_fused_reference(x, host, params, mean=mean, std=std)),
        "plain_pair": timed(lambda: K.smaq_fused_reference(x, host, params)),
    }
    bound = {
        "smaq_stats": 4 * n / HBM_BYTES_PER_S * 1e3,
        "smaq_quantize": 8 * n / HBM_BYTES_PER_S * 1e3,
    }
    bound["pair"] = bound["smaq_stats"] + bound["smaq_quantize"]
    return t, bound, n


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
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
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"    ptxas: {line.strip()}")

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    say("[3] kernels against their plain version")
    errs = check_kernels(device)

    say("[4] training: ResNet-18, batch 128, SmaQ 6/8, full coverage")
    launches = run_main_path()
    step_ms, loss, per_step = time_steps([], check_launches=True)
    plain_ms, plain_loss, _ = time_steps(["--no_compress"], check_launches=False)
    say(f"  median step: {step_ms:.2f} ms compressed (loss {loss:.4f}), "
        f"{plain_ms:.2f} ms --no_compress (loss {plain_loss:.4f}) on {card}")

    say("[5] kernel times at 8388608 elements (median of 25, L2 flushed)")
    t, bound, n = time_kernels(device)
    for k in ("smaq_stats", "smaq_quantize", "pair"):
        plain = {"smaq_stats": "plain_stats", "smaq_quantize": "plain_quantize",
                 "pair": "plain_pair"}[k]
        say(f"  {k}: {t[k] * 1e3:.1f} us, plain {t[plain] * 1e3:.1f} us, "
            f"bound {bound[k] * 1e3:.1f} us (bytes), {bound[k] / t[k]:.1%} of it, on {card}")
    say("  library_ms: none (no single PyTorch call computes SmaQ)")

    src = "smart_quantization_tpu_torch/csrc/smaq.cu"
    tpu = "smart_quantization_tpu/ops/pallas/smaq_kernel.py"
    kernels = [
        {"name": "smaq_stats", "route": "cuda", "source": src, "replaces": f"{tpu}:268",
         "launches": launches["smaq_stats"], "max_abs_err": errs["smaq_stats"],
         "ms": t["smaq_stats"], "plain_ms": t["plain_stats"],
         "bound_ms": bound["smaq_stats"], "bound_by": "bytes", "library_ms": None},
        {"name": "smaq_quantize", "route": "cuda", "source": src, "replaces": f"{tpu}:212",
         "launches": launches["smaq_quantize"], "max_abs_err": errs["smaq_quantize"],
         "ms": t["smaq_quantize"], "plain_ms": t["plain_quantize"],
         "bound_ms": bound["smaq_quantize"], "bound_by": "bytes", "library_ms": None},
    ]
    say(f"  per step: {per_step} launches of each kernel; whole run "
        f"{time.perf_counter() - t_start:.0f} s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
