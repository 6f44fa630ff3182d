"""Where a training step's time goes on the card.

    python -m smart_quantization_tpu_torch.profile_step [--model resnet|bert]
        [--no_compress] [--compress smart|fp8|fp16|bf16|s2fp8|fp32]
        [--use_batch_norm] [TRAIN FLAGS...]

Runs 3 warm-up steps of a main path, with every structure compressed by the
chosen encoder (SmaQ 6/8 by default) or ``--no_compress``: ResNet-18, batch
128, synthetic CIFAR-10, SGD (``--model resnet``, the default), or
bert-base, batch 32 x 512 tokens, synthetic GLUE STSB, AdamW at lr 2e-5 and
weight decay 0.01 (``--model bert``).  Times 10 steps on the host clock,
then 10 more under ``torch.profiler``, and prints: the median step time of
each, the device's busy time per step (the sum of its kernel times; one
stream, so kernels do not overlap), its idle share of the unprofiled step,
kernel launches per step, the encoder kernels' time per step, the peak
device memory, and the kernels by device time.  The last line is one JSON
object with the same numbers.  Any other flags go to the trainer's command
line as they are (``--momentum_rowwise --momentum_log_nu``,
``--packed_momentum --packed_weights``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> dict:
    import os

    # cuBLAS reads this at its first call (the trainer's deterministic kernels)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet", choices=("resnet", "bert"))
    ap.add_argument("--no_compress", action="store_true")
    ap.add_argument("--compress", default="smart",
                    choices=("smart", "fp8", "fp16", "bf16", "s2fp8", "fp32"))
    ap.add_argument("--use_batch_norm", action="store_true")
    args, train_flags = ap.parse_known_args(argv)
    steps, warmup = 10, 3
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")

    what = ["--model", args.model, "--compress", args.compress]
    if args.no_compress:
        what.append("--no_compress")
    if args.use_batch_norm:
        what.append("--use_batch_norm")
    what += train_flags
    model_cli = {
        "resnet": ["--resnet_model", "resnet18", "--batch_size", "128"],
        "bert": ["--dataset", "glue", "--glue_task", "stsb", "--batch_size", "32",
                 "--max_input_length", "512", "--optimizer_type", "adamw",
                 "--learning_rate", "2e-5", "--weight_decay", "0.01"],
    }[args.model]
    cli = ["--device", "cuda", *what, *model_cli, "--measure_compression_ratio", "--logdir", ""]
    torch.manual_seed(0)
    trainer = build_trainer(parse_args(cli))
    state = trainer.init_state()
    batches, epoch = [], 0
    while len(batches) < warmup + 2 * steps:
        batches.extend(trainer.data.device_train_batches(epoch, trainer.device))
        epoch += 1
    batches = iter(batches)

    def step():
        inputs, labels = next(batches)
        trainer.train_step(state, trainer.task.prepare_train(inputs, trainer.data_gen), labels)

    def timed_steps():
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = timed_steps()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_times = timed_steps()

    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and _device_time_us(e) > 0
    ]
    busy_ms = sum(_device_time_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    step_ms = statistics.median(times)
    top = sorted(kernels, key=_device_time_us, reverse=True)[:15]
    # the port's own kernels (csrc/*.cu)
    encoder_ms = sum(
        _device_time_us(e) for e in kernels
        if any(k in e.key for k in ("smaq_", "float_quantize", "s2fp8_"))
    ) / 1e3 / steps
    card = torch.cuda.get_device_name(0)
    print(f"{card} [{' '.join(what)}]: step {step_ms:.2f} ms (median of {steps}; "
          f"{statistics.median(profiled_times):.2f} ms profiled), device busy "
          f"{busy_ms:.2f} ms/step, idle {1 - busy_ms / step_ms:.1%}, "
          f"{launches:.0f} kernel launches/step, encoder kernels {encoder_ms:.2f} ms/step, "
          f"peak memory {peak_gb:.2f} GB")
    for e in top:
        print(f"  {_device_time_us(e) / 1e3 / steps:8.3f} ms/step "
              f"{e.count / steps:6.0f}/step  {e.key[:90]}")
    result = {
        "device": card, "model": args.model,
        "compress": None if args.no_compress else args.compress,
        "use_batch_norm": args.use_batch_norm, "flags": what, "step_ms": step_ms,
        "step_ms_all": times, "profiled_step_ms": statistics.median(profiled_times),
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / step_ms, "launches_per_step": launches,
        "encoder_kernel_ms": encoder_ms, "peak_memory_gb": peak_gb,
        "top": [{"kernel": e.key, "ms_per_step": _device_time_us(e) / 1e3 / steps,
                 "per_step": e.count / steps} for e in top],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
