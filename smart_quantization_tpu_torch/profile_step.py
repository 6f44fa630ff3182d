"""Where a training step's time goes on the card.

    python -m smart_quantization_tpu_torch.profile_step [--model resnet|bert|inception]
        [--no_compress] [--compress smart|fp8|fp16|bf16|s2fp8|fp32]
        [--use_batch_norm] [--steps_per_call K] [TRAIN FLAGS...]

Runs 3 warm-up dispatches of a main path, with every structure compressed
by the chosen encoder (SmaQ 6/8 by default) or ``--no_compress``:
ResNet-18, batch 128, synthetic CIFAR-10, SGD (``--model resnet``, the
default), Inception-v3 at the same batch (``--model inception``), or
bert-base, batch 32 x 512 tokens, synthetic GLUE STSB, AdamW at lr 2e-5
and weight decay 0.01 (``--model bert``).  A dispatch is one
step, or under ``--steps_per_call K`` one group of K steps (on the card
one replay of the trainer's K-step CUDA graph; the first warm-up dispatch
captures it).  Times 10 dispatches on the host clock, then 10 more under
``torch.profiler``, and prints per step: the median step time of each
(a group's time over K), the device's busy time (the sum of its kernel
times, graph-replayed ones included; one stream, so kernels do not
overlap), its idle share of the unprofiled step, the kernels run and the host's launch calls
(``cudaLaunchKernel`` and kin, ``cudaGraphLaunch``), the encoder kernels'
time, the peak device memory, the memory held between steps (allocated,
and reserved by the caching allocator and the graph's private pool), and
the kernels by device time.  Memory counts from the first warm-up step:
under K > 1 the graph's private pool is allocated by the capture and held
(reserved) from then on.  The last line is one JSON object with the
same numbers.  Any other flags go to the trainer's command line as they
are (``--momentum_rowwise --momentum_log_nu``, ``--packed_momentum
--packed_weights``, ``--compute_dtype bfloat16``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

# host calls that start work on the card
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch")


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(trainer, steps: int = 10, warmup: int = 3, profiled: int | None = None) -> dict:
    """Time a trainer's steps on the card as the module docstring says:
    ``warmup`` dispatches, ``steps`` timed ones, then ``profiled`` (default
    ``steps``) under the profiler; returns the numbers (per step; a
    dispatch of K steps counts K).  The peak memory is the run's from its
    first step (under K > 1 the capture allocates the graph's pool, which
    later replays reuse)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    k = trainer.cfg.steps_per_call
    state = trainer.init_state()
    batches, epoch = [], 0
    while len(batches) < k * (warmup + steps + (steps if profiled is None else profiled)):
        batches.extend(trainer.data.device_train_batches(epoch, trainer.device))
        epoch += 1
    batches = iter(batches)

    def dispatch():
        group = []
        for _ in range(k):
            inputs, labels = next(batches)
            group.append((trainer.task.prepare_train(inputs, trainer.data_gen), labels))
        if k == 1:
            return trainer.train_step(state, *group[0])
        return trainer.train_steps(state, group)

    def timed_dispatches(n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dispatch()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / k)
        return times

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warmup):
        dispatch()
    times = timed_dispatches(steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    held_gb = torch.cuda.memory_allocated() / 1e9
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    profiled = steps if profiled is None else profiled
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_times = timed_dispatches(profiled)

    n = profiled * k
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and _device_time_us(e) > 0]
    busy_ms = sum(_device_time_us(e) for e in kernels) / 1e3 / n
    host_launches = sum(e.count for e in events
                        if e.device_type == DeviceType.CPU and e.key in HOST_LAUNCHES) / n
    step_ms = statistics.median(times)
    top = sorted(kernels, key=_device_time_us, reverse=True)[:15]
    # the port's own kernels (csrc/*.cu)
    encoder_ms = sum(
        _device_time_us(e) for e in kernels
        if any(name in e.key for name in ("smaq_", "float_quantize", "s2fp8_", "philox_"))
    ) / 1e3 / n
    return {
        "device": torch.cuda.get_device_name(0), "steps_per_call": k, "step_ms": step_ms,
        "step_ms_all": times, "profiled_step_ms": statistics.median(profiled_times),
        "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / step_ms,
        "launches_per_step": sum(e.count for e in kernels) / n,
        "host_launches_per_step": host_launches, "encoder_kernel_ms": encoder_ms,
        "peak_memory_gb": peak_gb, "held_memory_gb": held_gb,
        "reserved_memory_gb": reserved_gb,
        "top": [{"kernel": e.key, "ms_per_step": _device_time_us(e) / 1e3 / n,
                 "per_step": e.count / n} for e in top],
    }


def main(argv=None) -> dict:
    import os

    # cuBLAS reads this at its first call (the trainer's deterministic kernels)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import parse_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet", choices=sorted(MODEL_CLI))
    ap.add_argument("--no_compress", action="store_true")
    ap.add_argument("--compress", default="smart",
                    choices=("smart", "fp8", "fp16", "bf16", "s2fp8", "fp32"))
    ap.add_argument("--use_batch_norm", action="store_true")
    args, train_flags = ap.parse_known_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")

    what = ["--model", args.model, "--compress", args.compress]
    if args.no_compress:
        what.append("--no_compress")
    if args.use_batch_norm:
        what.append("--use_batch_norm")
    what += train_flags
    cli = ["--device", "cuda", *what, *MODEL_CLI[args.model], "--measure_compression_ratio",
           "--logdir", ""]
    torch.manual_seed(0)
    result = profile(build_trainer(parse_args(cli)))
    result.update({"model": args.model, "compress": None if args.no_compress else args.compress,
                   "use_batch_norm": args.use_batch_norm, "flags": what})
    print(f"{result['device']} [{' '.join(what)}]: step {result['step_ms']:.2f} ms (median of "
          f"10 dispatches of {result['steps_per_call']}; {result['profiled_step_ms']:.2f} ms "
          f"profiled), device busy {result['device_busy_ms']:.2f} ms/step, idle "
          f"{result['device_idle_share']:.1%}, {result['launches_per_step']:.0f} kernels/step, "
          f"{result['host_launches_per_step']:.2f} host launch calls/step, encoder kernels "
          f"{result['encoder_kernel_ms']:.2f} ms/step, peak memory "
          f"{result['peak_memory_gb']:.2f} GB, held {result['held_memory_gb']:.2f} GB "
          f"({result['reserved_memory_gb']:.2f} GB reserved)")
    for e in result["top"]:
        print(f"  {e['ms_per_step']:8.3f} ms/step {e['per_step']:6.0f}/step  {e['kernel'][:90]}")
    print(json.dumps(result))
    return result


# the main paths' model and data flags
MODEL_CLI = {
    "resnet": ["--resnet_model", "resnet18", "--batch_size", "128"],
    "inception": ["--dataset", "cifar10", "--batch_size", "128"],
    "bert": ["--dataset", "glue", "--glue_task", "stsb", "--batch_size", "32",
             "--max_input_length", "512", "--optimizer_type", "adamw",
             "--learning_rate", "2e-5", "--weight_decay", "0.01"],
}


if __name__ == "__main__":
    main()
