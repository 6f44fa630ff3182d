"""NNW-BDI throughput through the port's binding (``bdi.py``), on the host.

The counterpart of ``experiments/bdi_throughput.py``, with its shapes,
configurations and JSON keys: the reference bench's 256 uint32 values (4
cache lines at batch 64), one call, and a sustained buffer of ``--big_n``
values at 1 thread and at every core, compression and decompression timed
apart (the C API's own timers; ``wall`` adds the binding's round trip).
The library is host C++ (the reference's Rust), so this runs on the CPU
of the machine it is on; ``--device`` (default ``cuda``) only names the
card in ``_meta`` (``device_meta``), so that a result from the card
machine says which host it came from:

  python -m smart_quantization_tpu_torch.experiments.bdi_throughput --out FILE
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import time

import numpy as np
import torch

from smart_quantization_tpu_torch.bdi import (
    CompressionBaseConfig,
    CompressionConfig,
    replace_with_compressed_repr,
)


def default_base_configs():
    """The CLI's default grid (``native/bdi/bdi.cpp::default_configs``):
    num_bases {1, 2, 4} x delta_size {4, 8, 16} over 32-bit bases."""
    return [CompressionBaseConfig(nb, 32, ds, f"b{nb}x32d{ds}")
            for nb in (1, 2, 4) for ds in (4, 8, 16)]


def make_config(num_threads: int, scale_factor: int = 24) -> CompressionConfig:
    return CompressionConfig(
        base_configs=default_base_configs(), batch_size=64, scale_factor_init=0,
        scale_factor_base=scale_factor, scale_factor_delta=scale_factor,
        use_randomized_base_selection=True, use_stochastic_rounding=True,
        use_zero_compression=True, seed=0, num_threads=num_threads)


def sample_buffer(n: int, kind: str) -> torch.Tensor:
    """The JAX driver's buffers (the same numpy draws) as uint32 words:
    affine-quantized weights about a zero point, or uniform 31-bit values."""
    rng = np.random.RandomState(0)
    if kind == "quantized":
        words = (1 << 27) + rng.randint(-4096, 4096, n).astype(np.int64)
    else:
        words = rng.randint(0, 2**31, n, dtype=np.int64)
    return torch.from_numpy(words).to(torch.uint32)


def time_call(config, buf: torch.Tensor, reps: int):
    """Median compress, decompress and wall ns of ``reps`` calls."""
    dest = torch.zeros(buf.numel(), dtype=torch.float32)
    comp_ns, decomp_ns, wall_ns = [], [], []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        _, _, (c_ns, d_ns) = replace_with_compressed_repr(config, buf, dest, 1.0 / (1 << 27),
                                                          1 << 27)
        wall_ns.append(time.perf_counter_ns() - t0)
        comp_ns.append(c_ns)
        decomp_ns.append(d_ns)
    return statistics.median(comp_ns), statistics.median(decomp_ns), statistics.median(wall_ns)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--big_n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=200, help="calls of the 256-value shape")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from smart_quantization_tpu_torch import resolve_device
    from smart_quantization_tpu_torch.experiments import device_meta

    args = parse_args(argv)
    hw = os.cpu_count() or 1
    results = {"_meta": {
        "machine": platform.machine(),
        "hardware_concurrency": hw,
        "note": "median over reps; comp/decomp ns from the C API's own timers, wall "
                "includes the binding's round trip; host C++ on this machine's CPU",
        **device_meta(resolve_device(args.device)),
    }}
    for kind in ("quantized", "uniform"):
        c, d, w = time_call(make_config(1), sample_buffer(256, kind), reps=args.reps)
        results[f"ref_shape_256_{kind}"] = {
            "threads": 1, "compress_us": round(c / 1e3, 2), "decompress_us": round(d / 1e3, 2),
            "wall_us": round(w / 1e3, 2), "lines": 4, "lines_per_s": round(4 / (c / 1e9)),
        }
    for kind in ("quantized", "uniform"):
        buf = sample_buffer(args.big_n, kind)
        n_lines = -(-buf.numel() // 64)
        for threads in sorted({1, hw}):
            c, d, _ = time_call(make_config(threads), buf, reps=5)
            results[f"big_{kind}_t{threads}"] = {
                "threads": threads, "elements": buf.numel(),
                "mb": round(buf.numel() * 4 / 2**20, 1), "compress_ms": round(c / 1e6, 2),
                "decompress_ms": round(d / 1e6, 2), "lines_per_s": round(n_lines / (c / 1e9)),
                "compress_mb_per_s": round(buf.numel() * 4 / 2**20 / (c / 1e9), 1),
            }
    t1, tn = results.get("big_quantized_t1"), results.get(f"big_quantized_t{hw}")
    if t1 and tn and hw > 1:
        results["_meta"]["thread_scaling_quantized"] = round(t1["compress_ms"] / tn["compress_ms"],
                                                              2)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
