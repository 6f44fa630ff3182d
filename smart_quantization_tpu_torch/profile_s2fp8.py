"""Where the bf16 S2FP8 table kernels pay, on the card.

    python -m smart_quantization_tpu_torch.profile_s2fp8 [N ...]

Times the two kernels of a bf16 split-form S2FP8 call (stats, then
quantize, stochastic, check_inf) at each size, 8192 to 8 388 608 elements
by default, in both forms the wrappers take (``ops/cuda/s2fp8_kernel.py``,
their ``table`` and ``window`` arguments): the table kernels
(``s2fp8_stats_table``, ``s2fp8_quantize_window``) and the float32
kernels' bf16 instances (``s2fp8_stats``, ``s2fp8_quantize``).  Each time
is the median of CUDA-event timings of 20 calls in a CUDA graph, over 20,
with 512 MB written before each (the 50 MB L2 starts cold, as
``chip_smoke.py``'s timer has it, and as a step's calls find their maps).
The sizes from which the table kernels are the faster are where
``s2fp8_kernel.BF16_TABLE_MIN`` and ``BF16_WINDOW_MIN`` put them.  Prints
one JSON line; needs a CUDA card, and the line names it.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

SIZES = (8192, 36_864, 147_456, 262_144, 524_288, 1_048_576, 2_097_152, 4_194_304, 8_388_608)


def kernel_times(sizes) -> dict:
    """{form: {n: (stats µs, quantize µs)}} for the two forms."""
    from smart_quantization_tpu_torch.ops.cuda import s2fp8_kernel as S
    from smart_quantization_tpu_torch.ops.keys import key_tensor

    device = torch.device("cuda", torch.cuda.current_device())
    key = key_tensor(7, device)
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(max(sizes), generator=gen, device=device).to(torch.bfloat16)
    capture = torch.cuda.Stream(device)
    flush = torch.empty(128 * 2**20, dtype=torch.float32, device=device)

    def per_call(fn, reps=20, runs=20):
        capture.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(capture):
            fn()
        torch.cuda.current_stream(device).wait_stream(capture)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            for _ in range(reps):
                fn()
        times = []
        for _ in range(runs):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times) / reps * 1e3

    out = {}
    for form, tables in (("with-tables", True), ("without-tables", False)):
        out[form] = {}
        for n in sizes:
            xn = x[:n]
            consts = S.s2fp8_stats(xn, table=tables).clone()
            out[form][str(n)] = (
                per_call(lambda xn=xn: S.s2fp8_stats(xn, table=tables)),
                per_call(lambda xn=xn, c=consts: S.s2fp8_quantize(
                    xn, c, key=key, stochastic=True, check_inf=True, window=tables)))
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_s2fp8 needs a CUDA card")
    sizes = [int(a) for a in argv] or list(SIZES)
    print(json.dumps({"card": torch.cuda.get_device_name(0), **kernel_times(sizes)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
