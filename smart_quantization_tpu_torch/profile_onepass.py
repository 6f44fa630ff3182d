"""Where the time of a one-launch bf16 SmaQ call goes, on the card.

    python -m smart_quantization_tpu_torch.profile_onepass [N ...]

Builds the kernels with ``SMAQ_PHASES`` into a library of their own
(``ops/cuda/build.py``: ``DEFINES``), so that ``smaq_onepass`` reads the
global timer at each of its phases, in every block; runs the call (bf16,
stochastic rounding, size counted) at each size, 2 097 152 and 8 388 608
elements by default, three times; and prints, for the last call, the
earliest, median and latest block at each phase, in µs from the first
block's start: start; loads landed (and, stochastic, the Philox words the
spare shared memory holds); partial written and arrived at the barrier;
released (the blocks that waited); constants in hand; end.  Needs a CUDA
card; the numbers name it.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from smart_quantization_tpu_torch.ops.cuda import build

PHASES = ("start", "loaded", "arrived", "released", "constants", "end")
MAX_BLOCKS = 4096  # csrc/smaq.cu: g_phases' second dimension


def phase_times(sizes) -> dict:
    """{n: {phase: (earliest, median, latest) in µs}} on the current card."""
    from smart_quantization_tpu_torch.ops.cuda import smaq_kernel as K
    from smart_quantization_tpu_torch.ops.keys import key_tensor
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    build.DEFINES = (*build.DEFINES, "SMAQ_PHASES")
    lib = build.library()
    lib.smaq_phase_times.argtypes = [ctypes.c_void_p]
    lib.smaq_phase_times.restype = ctypes.c_int
    device = torch.device("cuda", torch.cuda.current_device())
    params, key = SmaQParams(), key_tensor(3, device)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(max(sizes), generator=gen, device=device).to(torch.bfloat16)
    out = {}
    for n in sizes:
        for _ in range(3):
            K.smaq_onepass(x[:n], params, key=key)
        torch.cuda.synchronize(device)
        buf = (ctypes.c_ulonglong * (len(PHASES) * MAX_BLOCKS))()
        if lib.smaq_phase_times(ctypes.addressof(buf)):
            raise RuntimeError("reading the phase times failed")
        blocks = K.smaq_plan(n, K.sm_count(device), K.onepass_slots(device))[1]
        rows = [[buf[i * MAX_BLOCKS + b] for b in range(blocks)] for i in range(len(PHASES))]
        t0 = min(rows[0])
        out[n] = {}
        for name, row in zip(PHASES, rows):
            # the block that folds never waits: its "released" is not written
            rel = [(v - t0) / 1e3 for v in row if v >= t0]
            if rel:
                out[n][name] = (min(rel), statistics.median(rel), max(rel))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_onepass needs a CUDA card", file=sys.stderr)
        return 1
    sizes = [int(a) for a in argv] or [2_097_152, 8_388_608]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    for n, phases in phase_times(sizes).items():
        print(f"smaq_onepass at {n} on {card} (us from the first block's start; earliest / "
              "median / latest block):")
        for name, (lo, med, hi) in phases.items():
            print(f"  {name:10s} {lo:8.2f} {med:8.2f} {hi:8.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
