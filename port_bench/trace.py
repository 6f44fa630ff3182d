"""The traced window's record: what the per-layer readers read.

A ``torch.profiler`` trace (CPU and CUDA activities) of the window is
exported as Chrome trace JSON and reduced here to device operations
(kernels, copies, fills) and host calls inside the window, which the
benchmark marks with the ``WINDOW`` annotation.  The readers in
``metrics/`` take a :class:`Record`; the kernel families in ``kernels/``
say which kernels are the program's own and which are NCCL's.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

WINDOW = "port_bench/window"
# host calls that start work on the card (one kernel, or one CUDA graph)
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


def families(root: str) -> dict[str, list[str]]:
    """Kernel name patterns by family, from ``kernels/*.json``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "kernels", "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        out[spec["family"]] = spec["patterns"]
    return out


@dataclasses.dataclass
class Record:
    """One chip's traced window.  Times in microseconds on the trace's
    clock; ``steps`` and ``samples`` are those of the window on this chip
    (``samples`` of all chips)."""

    device_ops: list  # (name, category, start, duration)
    host_ops: list  # (name, category, start, duration)
    window: tuple  # (start, end)
    steps: int
    samples: int
    chips: int
    families: dict
    cfg: dict
    mix: dict
    work: object  # the configuration's work module
    card: dict  # the card's peaks (peaks.json)
    element_bytes: dict

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def family_of(self, name: str) -> str | None:
        for fam, patterns in self.families.items():
            if any(p in name for p in patterns):
                return fam
        return None

    def kernels(self):
        return [op for op in self.device_ops if op[1] == "kernel"]

    def kernel_ms_per_step(self, keep) -> float | None:
        """Device ms a step of the kernels whose family passes ``keep``
        (a test of the family name or None), or None if there are none."""
        picked = [op[3] for op in self.kernels() if keep(self.family_of(op[0]))]
        if not picked:
            return None
        return sum(picked) * 1e-3 / self.steps

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(s + d, hi)) for _, _, s, d in self.device_ops
                       if s + d > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name) and
        the longest idle gaps, each named by what the host was doing when
        it began: the innermost host call running then."""
        by_name: dict[str, float] = {}
        for name, _, _, d in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        named = []
        for length, start in gaps:
            running = [op for op in self.host_ops if op[2] <= start < op[2] + op[3]]
            host = min(running, key=lambda op: op[3])[0] if running else "host idle"
            named.append([f"idle while host in {host[:80]}", length * 1e-6])
        return {"device_ops": [[n[:120], d * 1e-6] for n, d in ops], "idle_gaps": named}


def read_chrome_trace(path: str) -> tuple[list, list, tuple]:
    """(device ops, host ops, window) of an exported trace: every device
    operation and host call that overlaps the ``WINDOW`` annotation."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} window annotations, not 1")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, dur = float(e["ts"]), float(e["dur"])
        if start + dur <= lo or start >= hi:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((e["name"], cat, start, dur))
        elif cat in HOST_CATS and e["name"] != WINDOW:
            host.append((e["name"], cat, start, dur))
    return device, host, (lo, hi)
