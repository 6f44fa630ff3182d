"""The per-layer readers on a small hand-made trace: what falls inside the
window, the kernel families, the idle share, and nothing read where a
family has no kernel."""

from __future__ import annotations

import json
import os

import pytest

from port_bench import cell as cells
from port_bench.trace import WINDOW, Record, families, read_chrome_trace
from port_bench.tests.helpers import workloads


def _trace(tmp_path, kernels, host) -> str:
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 1000.0, "dur": 1000.0}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d} for n, ts, d in kernels]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": ts, "dur": d} for n, ts, d in host]
    path = os.path.join(tmp_path, "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def _record(path, name="resnet18-smaq-bf16-k8", steps=2) -> Record:
    c = cells.Cell(workloads()[name])
    peaks = cells.load_json("peaks.json")
    device_ops, host_ops, span = read_chrome_trace(path)
    return Record(device_ops, host_ops, span, steps, steps * c.mix["batch"], c.mix["chips"],
                  families(cells.ROOT), c.cfg, c.mix, c.work,
                  peaks["cards"]["NVIDIA H100 80GB HBM3"], peaks["element_bytes"])


def _read(metric: str, rec: Record):
    return cells.load_module(os.path.join(cells.ROOT, "metrics", f"{metric}.py"),
                             "port_bench_metric").read(rec)


def test_readers_on_a_window(tmp_path):
    kernels = [
        ("void smaq_quantize_kernel<float>", 1100.0, 100.0),
        ("void (anonymous namespace)::smaq_onepass_kernel<true>", 1250.0, 50.0),
        ("sm90_xmma_gemm_bf16", 1300.0, 300.0),  # touches the smaq kernel's end: one busy span
        ("ncclDevKernel_AllReduce_Sum_i8", 1700.0, 100.0),
        ("sm90_xmma_gemm_bf16", 500.0, 100.0),  # before the window
        ("sm90_xmma_gemm_bf16", 1950.0, 100.0),  # runs past the window's end
    ]
    host = [("cudaGraphLaunch", 1010.0, 5.0), ("cudaLaunchKernel", 1020.0, 2.0),
            ("cudaLaunchKernel", 100.0, 2.0)]
    rec = _record(_trace(str(tmp_path), kernels, host))
    assert rec.window_s == pytest.approx(1e-3)
    # busy: 1100-1200, 1250-1600, 1700-1800, 1950-2000 (clipped)
    assert rec.busy_s == pytest.approx(600e-6)
    assert _read("device_idle_share", rec) == pytest.approx(40.0)
    assert _read("host_launches_per_step", rec) == 1.0
    assert _read("encoder_kernel_ms", rec) == pytest.approx(0.15 / 2)
    assert _read("nccl_ms", rec) == pytest.approx(0.1 / 2)
    assert _read("model_kernel_ms", rec) == pytest.approx(0.4 / 2)
    least_ms = sum(n * rec.element_bytes[dt] * p for _, n, dt, p in
                   rec.work.compression(rec.cfg, rec.mix)) / rec.card["bytes_per_s"] * 1e3
    assert _read("kernel_roofline", rec) == pytest.approx(100.0 * least_ms / 0.075)
    mfu = _read("mfu", rec)
    assert mfu == pytest.approx(100.0 * rec.work.flops_per_sample(rec.cfg) * 256 / 1e-3 / 989e12)
    gaps = rec.breakdown()["idle_gaps"]
    assert [round(s * 1e6) for _, s in gaps] == [150, 100, 100, 50]


def test_nothing_read_without_the_family(tmp_path):
    rec = _record(_trace(str(tmp_path), [("sm90_xmma_gemm_bf16", 1100.0, 100.0)], []),
                  name="resnet18-nocompress-bf16-k8")
    assert _read("encoder_kernel_ms", rec) is None
    assert _read("kernel_roofline", rec) is None
    assert _read("nccl_ms", rec) is None
    assert _read("host_launches_per_step", rec) == 0.0
