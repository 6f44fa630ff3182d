"""Small cells for the benchmark's tests: a workload's configuration and
mix at another batch, K and compute dtype."""

from __future__ import annotations

import json
import os

import pytest
import torch

from port_bench import cell as cells

REPO = os.path.dirname(cells.ROOT)
# cells whose files the tests still hold to the program but that
# BENCHMARK.json does not run (PERF.md, Open questions): (config, chips)
APART = {"bert-base-smaq-f32-k4": ("bert-base-stsb", 1)}


def workloads() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        out = {w["name"]: w for w in json.load(f)["workloads"]}
    for name, (config, chips) in APART.items():
        out.setdefault(name, {"name": name, "config": config, "traffic": name, "chips": chips})
    return out


def small_cell(name: str, batch: int, k: int, dtype: str | None = None,
               pool_batches: int | None = None) -> cells.Cell:
    """The workload ``name`` at ``batch`` rows and K = ``k`` (and
    ``dtype``): its flags and fields changed alike."""
    c = cells.Cell(workloads()[name])
    mix = dict(c.mix)
    flags = list(mix["flags"])
    flags[flags.index("--batch_size") + 1] = str(batch)
    flags[flags.index("--steps_per_call") + 1] = str(k)
    mix.update(batch=batch, steps_per_call=k)
    if dtype is not None:
        if "--compute_dtype" in flags:
            flags[flags.index("--compute_dtype") + 1] = dtype
        else:
            flags += ["--compute_dtype", dtype]
        mix["compute_dtype"] = dtype
    if pool_batches is not None:
        mix["inputs"] = dict(mix["inputs"], pool_batches=pool_batches)
    mix["flags"] = flags
    c.mix, c.k = mix, k
    return c


@pytest.fixture
def card():
    """The card's device name; skips without a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
