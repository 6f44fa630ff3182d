"""The benchmark of ``smart_quantization_tpu_torch``, the PyTorch and CUDA
port of SmaQ training, on NVIDIA cards.

    python3 -m port_bench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The workload (a cell of ``BENCHMARK.json``)
names a configuration (``configs/<config>.json``, with its work counts in
``work/<config>.py``) and a mix (``mixes/<traffic>.json``).  A run:

1. builds the program's trainer through its normal path (its own flag
   parser and ``build_trainer``) on the card, loads initial weights made
   on the card from the seed, and makes a pool of input batches there;
2. runs the first steps one ``Trainer.train_step`` each, then two groups
   of K steps through ``Trainer.train_steps`` (K eager steps and the
   capture of their CUDA graph, then the graph's first replay), and reads
   the program's losses, first gradient and weight changes after the
   eager steps and after the replay, and whether the replay moved the
   weights; then warms up with replays;
3. ``--trace 0``: measures for ``--seconds``, one replay of K steps a
   dispatch; ``--trace 1``: traces the mix's ``trace_dispatches``
   dispatches with ``torch.profiler`` and reduces the trace with the
   per-layer readers of ``metrics/``;
4. frees the program's state and runs the reference (``reference/``) over
   the same weights and batches, as far as the check went, then compares;
5. prints the numbers compared beside their limits on standard error and,
   as the last line of standard output, one JSON object.

It exits with an error and prints no result without a card (or without as
many as the cell asks for), without the program, or if any of JAX's
packages or the JAX package itself is loaded once the window has closed,
in this process or in a rank's.
"""

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
# whole top-level module names that must not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "smart_quantization_tpu")
# the ranks of a cell across cards answer within this
RANK_TIMEOUT_S = 300.0


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def metric_entries(bench: dict, section: str, workload: str) -> list[dict]:
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def judge(cell, gaps: dict, nonfinite: int) -> tuple[bool, dict]:
    """``correct`` and each number compared beside its limit (the mix's
    ``limits``; no non-finite loss in the window)."""
    limits = cell.mix["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    checks["nonfinite_losses"] = {"value": nonfinite, "limit": 0}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def one_card(cell, args) -> dict:
    """Build, check, warm up and measure (or trace) on one card; the
    program's state is freed on return."""
    import torch

    from port_bench import cell as cells

    targs, trainer, state, pool, params0 = cells.build(cell, args.seed, "cuda")
    driver = cells.Driver(trainer, state, pool, cell.k)
    out = {"args": targs, "pool": pool, "prog": driver.check(params0, cell.mix["check_steps"]),
           "ranks_apart": 0.0, "forbidden": []}
    del params0
    for _ in range(cell.mix["warmup_dispatches"]):
        driver.dispatch()
    torch.cuda.synchronize()
    out["setup_s"] = time.time() - PROCESS_START
    if args.trace == 0:
        out["window"] = cells.window(driver, args.seconds, cell.mix["batch"])
    else:
        path, out["traced"] = cells.traced_window(driver, cell.mix["trace_dispatches"],
                                                  tempfile.gettempdir())
        out["trace_paths"] = [path]
    out["peak"] = torch.cuda.max_memory_allocated()
    del trainer, state, driver
    cells.release()
    return out


def across_cards(cell, args) -> dict:
    """The same on every card of the cell, one rank a card
    (``port_bench/mesh.py``); rank 0's readings, how far the other ranks'
    parameters and first gradient lie from them (0 when the replicas are
    bitwise equal), the largest peak, the window from the first start to
    the last end, the forbidden modules any rank held."""
    from port_bench import cell as cells
    from port_bench import mesh
    from smart_quantization_tpu_torch.utils.config import parse_args

    ranks = mesh.run_mesh(cell.workload, args.seed, args.seconds, args.trace, RANK_TIMEOUT_S)
    first = ranks[0]
    out = {"args": parse_args(cells.flags(cell.cfg, cell.mix, args.seed, "cuda")),
           "prog": first["prog"], "ranks_apart": mesh.ranks_apart(ranks),
           "setup_s": max(r["setup_done"] for r in ranks) - PROCESS_START,
           "peak": max(r["peak"] for r in ranks), "forbidden": mesh.forbidden_of(ranks)}
    if args.trace == 0:
        w = dict(first["window"])
        w["seconds"] = max(r["window"]["seconds"] for r in ranks)
        w["nonfinite"] = sum(r["window"]["nonfinite"] for r in ranks)
        out["window"] = w
    else:
        out["traced"] = dict(first["traced"],
                             nonfinite=sum(r["traced"]["nonfinite"] for r in ranks))
        out["trace_paths"] = [r["trace_path"] for r in ranks]
    return out


def per_layer(bench: dict, cell, workload: str, path: str, traced: dict):
    """One card's per-layer metrics, ``busy_s`` and ``window_s``, and
    breakdown, from its exported trace (deleted once read)."""
    import torch

    from port_bench import cell as cells
    from port_bench.trace import Record, families, read_chrome_trace

    device_ops, host_ops, span = read_chrome_trace(path)
    os.remove(path)
    peaks = cells.load_json("peaks.json")
    name = torch.cuda.get_device_name(0)
    rec = Record(device_ops, host_ops, span, traced["steps"], traced["steps"] * cell.mix["batch"],
                 cell.mix["chips"], families(ROOT), cell.cfg, cell.mix, cell.work,
                 peaks["cards"][name],
                 peaks["element_bytes"])
    values = {}
    for m in metric_entries(bench, "per_layer", workload):
        reader = cells.load_module(os.path.join(ROOT, "metrics", f"{m['name']}.py"),
                                   "port_bench_metric")
        value = reader.read(rec)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    return values, {"busy_s": rec.busy_s, "window_s": rec.window_s}, rec.breakdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # cuBLAS reads this at its first call: the trainer's deterministic kernels
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    workload = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if workload is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from port_bench import cell as cells

    cell = cells.Cell(workload)
    got = one_card(cell, args) if workload["chips"] == 1 else across_cards(cell, args)
    bad = sorted(set(forbidden_loaded()) | set(got["forbidden"]))
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3

    result_metrics, device_info, breakdown = {}, {}, None
    if args.trace == 0:
        w = got["window"]
        values = {"samples_per_s": w["samples"] / w["seconds"],
                  "step_ms_p95": cells.p95(w["intervals_ms"]) / cell.k,
                  "setup_s": got["setup_s"], "peak_mem_gb": got["peak"] / 1e9}
        print(f"window: {w['dispatches']} dispatches of {cell.k} steps in {w['seconds']:.3f} s",
              file=sys.stderr)
        for m in metric_entries(bench, "end_to_end", args.workload):
            result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        w = got["traced"]
        per_rank = [per_layer(bench, cell, args.workload, path, w) for path in got["trace_paths"]]
        names = [m for m in per_rank[0][0] if all(m in r[0] for r in per_rank)]
        result_metrics = {m: {"value": sum(r[0][m]["value"] for r in per_rank) / len(per_rank),
                              "unit": per_rank[0][0][m]["unit"]} for m in names}
        device_info = {k: sum(r[1][k] for r in per_rank) / len(per_rank)
                       for k in ("busy_s", "window_s")}
        breakdown = per_rank[0][2]
    peak, nonfinite, attempted = got["peak"], w["nonfinite"], w["steps"]
    device = "cuda"
    pool = got.get("pool") or cells.inputs.Pool(cell.mix["inputs"], cell.mix["batch"],
                                                cells.seeds(args.seed)["inputs"], device)
    targs = got["args"]
    ref = cells.reference(cell, targs, args.seed, pool, device)
    gaps = cells.compare.gaps(got["prog"], ref)
    gaps["ranks_apart"] = got["ranks_apart"]
    correct, checks = judge(cell, gaps, nonfinite)
    print(f"card: {power_limit()}", file=sys.stderr)
    print(f"gaps read at: {json.dumps(gaps['at'])}; leaves left out: "
          f"{len(gaps['leaves_left_out'])}", file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {
        "correct": correct, "attempted": attempted, "failed": nonfinite,
        "metrics": result_metrics,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": workload["chips"], "memory_peak_bytes": peak, **device_info},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
