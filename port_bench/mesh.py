"""A cell across the cards of one host: one rank a card, each in a process
of the program's own ``RankPool`` (NCCL; the ranks meet in a store in a
fresh temporary directory).

Every rank builds the trainer on the mesh the cell's flags ask for
(``build_trainer(args, mesh)``), loads the same initial weights and makes
the same pool of global batches, of which ``Trainer.prepare_batch`` takes
its rows.  The ranks run the check's first steps and the first group
together, agree on the window's number of dispatches (from the slowest
rank's warm-up pace, so that they stop together without a collective in
the window), then measure or trace it.  Each returns its readings, with
the forbidden top-level modules its own process holds once its window has
closed (the parent's ``sys.modules`` never sees a rank's imports); the
parent process gathers them and runs the reference.
"""

from __future__ import annotations

import math
import os
import time

import torch
import torch.distributed as dist

from port_bench import cell as cells
from port_bench.run import forbidden_loaded

# dispatches timed after the warm-up to set the window's length
PACE_DISPATCHES = 2


def agree_max(value: float, device) -> float:
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def rank_run(workload: dict, seed: int, seconds: float, trace: int, tmpdir: str,
             on_card: bool = True, mix: dict | None = None) -> dict:
    """One rank's run; called on every rank of the pool (``on_card``
    False: a rehearsal on the CPU's gloo ranks, measuring nothing;
    ``mix`` in place of the workload's)."""
    rank = dist.get_rank()
    device = f"cuda:{rank}" if on_card else "cpu"
    if on_card:
        torch.cuda.set_device(rank)
    cell = cells.Cell(workload)
    if mix is not None:
        cell.mix, cell.k = mix, mix["steps_per_call"]
    args, trainer, state, pool, params0 = cells.build(cell, seed, device)
    driver = cells.Driver(trainer, state, pool, cell.k)
    prog = driver.check(params0, cell.mix["check_steps"])
    del params0
    for _ in range(cell.mix["warmup_dispatches"]):
        driver.dispatch()
    _sync(on_card)
    t0 = time.perf_counter()
    for _ in range(PACE_DISPATCHES):
        driver.dispatch()
    _sync(on_card)
    pace = agree_max((time.perf_counter() - t0) / PACE_DISPATCHES, device)
    dist.barrier()
    out = {"rank": rank, "prog": prog, "setup_done": time.time()}
    if not on_card:
        out["forbidden"] = forbidden_loaded()
        return out
    if trace == 0:
        out["window"] = cells.window(driver, seconds, cell.mix["batch"],
                                     dispatches=max(1, math.ceil(seconds / pace)))
    else:
        path, w = cells.traced_window(driver, cell.mix["trace_dispatches"], tmpdir)
        out["traced"] = w
        out["trace_path"] = path
    out["peak"] = torch.cuda.max_memory_allocated(device)
    out["forbidden"] = forbidden_loaded()
    return out


def forbidden_of(ranks: list) -> list[str]:
    """The forbidden top-level modules that any rank's process held."""
    return sorted({name for r in ranks for name in r["forbidden"]})


def ranks_apart(ranks: list) -> float:
    """How far the ranks' first gradient and change norms (after the eager
    steps and after the graph's first replay) lie from rank 0's, as a
    share of rank 0's (0 when the replicas are bitwise equal)."""
    def norm_sets(prog):
        return [prog["grad"], *(prog["updates"][n] for n in sorted(prog["updates"]))]

    first = norm_sets(ranks[0]["prog"])
    return max(abs(mine[k] - theirs[k]) / max(theirs[k], 1e-30)
               for r in ranks for mine, theirs in zip(norm_sets(r["prog"]), first)
               for k in theirs)


def run_mesh(workload: dict, seed: int, seconds: float, trace: int, timeout_s: float,
             on_card: bool = True, mix: dict | None = None) -> list:
    """Every rank's readings, in rank order."""
    import tempfile

    from smart_quantization_tpu_torch.parallel.distributed import RankPool

    world = workload["chips"]
    with RankPool(world, "cuda" if on_card else "cpu", timeout_s,
                  threads=max(1, (os.cpu_count() or 1) // world)) as ranks:
        return ranks.run(rank_run, workload, seed, seconds, trace, tempfile.gettempdir(),
                         on_card, mix)
