"""The readings a cell's limits are set from, on the card at the cell's own
size:

    python3 -m port_bench.calibrate --workload NAME --seeds 11,12,... \\
        [--controls 3] [--faults 3] [--out FILE]

For each seed, the program's checked steps (the eager first steps, the
first group of K and the K-step graph's first replay) against the
reference's (the sound readings); for the first ``--controls`` seeds the
control, the reference computed in the precision below the cell's
(``control_precision`` of the mix), against the reference; for the first
``--faults`` seeds the program with half of each batch left out of the
loss (the mean over the rest) against the reference.  For a cell across
cards the sound readings are its runs' (``run.py`` prints them), and the
faults are planted in the reference put in the program's place: half of
each batch, and the exchange between the cards left out.  A state left
unchanged reads 1 on the update gap and on ``group_unmoved`` and needs no
run; a replay on stale batches is a card test
(``tests/test_port_bench_reference.py``).
Prints one JSON line a seed and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from port_bench import cell as cells  # noqa: E402
from smart_quantization_tpu_torch.utils.config import parse_args  # noqa: E402


class HalfBatch:
    """A task whose loss leaves out the second half of the batch."""

    def __init__(self, task):
        self._task = task

    def __getattr__(self, name):
        return getattr(self._task, name)

    def loss(self, logits, labels):
        half = labels.shape[0] // 2
        return self._task.loss(logits[:half], labels[:half])


def program_readings(cell: cells.Cell, seed: int, fault=None) -> tuple[dict, object, object]:
    args, trainer, state, pool, params0 = cells.build(cell, seed, "cuda")
    if fault is not None:
        trainer.task = fault(trainer.task)
    driver = cells.Driver(trainer, state, pool, cell.k)
    prog = driver.check(params0, cell.mix["check_steps"])
    del trainer, state, driver, params0
    cells.release()
    return prog, args, pool


def with_steps(gaps: dict, prog: dict, ref: dict) -> dict:
    out = {k: gaps[k] for k in ("loss_gap", "grad_gap", "update_gap", "at") if k in gaps}
    out["group_unmoved"] = gaps.get("group_unmoved")
    out["step_loss_gaps"] = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    with open(os.path.join(cells.ROOT, os.pardir, "BENCHMARK.json")) as f:
        workload = next(w for w in json.load(f)["workloads"] if w["name"] == args.workload)
    cell = cells.Cell(workload)
    rows = []
    across = cell.mix["chips"] > 1
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        if across:
            # a cell across cards: the sound readings are its runs' (run.py);
            # the fault is planted in the reference put in the program's place
            targs = parse_args(cells.flags(cell.cfg, cell.mix, seed, "cuda"))
            pool = cells.inputs.Pool(cell.mix["inputs"], cell.mix["batch"],
                                     cells.seeds(seed)["inputs"], "cuda")
            ref = cells.reference(cell, targs, seed, pool, "cuda")
            row = {"seed": seed}
        else:
            prog, targs, pool = program_readings(cell, seed)
            ref = cells.reference(cell, targs, seed, pool, "cuda")
            row = {"seed": seed, "sound": with_steps(cells.compare.gaps(prog, ref), prog, ref),
                   "losses": {"program": prog["losses"], "reference": ref["losses"]}}
        if i < args.controls:
            ctl = cells.reference(cell, targs, seed, pool, "cuda",
                                  precision=cell.mix["control_precision"])
            row["control"] = with_steps(cells.compare.gaps(ctl, ref), ctl, ref)
        if i < args.faults:
            if across:
                bad = cells.reference(cell, targs, seed, pool, "cuda", fault="half_batch")
                lone = cells.reference(cell, targs, seed, pool, "cuda", fault="no_exchange")
                row["no_exchange"] = with_steps(cells.compare.gaps(lone, ref), lone, ref)
            else:
                bad, _, _ = program_readings(cell, seed, HalfBatch)
            row["half_batch"] = with_steps(cells.compare.gaps(bad, ref), bad, ref)
        del pool, ref
        cells.release()
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
