"""One cell on one card: the program's trainer built through its normal
path, driven by the benchmark's inputs, timed, traced and checked against
the reference.

- :func:`build` parses the configuration's and the mix's flags with the
  program's own parser and builds the trainer with its ``build_trainer``,
  then loads the benchmark's initial weights into the model and makes the
  input pool;
- :class:`Driver` feeds groups of K batches to ``Trainer.train_steps`` (one
  replay of the K-step CUDA graph a group; the first group runs the K
  steps eagerly and captures them); before it, its ``check`` runs the
  mix's ``check_steps`` first steps one ``Trainer.train_step`` each, the
  first group and the graph's first replay, and reads what the check
  compares (every step's loss, the first gradient as the optimizer holds
  it, each leaf's change after the eager steps and after the replay, and
  whether the replay moved each leaf);
- :func:`window` and :func:`traced_window` measure; :func:`reference`
  runs the reference over the same batches from the same weights, as far
  as the check went, after the program's state is freed.

What the check keeps (the initial weights, the weights before the replay)
stays on the host, so that no copy of the benchmark's sits on the card
while the program trains and the peak it reads is the program's.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import time

import numpy as np
import torch

from port_bench import inputs
from port_bench.reference import compare, dp
from port_bench.reference.data import Prepare
from port_bench.reference.optim import Hyper
from port_bench.reference.smaq import SmaQ
from port_bench.reference.train import follow, model_of

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeds(seed: int) -> dict[str, int]:
    """The seeds of a run's weights and inputs, from ``--seed``."""
    w, x = np.random.SeedSequence([seed, 16]).generate_state(2, np.uint64)
    return {"weights": int(w) >> 1, "inputs": int(x) >> 1}


def flags(cfg: dict, mix: dict, seed: int, device: str) -> list[str]:
    return [*cfg["flags"], *mix["flags"], "--device", device, "--logdir", "", "--seed", str(seed)]


def check_flags(args, mix: dict) -> None:
    """The mix's stated batch, K, dtype and compression are what its flags
    give the program."""
    got = {"batch": args.batch_size, "steps_per_call": args.steps_per_call,
           "compute_dtype": args.compute_dtype, "compress": bool(args.compress_enabled)}
    want = {k: mix[k] for k in got}
    if got != want:
        raise ValueError(f"the mix's flags give {got}, its fields say {want}")


def hyper(args) -> Hyper:
    if args.optimizer_type not in ("sgd", "adamw") or (
            args.optimizer_type == "sgd" and args.weight_decay):
        raise ValueError(f"the reference has no {args.optimizer_type} with weight decay "
                         f"{args.weight_decay}")
    kw = {k: v for k, v in (("b1", args.beta1), ("b2", args.beta2), ("eps", args.epsilon))
          if v is not None}
    return Hyper(args.optimizer_type, args.learning_rate, args.momentum, args.weight_decay, **kw)


def quantizer(args) -> SmaQ | None:
    if not args.compress_enabled:
        return None
    if args.compress != "smart" or args.use_sample_stats or args.use_range_std_dev \
            or args.use_batch_norm or not args.stochastic_rounding:
        raise ValueError("the reference quantizes with SmaQ's full statistics and "
                         "stochastic rounding only")
    return SmaQ(args.num_bits_main, args.num_bits_outlier, args.main_std_dev_threshold,
                args.outlier_std_dev_threshold, args.min_size)


class Cell:
    """A workload's configuration, mix and the modules that read them."""

    def __init__(self, workload: dict):
        self.workload = workload
        self.cfg = load_json("configs", f"{workload['config']}.json")
        self.mix = load_json("mixes", f"{workload['traffic']}.json")
        self.work = load_module(os.path.join(ROOT, "work", f"{workload['config']}.py"),
                                "port_bench_work")
        self.model = model_of(self.cfg)
        self.k = self.mix["steps_per_call"]


def build(cell: Cell, seed: int, device: str):
    """The trainer (on the mesh the flags ask for, whose process group the
    caller has joined), its state, the input pool and the initial weights
    (made on ``device``, loaded into the model and kept on the host)."""
    from smart_quantization_tpu_torch.parallel.mesh import make_mesh
    from smart_quantization_tpu_torch.train.__main__ import build_trainer
    from smart_quantization_tpu_torch.utils.config import mesh_plan, parse_args

    args = parse_args(flags(cell.cfg, cell.mix, seed, device))
    check_flags(args, cell.mix)
    plan = mesh_plan(args)
    mesh = None if plan is None else make_mesh(plan.dp, plan.fsdp)
    if (1 if plan is None else plan.size) != cell.mix["chips"]:
        raise ValueError(f"the mix's flags ask for a mesh of {plan}, its chips are "
                         f"{cell.mix['chips']}")
    torch.manual_seed(seed)
    trainer = build_trainer(args, mesh)
    s = seeds(seed)
    params0 = inputs.weights(cell.cfg, cell.model.param_shapes(cell.cfg), s["weights"], device)
    mine = dict(trainer.model.named_parameters())
    if [(k, tuple(v.shape)) for k, v in mine.items()] != \
            [(k, tuple(v.shape)) for k, v in params0.items()]:
        raise RuntimeError("the program's parameters are not the configuration's")
    with torch.no_grad():
        for k, p in mine.items():
            p.copy_(params0[k])
    params0 = {k: v.cpu() for k, v in params0.items()}
    state = trainer.init_state()
    pool = inputs.Pool(cell.mix["inputs"], cell.mix["batch"], s["inputs"], device)
    return args, trainer, state, pool, params0


def _buffers(opt_state) -> dict:
    """The optimizer's momentum buffers in its order (trace; mu, nu)."""
    inner = getattr(opt_state, "inner", opt_state)
    return {k: v for k, v in inner.items() if isinstance(v, dict)}


class Driver:
    """Batches from the pool through the trainer, in turn."""

    def __init__(self, trainer, state, pool, k: int):
        self.trainer, self.state, self.pool, self.k = trainer, state, pool, k
        self.next = 0

    def batch(self):
        x, y = self.pool[self.next]
        self.next += 1
        return self.trainer.prepare_batch(x, y)

    def dispatch(self) -> dict:
        """One group of K steps: one call of ``Trainer.train_steps``."""
        return self.trainer.train_steps(self.state, [self.batch() for _ in range(self.k)])

    def check(self, params0: dict, steps: int) -> dict:
        """The first ``steps`` steps, one ``Trainer.train_step`` each (the
        step function the K-step graph captures), then two groups of K
        steps: the first runs them eagerly and captures the graph, the
        second is the graph's first replay, the call the window makes.
        Returns what the check reads: every step's loss, the norms of the
        first momentum buffer's leaves after the first step, of each leaf's
        change from ``params0`` after the eager steps and after the replay
        (``updates``, by steps taken), and whether the replay moved each
        leaf."""
        model = dict(self.trainer.model.named_parameters())
        losses, grad = [], None
        for _ in range(steps):
            losses.append(self.trainer.train_step(self.state, *self.batch())["train_loss"])
            if grad is None:
                first = next(iter(_buffers(self.state.opt_state).values()))
                grad = compare.norms(first)
        with torch.no_grad():
            updates = {steps: compare.norms({k: model[k].detach() for k in params0}, params0)}
        losses.extend(self.dispatch()["train_loss"])
        with torch.no_grad():
            before = {k: p.detach().to("cpu", copy=True) for k, p in model.items()}
        losses.extend(self.dispatch()["train_loss"])
        with torch.no_grad():
            moved = {k: not torch.equal(before[k].to(p.device), p.detach())
                     for k, p in model.items()}
            updates[steps + 2 * self.k] = compare.norms(
                {k: model[k].detach() for k in params0}, params0)
        return {"losses": [float(v) for v in losses], "grad": grad, "updates": updates,
                "moved": moved}


def window(driver: Driver, seconds: float, rows: int, dispatches: int | None = None) -> dict:
    """Dispatches until ``seconds`` have passed (or ``dispatches`` of them,
    which ranks agree on beforehand), from one synchronize to the next;
    CUDA events after each dispatch give its interval."""
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)]
    t0 = time.perf_counter()
    events[0].record()
    losses = []
    while True:
        losses.append(driver.dispatch()["train_loss"])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if (len(losses) >= dispatches if dispatches is not None
                else time.perf_counter() - t0 >= seconds):
            break
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    intervals = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    steps = len(intervals) * driver.k
    loss = torch.cat(losses)
    return {"seconds": elapsed, "dispatches": len(intervals), "steps": steps,
            "samples": steps * rows, "intervals_ms": intervals,
            "nonfinite": int((~torch.isfinite(loss)).sum())}


def traced_window(driver: Driver, dispatches: int, tmpdir: str) -> tuple[str, dict]:
    """``dispatches`` dispatches under ``torch.profiler``, marked by the
    window annotation; returns the exported trace's path and the counts."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench.trace import WINDOW

    torch.cuda.synchronize()
    losses = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(dispatches):
                losses.append(driver.dispatch()["train_loss"])
            torch.cuda.synchronize()
    path = os.path.join(tmpdir, f"port_bench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    loss = torch.cat(losses)
    steps = dispatches * driver.k
    return path, {"dispatches": dispatches, "steps": steps,
                  "nonfinite": int((~torch.isfinite(loss)).sum())}


def reference(cell: Cell, args, seed: int, pool, device: str, precision: str | None = None,
              fault: str | None = None) -> dict:
    """The reference's first ``check_steps`` + 2 K steps (as far as the
    check follows the program) from the benchmark's weights over the
    pool's first batches, and its readings: losses, first raw gradient
    norms, the first momentum buffer's norms after the first step and each
    leaf's change after ``check_steps`` and after all the steps.  ``precision`` defaults to the
    configuration's compute dtype; the control passes the one below it.
    ``fault`` plants one in the reference: ``half_batch`` (the loss of each
    step, of each rank, over the first half of its rows) or, across cards,
    ``no_exchange`` (rank 0 steps on its own gradient)."""
    marks = (cell.mix["check_steps"], cell.mix["check_steps"] + 2 * cell.k)
    steps = marks[-1]
    s = seeds(seed)
    params0 = inputs.weights(cell.cfg, cell.model.param_shapes(cell.cfg), s["weights"], device)
    precision = precision or args.compute_dtype
    ranks = cell.mix["chips"]
    if ranks == 1:
        prep = Prepare(cell.cfg["prepare"], seed, device)
        batches = [prep(*pool[i]) for i in range(steps)]
        out = follow(cell.cfg, hyper(args), quantizer(args), args.compute_dtype, seed, params0,
                     batches, steps, precision, fault == "half_batch", keep_at=marks)
    else:
        if args.fsdp != 1 or args.grad_allreduce_mode != "psum" or not args.grad_allreduce_bits:
            raise ValueError("the reference runs data parallelism with the int8 psum exchange")
        preps = [Prepare(cell.cfg["prepare"], dp.augment_seed(seed, r), device)
                 for r in range(ranks)]
        rows = cell.mix["batch"] // ranks
        batches = []
        for i in range(steps):
            x, y = pool[i]
            batches.append([preps[r](*_rows((x, y), r, rows)) for r in range(ranks)])
        out = dp.follow_dp(cell.cfg, hyper(args), quantizer(args), args.compute_dtype, seed,
                           params0, batches, steps, precision, args.grad_allreduce_bits,
                           fault, keep_at=marks)
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "grad": compare.norms(out["first_buffer"]),
            "updates": {n: compare.norms(out["params_at"][n], params0) for n in marks}}


def _rows(batch, r: int, rows: int):
    """Rank ``r``'s rows of a global batch (a tensor or a dict of them)."""
    x, y = batch
    cut = slice(r * rows, (r + 1) * rows)
    if isinstance(x, dict):
        return {k: v[cut] for k, v in x.items()}, y[cut]
    return x[cut], y[cut]


def release() -> None:
    """Hand the memory of what the caller has let go back to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def p95(values: list[float]) -> float:
    return statistics.quantiles(values, n=20)[18]
