"""Joining the ranks of a run, and starting them.

Counterpart of ``smart_quantization_tpu/parallel/distributed.py``.  The
reference ran one process per GPU under Lightning DDP over NCCL (SURVEY.md
row 28); the port does the same with ``torch.distributed``:

- :func:`init_distributed` joins the default process group: NCCL for a run
  on the card (each rank on ``cuda:{LOCAL_RANK}``), gloo for ``--device
  cpu``.  The ranks meet through ``torchrun``'s environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), through
  a ``FileStore`` named by ``SMAQ_DIST_STORE`` (the CLI's own spawn), or
  through explicit arguments.  A world of one joins nothing.  NCCL that
  fails raises: there is no fallback to gloo;
- :class:`RankPool` starts ``world`` ranks with ``torch.multiprocessing``;
  they meet in a ``FileStore`` in a fresh temporary directory (no fixed
  port), stay alive and run one function on all of them at a time, each
  call with a timeout: the tests' and ``chip_smoke.py``'s multi-rank runs
  start their processes once;
- :func:`spawn` is one such call: ``world`` ranks of a command line's
  ``main`` (the CLI's own start of its mesh), failing the run if a rank
  raises, dies or outlives the timeout.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

STORE_ENV = "SMAQ_DIST_STORE"
# a collective that waits longer than this for a rank raises
DEFAULT_TIMEOUT_S = 600.0


def backend_for(device: str | torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _takes_device_id() -> bool:
    import inspect

    return "device_id" in inspect.signature(dist.init_process_group).parameters


def init_distributed(device: str | torch.device = "cuda", *, rank: int | None = None,
                     world_size: int | None = None, store_path: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join the default process group (once; a second call returns the
    summary).  Returns the rank, world size, local rank, backend and the
    rank's device (``cuda:{LOCAL_RANK}`` on the card)."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if world_size > 1 else (dev.index or 0))
        torch.cuda.set_device(dev)
    backend = backend_for(dev)
    if world_size > 1 and not dist.is_initialized():
        store_path = store_path or env.get(STORE_ENV)
        kw = dict(backend=backend, rank=rank, world_size=world_size,
                  timeout=datetime.timedelta(seconds=timeout_s))
        if store_path:
            kw["store"] = dist.FileStore(store_path, world_size)
        else:
            kw["init_method"] = "env://"
        if backend == "nccl" and _takes_device_id():
            kw["device_id"] = dev  # the communicator now, before any capture
        dist.init_process_group(**kw)
    return {"rank": rank, "world_size": world_size, "local_rank": local_rank,
            "backend": backend if world_size > 1 else None, "device": dev}


def world_of_one(device: str | torch.device = "cuda", store_path: str | None = None) -> dict:
    """A default process group of one rank (a one-rank mesh: the
    collectives run, over one member)."""
    if dist.is_initialized():
        return {"rank": dist.get_rank(), "world_size": dist.get_world_size()}
    dev = torch.device(device)
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
        if _takes_device_id():
            kw["device_id"] = dev
    made = store_path is None
    store_path = store_path or os.path.join(tempfile.mkdtemp(prefix="smaq_dist_"), "store")
    dist.init_process_group(backend_for(dev), store=dist.FileStore(store_path, 1), rank=0,
                            world_size=1, **kw)
    return {"rank": 0, "world_size": 1, "store": store_path if made else None}


def is_primary() -> bool:
    """True on the rank that writes logs and checkpoints (rank 0, or no
    process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def close() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _threads_for(world: int) -> int:
    return max(1, (os.cpu_count() or 1) // world)


def _run_main(module: str, argv: list[str]) -> None:
    import importlib

    importlib.import_module(module).main(argv)


def spawn(module: str, argv: list[str], world: int, device: str, timeout_s: float) -> None:
    """Run ``module.main(argv)`` on ``world`` new ranks (a :class:`RankPool`
    on ``device``: ``"cpu"`` for gloo, else NCCL with rank r on ``cuda:r``)
    and wait for all of them.  The module is imported by name (a package's
    ``__main__`` too).  A rank that raises or dies, or a run past
    ``timeout_s``, stops the others and raises; a collective that waits
    for a rank longer than ``DEFAULT_TIMEOUT_S`` raises on its own."""
    with RankPool(world, device, timeout_s, collective_timeout_s=DEFAULT_TIMEOUT_S,
                  threads=_threads_for(world)) as pool:
        pool.run(_run_main, module, list(argv))


def _pool_worker(rank: int, world: int, store: str, device: str, timeout_s: float,
                 threads: int, conn) -> None:
    torch.set_num_threads(threads)
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          **{STORE_ENV: store})
        dev = device if device == "cpu" else f"cuda:{rank}"
        if world == 1:
            world_of_one(dev, store)
        else:
            init_distributed(dev, rank=rank, world_size=world, store_path=store,
                             timeout_s=timeout_s)
        conn.send(("ready", None))
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        conn.send(("error", traceback.format_exc()))
        return
    while True:
        task = conn.recv()
        if task is None:
            break
        fn, args = task
        try:
            conn.send(("ok", fn(*args)))
        except (Exception, SystemExit):  # noqa: BLE001 - reported to the parent, which raises
            conn.send(("error", traceback.format_exc()))
    close()


class RankPool:
    """``world`` processes joined in one process group (gloo for
    ``device="cpu"``, NCCL with rank r on ``cuda:r`` otherwise), started at
    construction and alive until :meth:`close`.  :meth:`run` calls one
    importable function on every rank and returns the ranks' results in
    rank order; a rank that raises, dies or takes longer than ``timeout_s``
    fails the call and closes the pool (the next call starts a new one).
    A collective waits ``collective_timeout_s`` (``timeout_s`` if None) for
    a rank before it raises; each rank runs ``threads`` CPU threads (one on
    the CPU if None: the tests' small shapes, beside other work)."""

    def __init__(self, world: int, device: str = "cpu", timeout_s: float = 120.0,
                 collective_timeout_s: float | None = None, threads: int | None = None):
        self.world = world
        self.device = device
        self.timeout_s = timeout_s
        self.collective_timeout_s = timeout_s if collective_timeout_s is None else collective_timeout_s
        self.threads = threads or (1 if device == "cpu" else _threads_for(world))
        self._procs = []
        self._conns = []
        self._tmp = None
        self._joining = False
        self._start()  # the ranks start and join while the caller goes on

    def _start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="smaq_pool_")
        store = os.path.join(self._tmp, "store")
        for r in range(self.world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_pool_worker,
                            args=(r, self.world, store, self.device, self.collective_timeout_s,
                                  self.threads, child),
                            daemon=True)
            p.start()
            self._procs.append(p)
            self._conns.append(parent)
        self._joining = True

    def _fail(self, err: Exception) -> None:
        self.close()
        raise err

    def _collect(self) -> list:
        """Every rank's answer; the first rank that fails or dies fails the
        call at once, whichever rank it is."""
        out = [None] * self.world
        pending = list(range(self.world))
        t_end = time.monotonic() + self.timeout_s
        while pending:
            left = t_end - time.monotonic()
            if left <= 0:
                self._fail(TimeoutError(f"rank(s) {pending} gave no answer within "
                                        f"{self.timeout_s} s"))
            multiprocessing.connection.wait(
                [self._conns[r] for r in pending] + [self._procs[r].sentinel for r in pending],
                timeout=min(left, 1.0))
            for r in list(pending):
                if self._conns[r].poll():
                    status, value = self._conns[r].recv()
                    if status == "error":
                        self._fail(RuntimeError(f"rank {r} failed:\n{value}"))
                    out[r] = value
                    pending.remove(r)
                elif not self._procs[r].is_alive():
                    self._fail(RuntimeError(f"rank {r} died (exit code "
                                            f"{self._procs[r].exitcode})"))
        return out

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; the results in rank order."""
        if not self._procs:
            self._start()
        if self._joining:
            self._collect()
            self._joining = False
        for conn in self._conns:
            conn.send((fn, args))
        return self._collect()

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs, self._conns, self._joining = [], [], False
        if self._tmp:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
