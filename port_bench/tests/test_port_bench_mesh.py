"""The four-card cell rehearsed on four gloo ranks of the CPU at a tiny
size: the ranks build the trainer on the mesh, check, warm up and agree on
a pace; they end bitwise equal; the reference follows the same data-
parallel steps (its draws are Philox words, the CPU program's come from
host generators: the numbers agree only on the card)."""

from __future__ import annotations

import sys

from port_bench import cell as cells
from port_bench import mesh
from port_bench.reference import compare
from port_bench.tests.helpers import small_cell, workloads

NAME = "resnet18-dp4-smaq-f32-k8"


def test_four_gloo_ranks_rehearse_the_cell():
    from smart_quantization_tpu_torch.utils.config import parse_args

    c = small_cell(NAME, 8, 2, pool_batches=8)
    c.mix["warmup_dispatches"] = 1
    ranks = mesh.run_mesh(workloads()[NAME], 77, 1.0, 0, 600, on_card=False, mix=c.mix)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert mesh.forbidden_of(ranks) == []
    first = ranks[0]["prog"]
    for r in ranks[1:]:
        assert r["prog"]["losses"] == first["losses"]
        assert r["prog"]["updates"] == first["updates"]
        assert r["prog"]["grad"] == first["grad"]
    assert mesh.ranks_apart(ranks) == 0.0
    assert all(first["moved"].values())
    args = parse_args(cells.flags(c.cfg, c.mix, 77, "cpu"))
    pool = cells.inputs.Pool(c.mix["inputs"], c.mix["batch"], cells.seeds(77)["inputs"], "cpu")
    ref = cells.reference(c, args, 77, pool, "cpu")
    assert len(ref["losses"]) == len(first["losses"]) == c.mix["check_steps"] + 2 * c.k
    assert sorted(ref["updates"]) == sorted(first["updates"])
    gaps = compare.gaps(first, ref)
    assert gaps["group_unmoved"] == 0.0


def _rank_without_exchange(*args):
    """A rank whose gradient exchange returns its own gradients."""
    from smart_quantization_tpu_torch.parallel import train_dp

    train_dp.DataParallel.exchange = lambda self, grads, gen: grads
    return mesh.rank_run(*args)


def test_the_exchange_left_out_sets_the_ranks_apart():
    """With the exchange between the ranks left out, each rank steps on its
    own rows' gradient: the replicas part, which ``ranks_apart`` (limit 0)
    reads."""
    import tempfile

    from smart_quantization_tpu_torch.parallel.distributed import RankPool

    c = small_cell(NAME, 8, 2, pool_batches=8)
    c.mix["warmup_dispatches"] = 1
    with RankPool(4, "cpu", 600) as pool:
        ranks = pool.run(_rank_without_exchange, workloads()[NAME], 77, 1.0, 0,
                         tempfile.gettempdir(), False, c.mix)
    assert mesh.ranks_apart(ranks) > c.mix["limits"]["ranks_apart"]


def _rank_loading_jax(*args):
    """A rank whose process holds a module named ``jax`` (rank 2 only)."""
    import sys
    import types

    import torch.distributed as dist

    if dist.get_rank() == 2:
        sys.modules["jax"] = types.ModuleType("jax")
    return mesh.rank_run(*args)


def test_a_rank_that_loads_jax_fails_the_run(monkeypatch, capsys):
    """A module named ``jax`` in one rank's process, never in the parent's:
    the rank reports it, and the run exits with an error and no result."""
    import tempfile

    import torch

    from port_bench import run
    from smart_quantization_tpu_torch.parallel.distributed import RankPool

    c = small_cell(NAME, 8, 2, pool_batches=8)
    c.mix["warmup_dispatches"] = 1
    with RankPool(4, "cpu", 600) as pool:
        ranks = pool.run(_rank_loading_jax, workloads()[NAME], 77, 1.0, 0,
                         tempfile.gettempdir(), False, c.mix)
    assert [r["forbidden"] for r in ranks] == [[], [], ["jax"], []]
    assert "jax" not in sys.modules
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "across_cards",
                        lambda cell, args: {"forbidden": mesh.forbidden_of(ranks)})
    rc = run.main(["--workload", NAME, "--seed", "77", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "forbidden modules loaded: jax" in out.err
