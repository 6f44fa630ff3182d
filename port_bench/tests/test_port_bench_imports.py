"""Nothing that the benchmark runs loads JAX or the JAX package, and the
reference imports neither package."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from port_bench import run

REFERENCE = os.path.join(os.path.dirname(run.ROOT), "port_bench", "reference")

REHEARSAL = """
import json, sys
from port_bench import calibrate, cell, inputs, run, trace
from port_bench.tests.helpers import small_cell
import importlib.util, glob, os
for path in glob.glob(os.path.join(cell.ROOT, "metrics", "*.py")):
    cell.load_module(path, "port_bench_metric")
c = small_cell("resnet18-smaq-bf16-k8", 2, 2, "float32", pool_batches=4)
args, trainer, state, pool, params0 = cell.build(c, 5, "cpu")
cell.Driver(trainer, state, pool, c.k).check(params0, 1)
print(json.dumps({"forbidden": run.forbidden_loaded(),
                  "program": "smart_quantization_tpu_torch" in sys.modules}))
"""


def test_a_rehearsal_loads_no_jax():
    """The harness's import graph and a tiny CPU run of the program leave no
    forbidden top-level name in ``sys.modules``; the port, whose name
    begins with the JAX package's, is loaded and passes."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", REHEARSAL], capture_output=True, text=True,
                         cwd=os.path.dirname(run.ROOT), env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "program": True}


def test_names_are_compared_whole(monkeypatch):
    for name in ("smart_quantization_tpu_torch", "smart_quantization_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "smart_quantization_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_loaded() == ["jax", "smart_quantization_tpu"]


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_neither_package():
    paths = [os.path.join(REFERENCE, f) for f in sorted(os.listdir(REFERENCE))
             if f.endswith(".py")]
    assert paths
    banned = {"jax", "jaxlib", "flax", "optax", "smart_quantization_tpu",
              "smart_quantization_tpu_torch"}
    found = {p: _imports(p) & banned for p in paths}
    assert not any(found.values()), json.dumps({p: sorted(v) for p, v in found.items() if v})
