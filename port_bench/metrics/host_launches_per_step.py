"""``host_launches_per_step``: the host's kernel launch calls and CUDA
graph launches a training step (a replay of K steps counts once for K)."""

from port_bench.trace import HOST_LAUNCHES


def read(rec):
    calls = sum(1 for name, _, _, _ in rec.host_ops if name in HOST_LAUNCHES)
    return calls / rec.steps
