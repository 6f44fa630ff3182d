"""Named regions for ``--profile_dir``.

The JAX package names its regions with ``jax.named_scope``, which costs
nothing when no trace runs.  :func:`scope` is the port's counterpart: a
``torch.profiler.record_function`` while :func:`regions` is on (the
trainer turns it on for the steps it traces), a no-op otherwise, so an
untraced step pays nothing for the names.  The regions:
``compress/forward`` and ``compress/backward`` (the taps,
``inject/tap.py``), ``compress/optimizer_grad``,
``compress/optimizer_weight`` and ``compress/optimizer_momentum`` (the
optimizer step, ``optim/compressed.py``).
"""

from __future__ import annotations

import contextlib

import torch

REGIONS = ("compress/forward", "compress/backward", "compress/optimizer_grad",
           "compress/optimizer_weight", "compress/optimizer_momentum")
_on = False


def scope(name: str):
    """A profiler region named ``name`` while :func:`regions` is on."""
    if _on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def regions():
    """Turn the named regions on for the block."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before
