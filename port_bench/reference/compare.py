"""The numbers that decide ``correct``: the program's first steps against
the reference's (the check's eager steps, then two groups of K: the
K-step graph's eager warm-up and capture, and its first replay, the call
the window makes).  Each is a widest gap:

- ``loss_gap``: over every step compared, ``|loss - reference loss|`` as a
  share of the reference's;
- ``grad_gap``: over the leaves, the gap between the program's norm of a
  leaf's first momentum buffer after the first step (SGD's trace, Adam's
  mu: the first gradient as the optimizer got it, quantized, scaled by
  ``1 - b1`` for Adam) and the reference's, as a share of the reference's
  norm of that leaf or of the median leaf, whichever is larger;
- ``update_gap``: the same of each leaf's change from its initial value,
  the worse of its readings after the check's eager steps and after the
  first replay;
- ``group_unmoved``: the share of the leaves that the first replay of the
  K-step graph left exactly as they were.

Leaves whose first raw gradient in the reference is under ``RULE`` of the
median leaf's (zero to rounding: a key's bias under the softmax) move by
round-off alone and are left out of the last three.
"""

from __future__ import annotations

import statistics

import torch

RULE = 1e-3


def norms(tree: dict, minus: dict | None = None) -> dict[str, float]:
    """Float64 norms of each leaf (of ``tree - minus``, ``minus`` brought to
    ``tree``'s device one leaf at a time)."""
    out = {}
    for k, v in tree.items():
        d = v.double() if minus is None else v.double() - minus[k].to(v.device).double()
        out[k] = float(torch.linalg.vector_norm(d))
    return out


def kept(grad_norms: dict[str, float]) -> list[str]:
    med = statistics.median(grad_norms.values())
    return [k for k, g in grad_norms.items() if g >= RULE * med]


def norm_gap(prog: dict[str, float], ref: dict[str, float], keep: list[str]) -> tuple[float, str]:
    med = statistics.median(ref[k] for k in keep)
    worst, where = -1.0, ""
    for k in keep:
        scale = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / scale if scale > 0 else abs(prog[k] - ref[k])
        if gap > worst:
            worst, where = gap, k
    return worst, where


def gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses``, ``grad`` (leaf -> norm)
    and ``updates`` (steps taken -> leaf -> norm of the change); ``prog``
    also ``moved`` (leaf -> bool, over the first replay), ``ref`` also
    ``grad_norms``.  Every step and every reading of ``prog`` is compared:
    the reference has to have followed as far.  Returns each number and
    where it was read."""
    keep = kept(ref["grad_norms"])
    if len(ref["losses"]) < len(prog["losses"]) or set(prog["updates"]) - set(ref["updates"]):
        raise ValueError("the reference stopped before the program's readings")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = norm_gap(prog["grad"], ref["grad"], keep)
    upd_gap, upd_leaf = -1.0, ""
    for n, v in prog["updates"].items():
        gap, leaf = norm_gap(v, ref["updates"][n], keep)
        if gap > upd_gap:
            upd_gap, upd_leaf = gap, f"{leaf} after {n} steps"
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": upd_gap,
           "at": {"grad_gap": grad_leaf, "update_gap": upd_leaf},
           "leaves_left_out": sorted(set(ref["grad_norms"]) - set(keep))}
    if "moved" in prog:
        out["group_unmoved"] = sum(not prog["moved"][k] for k in keep) / len(keep)
    return out
