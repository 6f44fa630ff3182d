"""The reference's first training steps of a data-parallel cell: W ranks
simulated one after another on one device.

Each rank takes its rows of the global batch and trains on them with keys
of its own for its taps, dropout and augmentation; the ranks' gradients
are averaged through an int8 sum on the headroom grid; the optimizer then
steps once, as every rank does, from the step's shared key.  A step's
words (64-bit keys, from ``SeedSequence``):

- the taps' and the augmentation's word, and dropout's: ``[seed, step, 1,
  rank]``, its first two words;
- the gradient payload's rounding: ``[seed, step, 2]``;
- the optimizer's: the step key ``[seed, step]``, its draws numbered from 0;
- each rank's augmentation generator: ``[seed, 4, rank]``.

The exchange (``psum`` on an int8 payload, per chunk of 1024 elements of
the leaves laid end to end, each leaf zero-padded to whole chunks): a
chunk's scale is the largest magnitude over all ranks over ``per_int =
(2^(bits-1) - 1) // W``; each rank's chunk is divided by it, clipped to
``[-per_int, per_int]``, rounded stochastically with the payload word's
first draw (one uniform a payload element, the same on every rank) and
clipped again; the int8 codes are summed over the ranks and scaled back
by ``scale / W``, with ``1 / per_int`` and ``1 / W`` as float32
reciprocals.  The step's loss is the mean of the ranks' losses.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import philox
from port_bench.reference.keys import Counter, step_key
from port_bench.reference.optim import Hyper, init_state, step as optim_step
from port_bench.reference.step import Step
from port_bench.reference.train import DTYPES, loss_of, model_of, products

CHUNK = 1024


def words(*entropy: int, n: int = 1) -> list[int]:
    return [int(w) for w in np.random.SeedSequence(list(entropy)).generate_state(n, np.uint64)]


def recip(*consts: int) -> float:
    """The float32 product of the float32 reciprocals of ``consts``."""
    out = np.float32(1.0)
    for c in consts:
        out = np.float32(out * (np.float32(1.0) / np.float32(c)))
    return float(out)


def augment_seed(seed: int, rank: int) -> int:
    return words(seed, 4, rank)[0]


def _chunks(tree: dict) -> tuple[torch.Tensor, list]:
    parts, spans, at = [], [], 0
    for name, x in tree.items():
        flat = x.reshape(-1).float()
        pad = (-flat.numel()) % CHUNK
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        c = flat.reshape(-1, CHUNK)
        parts.append(c)
        spans.append((name, at, c.shape[0]))
        at += c.shape[0]
    return torch.cat(parts), spans


def psum_mean(grads: list[dict], payload_key: int, bits: int) -> dict:
    """The mean of the ranks' gradient trees through the int8 payload."""
    n = len(grads)
    per_int = max((2 ** (bits - 1) - 1) // n, 1)
    chunks = []
    for g in grads:
        c, spans = _chunks(g)
        chunks.append(c)
    global_max = torch.stack([c.abs().amax(dim=-1, keepdim=True) for c in chunks]).amax(0)
    safe = torch.where(global_max == 0.0, 1.0, global_max)
    scale = safe * recip(per_int)
    u = philox.uniform(chunks[0].numel(), payload_key, 0, chunks[0].device).view(
        chunks[0].shape)
    total = torch.zeros(chunks[0].shape, dtype=torch.int8, device=chunks[0].device)
    for c in chunks:
        t = (c / scale).clamp(-per_int, per_int)
        f = torch.floor(t)
        q = (f + ((t - f) > u).to(torch.float32)).clamp(-per_int, per_int).to(torch.int8)
        total += q
    mean = total.float() * (safe * recip(per_int, n))
    ref = grads[0]
    return {name: mean[a:a + k].reshape(-1)[:ref[name].numel()].reshape(ref[name].shape)
            for name, a, k in spans}


def follow_dp(cfg: dict, hp: Hyper, smaq, dtype: str, seed: int, params0: dict,
              rank_batches: list, steps: int, precision: str, bits: int,
              fault: str | None = None, keep_at: tuple = ()) -> dict:
    """``steps`` data-parallel steps over ``len(rank_batches[0])`` ranks;
    ``rank_batches[s][r]`` is rank r's prepared rows of step s.  ``fault``
    plants one: ``half_batch`` (each rank's loss over the first half of its
    rows) or ``no_exchange`` (rank 0 steps on its own gradient);
    ``params_at`` holds the parameters after each step count of
    ``keep_at``."""
    model = model_of(cfg)
    device = next(iter(params0.values())).device
    params = {k: v.clone() for k, v in params0.items()}
    state = init_state(hp, params)
    losses, grad_norms, first, params_at = [], None, None, {}
    with products(precision):
        for s in range(steps):
            grads, rank_losses = [], []
            for r, (x, y) in enumerate(rank_batches[s]):
                fwd, drop = words(seed, s, 1, r, n=2)
                ctx = Step(fwd, smaq, device, precision, dropout_key=drop)
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                loss = loss_of(model, model.forward(cfg, leaves, x, ctx, DTYPES[dtype]), y,
                               fault == "half_batch")
                loss.backward()
                grads.append({k: v.grad for k, v in leaves.items()})
                rank_losses.append(loss.detach())
                del leaves, loss
            if grad_norms is None:
                grad_norms = {k: float((sum(g[k].double() for g in grads) / len(grads)).norm())
                              for k in params}
            mean = grads[0] if fault == "no_exchange" else psum_mean(grads, words(seed, s, 2)[0],
                                                                      bits)
            losses.append(float(torch.stack(rank_losses).sum() * recip(len(grads))))
            key = step_key(seed, s)
            opt = Counter(key)
            ctx = Step(key, smaq, device, precision)
            with torch.no_grad():
                params, state = optim_step(hp, params, mean, state, s, smaq,
                                           opt.leaf_calls(list(params)), ctx.noise,
                                           cfg["weight_exempt"])
            if first is None:
                first = state[hp.buffers()[0][0]]
            if s + 1 in keep_at:
                params_at[s + 1] = params
            del grads, mean
    return {"losses": losses, "grad_norms": grad_norms, "first_buffer": first, "params": params,
            "params_at": params_at}
