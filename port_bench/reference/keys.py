"""Where each random draw of a training step comes from.

A step has one 64-bit key, the first word of ``SeedSequence([seed,
step])``.  Its draws are numbered in program order by one counter: a
compression tap reserves a block of ``DRAWS`` numbers for its forward
call and the next block for its backward call when the forward reaches
it; a dropout mask takes one number; the optimizer then reserves a block
for every (stage, leaf) of its compressor calls, stage by stage in
``STAGES`` order and leaf by leaf in parameter order.  A compressor call
rounds with the first number of its block.
"""

from __future__ import annotations

import numpy as np

DRAWS = 4
STAGES = ("grad", "weight", "trace", "mu", "nu")


def step_key(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(3, np.uint64)[0])


class Counter:
    """The draw numbers of one step keyed ``key``."""

    def __init__(self, key: int):
        self.key = key
        self.next = 0

    def take(self) -> int:
        call = self.next
        self.next += 1
        return call

    def reserve(self, n: int) -> int:
        start = self.next
        self.next += n
        return start

    def leaf_calls(self, names: list[str]):
        """The optimizer's blocks: a function of (stage, leaf name) giving
        the draw number its compressor call rounds with."""
        index = {n: i for i, n in enumerate(names)}
        base = self.reserve(len(STAGES) * len(index) * DRAWS)
        return lambda stage, name: base + (STAGES.index(stage) * len(index) + index[name]) * DRAWS
