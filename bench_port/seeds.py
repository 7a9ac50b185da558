"""Seeds of one run, derived from ``--seed``: the same seed gives the
same inputs, and no two streams of one run share draws."""

from __future__ import annotations

import numpy as np
import torch

# The streams a run draws from.
START, SOLVER, BLOCK, ORDER = 0, 1, 2, 3
WARMUP = -1  # the index of the warm-up's draws; a pool's count from 0


def derive(seed: int, index: int, stream: int) -> int:
    """A 63-bit seed for draw ``index`` of ``stream`` under ``seed``
    (any whole number, also past 32 bits or negative)."""
    words = [abs(int(seed)), int(seed < 0), int(index) + 2, int(stream)]
    return int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, index: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on ``device`` seeded by ``derive``."""
    return torch.Generator(device=device).manual_seed(
        derive(seed, index, stream))
