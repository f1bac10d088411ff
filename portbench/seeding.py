"""Seeds of the benchmark's random draws."""

from __future__ import annotations

import numpy as np


def entry_seed(seed: int, index: int) -> int:
    """A 63-bit seed for pool entry `index` of a run seeded `seed`: any
    whole number, however large or negative, gives its own stream."""
    words = [int(seed) % 2**64, int(index)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))
