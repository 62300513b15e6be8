"""A fixed set of token sequences, sent a batch at a time, one batch after
another (a closed loop of uncached forwards).  Parameters: ``batch``
(sequences a forward), ``sequences`` (how many distinct ones, a multiple of
``batch``) and ``length`` (tokens each); ids uniform over the vocabulary."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

STREAM = 1   # the generator's stream of ``--seed``


def make(params: Dict, seed: int, vocab: int) -> List[np.ndarray]:
    """The distinct batches, each (batch, length)."""
    batch, n = int(params["batch"]), int(params["sequences"])
    if n % batch:
        raise ValueError(f"sequences {n} is not a multiple of batch {batch}")
    rng = np.random.default_rng([int(seed), STREAM])
    return [rng.integers(0, vocab, size=(batch, int(params["length"])), dtype=np.int64)
            for _ in range(n // batch)]
