"""Batches of requests from one caller that waits for each batch (a closed
loop).  Parameters: ``batch`` (requests a batch), the prompt lengths'
lognormal (its mean ``prompt_mean`` and shape ``prompt_sigma``, clipped to
[``prompt_min``, ``prompt_max``]) and ``max_new_tokens``, every token
chosen greedily.

Every batch holds the same multiset of prompt lengths, the lognormal's
quantiles at (i + 1/2) / batch, in an order drawn from the seed, so seeds
change the order and the token ids (uniform over the vocabulary), never
the amount of work."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np

STREAM = 2   # the generator's stream of ``--seed``


def lengths(params: Dict) -> List[int]:
    n = int(params["batch"])
    sigma = float(params["prompt_sigma"])
    mu = math.log(float(params["prompt_mean"])) - sigma * sigma / 2
    z = statistics.NormalDist()
    return [int(min(max(round(math.exp(mu + sigma * z.inv_cdf((i + 0.5) / n))),
                        int(params["prompt_min"])), int(params["prompt_max"])))
            for i in range(n)]


class Batches:
    """``next()`` gives the next batch: a list of prompts (lists of ids)."""

    def __init__(self, params: Dict, seed: int, vocab: int, stream: int = 0):
        self.params = params
        self.vocab = vocab
        self.lengths = np.asarray(lengths(params))
        self.rng = np.random.default_rng([int(seed), STREAM, stream])

    def next(self) -> List[List[int]]:
        lens = self.rng.permutation(self.lengths)
        return [self.rng.integers(0, self.vocab, size=int(n)).tolist() for n in lens]
