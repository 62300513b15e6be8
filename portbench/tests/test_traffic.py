"""The traffic generators: one seed gives the same inputs, two seeds give
different ones, and every seed the same amount of work."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.traffic import batches, sequences

SEQ = {"kind": "sequences", "batch": 2, "sequences": 4, "length": 50}
BATCH = {"kind": "batches", "batch": 16, "prompt_mean": 24, "prompt_sigma": 0.8,
         "prompt_min": 4, "prompt_max": 64, "max_new_tokens": 8}
BIG = 2 ** 31 + 11


def test_sequences_repeat_for_a_seed():
    a, b = sequences.make(SEQ, BIG, 1000), sequences.make(SEQ, BIG, 1000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = sequences.make(SEQ, BIG + 1, 1000)
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert len(a) == 2 and all(x.shape == (2, 50) and x.max() < 1000 for x in a)


def test_sequences_fill_whole_batches():
    with pytest.raises(ValueError):
        sequences.make(dict(SEQ, sequences=3), BIG, 1000)


def test_batches_repeat_for_a_seed_and_differ_between_seeds():
    a, b, c = (batches.Batches(BATCH, s, 1000) for s in (BIG, BIG, BIG + 1))
    for _ in range(3):
        x, y, z = a.next(), b.next(), c.next()
        assert x == y
        assert x != z
        assert sorted(map(len, x)) == sorted(map(len, z)) == sorted(batches.lengths(BATCH))


def test_streams_differ():
    assert batches.Batches(BATCH, BIG, 1000, 1).next() != batches.Batches(BATCH, BIG, 1000).next()
