"""The benchmark's own tests (CPU; the ``cuda`` ones skip without a card):

    python -m pytest portbench/tests -q

The checkout's root and ``src`` go on the path, as ``run.py`` puts them."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")
