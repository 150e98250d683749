"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository root (the card's tests skip without a CUDA card; on the card
``python3 -m pytest -p no:cacheprovider benchmark/tests -q -m gpu``)."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
