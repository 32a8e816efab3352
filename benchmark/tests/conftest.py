"""Tests of the benchmark's harness, on the CPU; those marked ``cuda`` need
the card and skip elsewhere (``cuda_card``).  Run from the repository root:

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

for p in (Path(__file__).resolve().parents[1], Path(__file__).resolve().parents[2]):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda_card():
    """The card's device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
