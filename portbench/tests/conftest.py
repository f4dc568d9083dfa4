"""The benchmark's CPU tests: `python -m pytest portbench/tests -q` from
the root of the repository. Tests marked `cuda` need the card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
