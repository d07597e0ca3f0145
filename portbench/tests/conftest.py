"""The benchmark's own tests (run as ``python -m pytest portbench/tests``;
the suite under ``tests/`` does not collect them). Cases that need a card
carry the ``cuda`` marker and decide in the ``card`` fixture."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
