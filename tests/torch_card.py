"""Fixture for the port's tests that need a CUDA card.

The decision is taken when the fixture runs, never at import, so every
test worker collects the same tests.
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return torch.device("cuda")
