"""pytest settings for the benchmark's own tests (``perfbench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which skips them where no card is visible; they run on the chip
with ``python -m pytest perfbench/tests -m card``.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
