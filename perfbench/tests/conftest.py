"""The benchmark's own tests (run them with ``python -m pytest perfbench/tests``
from the checkout's root). A test that needs the card carries the ``card``
marker and skips, with its reason, where there is none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the H100)")


@pytest.fixture
def card():
    """The card's device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
