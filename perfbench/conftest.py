"""pytest settings of the benchmark's own tests: the ``card`` marker and
its fixture. A test that needs an NVIDIA card takes the ``card`` fixture,
which decides at run time, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
