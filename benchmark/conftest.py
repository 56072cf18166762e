"""Tests of the benchmark (``benchmark/tests``): the repository's root on
the path, and the ``card`` marker for tests that need a CUDA card, which
skip inside their fixture where there is none."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one); run on the "
        "card with python -m pytest benchmark/tests -m card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
