"""Tests of the benchmark (``benchmark/``), run apart from the repository's
suite: ``python -m pytest benchmark/tests -q`` from the root. Tests that
need the card carry the ``card`` marker and skip here; on a machine with
the card: ``python -m pytest benchmark/tests -q -m card``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present; decided when the
    test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda", 0)
