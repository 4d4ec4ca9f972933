"""Tests of the benchmark itself, run from the repository root with
``python -m pytest benchmark/tests -q``.  Those that need the card carry
the ``card`` marker and skip, inside the ``card`` fixture, where there is
none; run them on a machine with an H100 by the same command."""
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an NVIDIA H100); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
