"""Tests of the benchmark. Those that need the card take the ``card``
fixture, which decides inside the test whether there is one and skips on
the CPU; they carry the ``card`` marker. Run them on the card with
``python3 -m pytest portbench/tests -m card``."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the check's control runs at the "
                    "cell's own sizes")
    return torch.device("cuda")
