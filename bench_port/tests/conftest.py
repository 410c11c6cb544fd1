"""Tests of the benchmark harness (`python -m pytest bench_port/tests`).

They run on the CPU at small sizes; the cases marked `cuda` need the card
and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips on a host without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
