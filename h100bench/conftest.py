"""The benchmark's tests: its modules and the port importable, and the
``cuda`` marker for tests that need the card."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for _p in (str(HERE), str(HERE.parent / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (a hand-written kernel has no "
        "CPU build); skipped where there is none")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
