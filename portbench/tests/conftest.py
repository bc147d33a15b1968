"""The benchmark's own tests: `python -m pytest portbench/tests` (on the
CPU, at tiny sizes). Tests marked `cuda` need a card and skip without
one, deciding in a fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
