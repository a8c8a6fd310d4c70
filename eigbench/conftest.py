"""pytest settings of the benchmark's own tests (``pytest eigbench``).

Tests marked ``chip`` need an NVIDIA card: they ask for the ``card``
fixture, which decides inside the test whether one is present and skips
with a reason where none is.  On the card they run with
``python3 -m pytest eigbench -m chip``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (runs at the cells' size)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: PyTorch sees no CUDA device")
    return "cuda"
