"""The benchmark's own tests (`python -m pytest portbench/tests -q`): CPU
tests of the content, the metric arithmetic, the frozen bounds, the last
line and the reference; the tests marked `cuda` need the card and skip
without it (decided inside each test)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return "cuda"
