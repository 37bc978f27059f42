"""The benchmark's own tests: ``python -m pytest bench_h100/tests -q`` (the
card's with ``-m cuda`` on a machine that has one). They put the benchmark's
folder and the checkout's root on the path, as ``run.py`` does."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


@pytest.fixture
def card():
    """Skips a test unless a CUDA card is present (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
