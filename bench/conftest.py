"""Test set-up for the benchmark's own tests (``python -m pytest bench``):
the harness's modules and the port import as ``bench/run.py`` sees them."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for path in (BENCH, BENCH.parent / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


@pytest.fixture
def card():
    """The card, for tests marked ``cuda``; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100; this machine has no CUDA device")
    return torch.device("cuda", 0)
