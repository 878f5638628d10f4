"""Tests of the benchmark harness.  On the CPU they cover discovery, the
roofline counts, the trace arithmetic, the reference, the check and its
control, and the run's refusal without a card; the tests marked ``cuda``
run a cell on the card and skip elsewhere, deciding inside a fixture."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
