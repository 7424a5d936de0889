"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of the checkout. Tests that need a CUDA card carry the ``card``
marker and skip without one; on the card: ``python -m pytest
portbench/tests -q -m card``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: tiny sizes for CPU runs of each configuration
TINY = {
    "delta_50k": {"n_pods": 1500, "n_types": 20},
    "cells_500k": {"n_pods": 2400, "n_cells": 4, "n_types": 20},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test reads the control on the card")
    return "cuda"


@pytest.fixture(scope="session")
def bench():
    import json

    return json.loads((ROOT / "BENCHMARK.json").read_text())
