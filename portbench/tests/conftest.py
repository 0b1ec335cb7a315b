"""Tests of the port's benchmark, run on the CPU at tiny sizes:

    python -m pytest portbench/tests -q

Tests that need a CUDA card carry the ``cuda`` marker and skip without
one; the decision is taken inside the ``cuda_device`` fixture, never
while a module is imported."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="session")
def manifest():
    from portbench import common

    return common.load_manifest()
