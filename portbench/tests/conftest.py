"""The benchmark's own tests: ``python -m pytest portbench/tests``.

Tests that need a CUDA card carry the ``card`` marker and skip, inside
the ``card`` fixture, where there is none; on the chip they run with
``python -m pytest portbench/tests -m card``."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tmp_env(tmp_path, monkeypatch):
    """A TMPDIR of the test's own, where a run keeps its work files."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path
