"""Fixtures of the benchmark's own tests: a tiny copy of a cell for runs
on the CPU, and the card for the tests marked ``cuda``."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs: skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def tiny_cell():
    """``fm16.replay_b65k`` cut to run on the CPU in seconds: V_dim 4, a
    65,536-row table, 8 batches of 1,024 rows in shuffle buffers of two
    batches; its limits as the cell's."""
    from benchmark import harness
    cell = harness.find_cell("fm16.replay_b65k")
    cell.cfg = copy.deepcopy(cell.cfg)
    cell.cfg["conf"].update(V_dim=4, hash_capacity=1 << 16,
                            batch_size=1024, shuffle=2)
    cell.cfg["epoch_rows"] = 8192
    cell.traffic = dict(cell.traffic, trace_epochs=2)
    return cell
