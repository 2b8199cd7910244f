"""On the card, at the cell's own size: a sound run of each cell passes
its check and the lower-precision control (the program's bf16 table)
fails it. Skips without a card."""

from __future__ import annotations

import pytest

from benchmark import harness, run
from benchmark.calibrate import CONTROL

CELLS = ["fm16.replay_b65k", "fm64.replay_b65k"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_passes(cuda_device, workload):
    r = run.run_cell(harness.find_cell(workload), 2 ** 31 + 101, 0.0,
                     False, cuda_device)
    assert r["correct"], r["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(cuda_device, workload):
    r = run.run_cell(harness.find_cell(workload), 2 ** 31 + 101, 0.0,
                     False, cuda_device, overrides=CONTROL)
    assert not r["correct"], r["check"]
