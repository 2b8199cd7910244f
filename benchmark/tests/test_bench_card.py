"""On the card, at the cell's own size: a sound run of each cell passes
its check and the configuration's lower-precision control fails it; the
same for fm16's cell run as the linear model (``V_dim`` 0, the flat
table). Skips without a card."""

from __future__ import annotations

import pytest

from benchmark import faults, harness, run

CASES = [("fm16.replay_b65k", {}), ("fm64.replay_b65k", {}),
         ("fm16.replay_b65k", {"V_dim": 0})]
IDS = ["fm16.replay_b65k", "fm64.replay_b65k", "fm16.replay_b65k-V_dim0"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,keys", CASES, ids=IDS)
def test_sound_run_passes(cuda_device, workload, keys):
    r = run.run_cell(harness.find_cell(workload), 2 ** 31 + 101, 0.0,
                     False, cuda_device, overrides=keys)
    assert r["correct"], r["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,keys", CASES, ids=IDS)
def test_control_fails(cuda_device, workload, keys):
    cell = harness.find_cell(workload)
    _, overrides, planted = faults.control({**cell.conf, **keys})
    r = run.run_cell(cell, 2 ** 31 + 101, 0.0, False, cuda_device,
                     overrides={**keys, **(overrides or {})}, fault=planted)
    assert not r["correct"], r["check"]
