"""The check that decides ``correct``, through the rest of a run on the
CPU at a tiny size (the harness's look for a chip skipped): sound runs
pass; the lower-precision control and each planted fault fail. Also the
run's refusals: no card, the JAX package loaded."""

from __future__ import annotations

import sys

import pytest

from benchmark import faults, run
from benchmark.calibrate import CONTROL


def _run(cell, **kw):
    return run.run_cell(cell, kw.pop("seed", 2 ** 31 + 11), 0.0, False,
                        "cpu", **kw)


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 7])
def test_sound_runs_pass(tiny_cell, seed):
    r = _run(tiny_cell, seed=seed)
    assert r["correct"], r["check"]
    assert r["attempted"] == 8 and r["failed"] == 0
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"train_rows_per_s", "setup_s"}


def test_control_fails(tiny_cell):
    r = _run(tiny_cell, overrides=CONTROL)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_faults_fail(tiny_cell, name):
    r = _run(tiny_cell, fault=faults.FAULTS[name])
    assert not r["correct"], (name, r["check"])


def test_traced_run_off_the_chip(tiny_cell):
    r = run.run_cell(tiny_cell, 3, 0.0, True, "cpu")
    assert r["correct"]
    # no device, so no device metric: only the learner's own counter
    assert set(r["metrics"]) == {"dispatch_ms.replay"}
    assert "busy_s" not in r["device"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "fm16.replay_b65k", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "difacto_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "difacto_tpu.ops", sys)
    assert run.forbidden_modules() == ["difacto_tpu"]
