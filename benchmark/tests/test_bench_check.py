"""The check that decides ``correct``, through the rest of a run on the
CPU at a tiny size (the harness's look for a chip skipped), for the
fused-row FM and for a ``V_dim`` 0 linear copy on the flat table: sound
runs pass; the configuration's lower-precision control and each planted
fault fail. Also the run's refusals: no card, the JAX package loaded."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from benchmark import calibrate, check, faults, harness, program, run


@pytest.fixture(params=["fm", "lr"])
def cell(request, tiny_cell):
    """The tiny cell as it is (FM, V_dim 4), or its linear copy at
    V_dim 0, whose table is flat columns (w, z, sqrt_g, cnt)."""
    if request.param == "lr":
        tiny_cell.cfg["conf"]["V_dim"] = 0
    return tiny_cell


def _run(cell, **kw):
    return run.run_cell(cell, kw.pop("seed", 2 ** 31 + 11), 0.0, False,
                        "cpu", **kw)


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 7])
def test_sound_runs_pass(cell, seed):
    r = _run(cell, seed=seed)
    assert r["correct"], r["check"]
    assert r["attempted"] == 8 and r["failed"] == 0
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"train_rows_per_s", "setup_s"}


def test_control_fails(cell):
    name, overrides, planted = faults.control(cell.conf)
    flat = cell.conf["V_dim"] == 0
    assert name == ("control_bf16_flat" if flat else "control_bf16")
    r = _run(cell, overrides=overrides, fault=planted)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_faults_fail(cell, name):
    r = _run(cell, fault=faults.FAULTS[name])
    assert not r["correct"], (name, r["check"])


def test_traced_run_off_the_chip(cell):
    r = run.run_cell(cell, 3, 0.0, True, "cpu")
    assert r["correct"]
    # no device, so no device metric: only the learner's own counter
    assert set(r["metrics"]) == {"dispatch_ms.replay"}
    assert "busy_s" not in r["device"]


@pytest.mark.parametrize("planted", ["flat_bf16", "nothing"])
def test_calibration_refuses_a_control_that_changed_nothing(
        tiny_cell, monkeypatch, capsys, planted):
    """A control whose table kept the sound run's dtype and values is
    refused: its line carries no readings and the exit code is 1."""
    tiny_cell.cfg["conf"]["V_dim"] = 0
    cpu = run.run_cell
    monkeypatch.setattr(harness, "find_cell", lambda name: tiny_cell)
    monkeypatch.setattr(run, "run_cell", lambda cell, seed, s, t, dev, **kw:
                        cpu(cell, seed, s, t, "cpu", **kw))
    if planted == "nothing":
        monkeypatch.setattr(faults, "control",
                            lambda conf: ("control_none", None, None))
    rc = calibrate.main(["--workload", "tiny", "--control-seeds", "5"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["what"] for x in lines] == [
        "program", "control_bf16_flat" if planted == "flat_bf16"
        else "control_none"]
    assert lines[0]["correct"]
    if planted == "nothing":
        assert rc == 1 and lines[1]["refused"] and not lines[1]["check"]
    else:
        assert rc == 0 and lines[1]["correct"] is False


def test_readings_finite_without_V():
    """At V_dim 0 the V leaf's norms are 0 on both sides: the gaps stay
    finite and judge w alone."""
    ref = {"objv": [2.0, 1.5], "grad": {"w": 4.0, "V": 0.0},
           "change": {"w": 0.5, "V": 0.0}}
    prog = {"objv": [2.0, 1.5], "grad": {"w": 4.4, "V": 0.0},
            "change": {"w": 0.45, "V": 0.0}}
    got = check.readings(prog, ref)
    assert got == pytest.approx({"loss_gap": 0.0, "grad_gap": 0.1,
                                 "change_gap": 0.1})


class ParentRecorder(program.Recorder):
    """The recorder as it was before it followed the flat table: it
    copied ``state.VVg``'s raw rows alone."""

    def prepare(self):
        table = self.learner.store.state.VVg
        u = max(st.u_cap for c in self.learner._caches.values()
                for v in c.entries.values() for st in v)
        self._bufs = [(torch.empty(u, dtype=torch.int64),
                       torch.empty((u,) + tuple(table.shape[1:]),
                                   dtype=table.dtype))
                      for _ in range(2 * len(self.followed) + 1)]

    def _copy(self, kind, table, idx):
        ids, rows_h = self._bufs.pop()
        n = idx.shape[0]
        rows = table.index_select(0, idx.clamp(0, self.capacity - 1))
        ids, rows_h = ids[:n], rows_h[:n]
        ids.copy_(idx)
        rows_h.copy_(rows)
        self.copies[kind].append((ids, rows_h))

    def _wrapped(self, state, batch, slots):
        i = self.step
        self.step += 1
        if i not in self.followed:
            out = self._orig(state, batch, slots)
            self.objv.append(out[1])
            return out
        idx = slots.to(torch.int64)
        self._copy("pre", state.VVg, idx)
        out = self._orig(state, batch, slots)
        self.objv.append(out[1])
        self._idx.append(idx)
        if i == self.followed[0]:
            self._copy("first", out[0].VVg, idx)
        if i == self.followed[-1]:
            for j in self._idx:
                self._copy("last", out[0].VVg, j)
            self._idx = []
            self.learner._train_step = self._orig
        return out

    def _logical(self, kind):
        su, state = self._su, self.learner.store.state
        out = []
        for ids, rows in self.copies[kind]:
            keep = (ids >= 0) & (ids < self.capacity)
            sub = state._replace(VVg=rows[keep].to(state.VVg.device))
            w, _, sg, _, _ = su.scal_cols(self.param, sub, self.capacity)
            V, Vg = su.emb_cols_f32(self.param, sub, self.capacity)
            out.append((ids[keep].numpy(),
                        {k: v.to(torch.float64).cpu().numpy()
                         for k, v in (("w", w), ("sg", sg), ("V", V),
                                      ("Vg", Vg))}))
        return out


def _recorded(cell, monkeypatch, recorder):
    got = {}
    monkeypatch.setattr(program, "Recorder", recorder)
    _run(cell, seed=2 ** 31 + 29,
         on_recorded=lambda rec, recorded: got.update(recorded))
    return got


def test_fused_recorder_reads_as_the_parents(tiny_cell, monkeypatch):
    want = _recorded(tiny_cell, monkeypatch, ParentRecorder)
    got = _recorded(tiny_cell, monkeypatch, program.Recorder)
    assert list(got) == list(want)
    assert got["objv"] == want["objv"]
    for key in ("union", "first_slots"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("before", "first_before", "first_after", "after"):
        assert list(got[key]) == list(want[key])
        for leaf in want[key]:
            np.testing.assert_array_equal(got[key][leaf], want[key][leaf])


def test_no_card_no_result(monkeypatch, capsys):
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

