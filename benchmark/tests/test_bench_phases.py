"""The readers of the port's spans (benchmark/phases.py) on synthetic
events, as test_bench_harness.py reads the benchmark's: the innermost
span of a launch owns its operation, the benchmark's counting operations
belong to no phase and no launch count, and the benchmark's own readers
give the same values with the port's spans in the trace as without."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, phases, program, run, traceread as trd

E = trd.Event


def _launch(name, t, corr, dev_start, dur):
    """A launch at ``t`` and the device operation it made."""
    return [E("cudaLaunchKernel", False, t, t + 5, corr),
            E(name, True, dev_start, dev_start + dur, corr)]


def _step(t0: int, corr0: int, count: bool = True) -> list:
    """One replayed step from ``t0`` (ns): the port's spans, the
    benchmark's wrappers, and one operation a phase; with ``count`` the
    benchmark's counting operation before each kernel entry."""
    ev = [E("learner.dispatch", False, t0, t0 + 900, 0),
          E("bench.learner.dispatch", False, t0, t0 + 900, 0),
          E("step.pull", False, t0 + 10, t0 + 300, 0),
          E("bench.kernels.gather", False, t0 + 150, t0 + 210, 0),
          E("kernels.gather", False, t0 + 155, t0 + 205, 0),
          E("step.forward", False, t0 + 300, t0 + 400, 0),
          E("step.backward", False, t0 + 400, t0 + 500, 0),
          E("step.push", False, t0 + 500, t0 + 800, 0),
          E("bench.kernels.push", False, t0 + 650, t0 + 700, 0),
          E("kernels.push", False, t0 + 655, t0 + 695, 0)]
    # (operation, launched at, device ns)
    ops = [("unpack", 5, 10), ("rows_to_params", 20, 30),
           ("gather_rows_kernel", 160, 40), ("predict", 310, 50),
           ("calc_grad", 410, 70), ("prep", 510, 20),
           ("scatter_epilogue", 660, 60)]
    c = corr0
    for name, t, dur in ops:
        ev += _launch(name, t0 + t, c, t0 + 1000 + 100 * (c - corr0), dur)
        c += 1
    if count:
        ev += [E("bench.count", False, t0 + 140, t0 + 212, 0),
               E("bench.count", False, t0 + 640, t0 + 702, 0)]
        ev += _launch("reduce_count", t0 + 145, c, t0 + 1800, 7)
        ev += _launch("reduce_count", t0 + 645, c + 1, t0 + 1810, 9)
    return ev


def _trace(count=True, port=True) -> list:
    """Two replayed steps, a fetch and an epoch-end evaluation inside
    the benchmark's window; without ``port`` the port's span events
    are left out (what the parent's program, or traceread's filter,
    leaves)."""
    ev = [E(program.SPAN_WINDOW, False, 0, 10_000, 0)]
    ev += _step(100, 10, count) + _step(3000, 30, count)
    ev += [E("learner.fetch", False, 6000, 6100, 0),
           E("bench.learner.fetch", False, 6000, 6100, 0),
           E("learner.evaluate", False, 6200, 6400, 0),
           E("bench.learner.evaluate", False, 6200, 6400, 0),
           E("learner.report", False, 6500, 6900, 0)]
    ev += _launch("stack", 6010, 50, 6020, 5)
    ev += _launch("evaluate_table", 6210, 51, 6300, 80)
    ev += _launch("evaluate_table", 6510, 52, 6600, 90)
    if port:
        return ev
    return [e for e in ev if e.on_device or e.name.startswith(("bench.",
                                                               "cu"))]


def test_innermost_span_owns_the_operation():
    att = phases.attribute(_trace(count=False))
    ns = att["ns"]
    # per step: the unpack in learner.dispatch alone, the rows' unpack
    # in the pull, the kernel in its entry inside the pull
    assert ns["learner.dispatch"] == 2 * 10
    assert ns["step.pull"] == 2 * 30
    assert ns["kernels.gather"] == 2 * 40
    assert ns["step.forward"] == 2 * 50
    assert ns["step.backward"] == 2 * 70
    assert ns["step.push"] == 2 * 20
    assert ns["kernels.push"] == 2 * 60
    assert ns["learner.fetch"] == 5
    assert ns["learner.evaluate"] == 80 and ns["learner.report"] == 90
    assert None not in ns


def test_bench_count_operations_belong_to_no_phase():
    plain = phases.attribute(_trace(count=False))
    counted = phases.attribute(_trace(count=True))
    assert counted["ns"][phases.SPAN_COUNT] == 2 * (7 + 9)
    for name in phases.PHASES + phases.KERNELS:
        assert counted["ns"][name] == plain["ns"][name], name
    r = phases.readings(counted, steps=2, epochs=1)
    assert r["pull_device_ms"] == 30 / 1e6
    assert r["bench_count_device_ms"] == 16 / 1e6


def test_launches_per_step_count_the_dispatch_only():
    for count in (False, True):
        att = phases.attribute(_trace(count=count))
        # seven operations a step; the fetch's and the evaluations'
        # launches lie outside learner.dispatch, the counting ones are
        # left out
        assert att["dispatch_ops"] == 14
        assert phases.readings(att, 2, 1)["launches_per_step"] == 7


def test_readings_account_for_the_step():
    att = phases.attribute(_trace())
    # the benchmark's step device time: every operation less the two
    # entries' kernels, over the steps
    t = trd.analyze(_trace(), run.KERNEL_SPANS, run.HOST_SPANS)
    step_ms = 1e3 * (t["device_s"] - sum(t["entry_s"].values())) / 2
    r = phases.readings(att, steps=2, epochs=1, step_device_ms=step_ms,
                        fetch={"merge": (0.004, 2), "report": (0.001, 1)})
    assert r["evaluate_device_ms_per_epoch"] == 170 / 1e6
    assert r["fetch_ms.merge"] == 2.0 and r["fetch_ms.report"] == 0.5
    # what is left: each step's unpack in learner.dispatch alone
    left = 2 * 10 / 1e6 / 2
    assert r["accounted_share"] == pytest.approx(
        100 * (1 - left / step_ms))
    assert r["dispatch_other_device_ms"] == pytest.approx(left)


def test_idle_gaps_by_the_port_span():
    ev = [E(program.SPAN_WINDOW, False, 0, 1000, 0),
          E("learner.dispatch", False, 0, 400, 0),
          E("step.pull", False, 20, 90, 0)]
    ev += _launch("a", 50, 1, 100, 100) + _launch("b", 450, 2, 600, 100)
    att = phases.attribute(ev)
    # each gap goes to the innermost span the host was in as it began
    assert att["idle_gaps"] == {"learner.dispatch": 100 + 400, None: 300}
    assert att["ns"] == {"step.pull": 100, None: 100}
    r = phases.readings(att, 1, 1)
    assert r["idle_unowned_share"] == pytest.approx(100 * 300 / 800)
    assert r["idle_gaps_s"][0] == ["learner.dispatch", 500e-9]


def test_a_trace_without_the_ports_spans_reads_none():
    assert phases.readings(phases.attribute(_trace(port=False)), 2, 1) \
        is None
    assert phases.attribute([E("x", True, 0, 1, 0)]) is None


def _ctx(trace: dict) -> dict:
    conf = {"V_dim": 16, "hash_capacity": 1 << 22, "slot_dtype": "fp32"}
    win = program.Window(seconds=2.0, epochs=2, rows=1 << 21, steps=32,
                         dispatch_s=0.07, dispatch_n=32)
    return {"window": win, "conf": conf, "device": "cuda",
            "epoch_tokens": 35_000_000, "epoch_rows": 1 << 20,
            "trace": trace,
            "traced": {"steps": 2, "epochs": 1,
                       "calls": {"gather_real": [140_000, 141_000],
                                 "push_real": [140_000, 141_000],
                                 "push_vm": [90_000, 91_000]}}}


@pytest.mark.parametrize("metric", [m["name"] for m in harness.find_cell(
    "fm16.replay_b65k").per_layer])
def test_existing_readers_ignore_the_ports_spans(metric):
    """Each per-layer reader of the accepted benchmark, and the
    breakdown, read the same from a trace with the port's spans as from
    one without them."""
    reader = harness.metric_reader(metric)
    values = []
    for port in (True, False):
        t = trd.analyze(_trace(port=port), run.KERNEL_SPANS,
                        run.HOST_SPANS)
        values.append((reader(_ctx(t)), t["device_ops"], t["idle_gaps"],
                       t["entry_s"], t["busy_s"]))
    assert values[0] == values[1]
    assert values[0][0] is not None


def test_read_events_keeps_the_ports_spans():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(program.SPAN_WINDOW):
            with record_function("step.pull"):
                with record_function(phases.SPAN_COUNT):
                    torch.ones(4).sum()
            with record_function("elsewhere.range"):
                pass
    names = {e.name for e in phases.read_events(prof)}
    assert {program.SPAN_WINDOW, "step.pull", phases.SPAN_COUNT} <= names
    assert "elsewhere.range" not in names
    # the accepted reader keeps the benchmark's spans alone
    kept = {e.name for e in trd.read_events(prof)}
    assert "step.pull" not in kept and program.SPAN_WINDOW in kept


def test_port_tracer_off_the_chip(tiny_cell, monkeypatch):
    """The tracer of phases.py on a CPU run: the result line as run.py's,
    the port's spans and the counting ranges kept, the kernel entries
    given back, the fetch histogram read over the traced epochs."""
    from difacto_tpu_torch.ops import fused
    entries = (fused.gather_rows, fused.fm_update_rows)
    monkeypatch.setattr(program, "Tracer", phases.PortTracer)
    r = run.run_cell(tiny_cell, 3, 0.0, True, "cpu")
    assert r["correct"] and set(r["metrics"]) == {"dispatch_ms.replay"}
    assert (fused.gather_rows, fused.fm_update_rows) == entries
    tr = phases.PortTracer.last
    names = {e.name for e in tr.port_events}
    assert set(phases.PHASES + phases.KERNELS + phases.EVALUATIONS) \
        | {"learner.dispatch", "learner.fetch", phases.SPAN_COUNT,
           program.SPAN_WINDOW} <= names
    epochs = tr.result["epochs"]
    assert tr.fetch["report"][1] == epochs
    assert tr.fetch["merge"][1] >= epochs
    # no device operation off the chip, so no reading
    assert phases.readings(phases.attribute(tr.port_events),
                           tr.result["steps"], epochs) is None
