"""The port's own spans (obs/trace.py) under any running profiler, on the
profiler's clock, and the learner's fetch histogram:

- under a CPU ``torch.profiler`` session started by the caller, a short
  SGD run (epoch 0 streamed, epoch 1 replayed) holds every span of the
  learner, the step and the kernel entries, nested as the step nests
  them;
- with no profiler and no span file a span is the shared no-op: no
  ``record_function`` is entered, and the run's table and objectives
  equal those of a run under a profiler bit for bit;
- with the span file on and a profiler running, a span's file ``ts``
  and its profiler event's start agree within 1 ms, and a span recorded
  in another process stamps the same realtime clock;
- the step mark and NVTX ranges stay with the module's own session; a
  span survives a profiler stopped or started inside it;
- ``train_fetch_seconds{site=merge}`` counts every metric fetch and
  ``{site=report}`` every progress row's table evaluation.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.obs import trace
from difacto_tpu_torch.utils import devtrace

REPO = pathlib.Path(__file__).resolve().parent.parent
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")

# the spans of a training run, each with the spans it may lie inside
# (the epoch-0 count push gathers its rows too)
NESTED = [("learner.dispatch", ()), ("learner.fetch", ()),
          ("learner.evaluate", ()), ("learner.report", ()),
          ("learner.epoch_end", ()), ("epoch", ()),
          ("step.count", ("learner.dispatch",)),
          ("step.pull", ("learner.dispatch",)),
          ("step.forward", ("learner.dispatch",)),
          ("step.backward", ("learner.dispatch",)),
          ("step.push", ("learner.dispatch",)),
          ("kernels.gather", ("step.pull", "step.count")),
          ("kernels.push", ("step.push",))]


def _learner():
    ln = SGDLearner(device="cpu")
    ln.init([("data_in", RCV1), ("V_dim", "2"), ("hash_capacity", "4096"),
             ("batch_size", "20"), ("max_num_epochs", "2"),
             ("num_producers", "1"), ("producer_mode", "thread"),
             ("stop_rel_objv", "0")])
    return ln


def _run(ln):
    """Run the learner; returns its objectives, step by step."""
    objv = []
    step = ln._train_step

    def kept(*a):
        out = step(*a)
        objv.append(out[1].clone())
        return out

    ln._train_step = kept
    ln.run()
    return torch.stack(objv).numpy()


def _ranges(prof):
    """The host ranges of a profile: {name: [(start_ns, end_ns)]}."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


@pytest.fixture(scope="module")
def profiled_run():
    """A run under a profiler the caller started: its ranges, its table
    and its objectives."""
    assert not trace.active()
    ln = _learner()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        objv = _run(ln)
    return _ranges(prof), ln.store.state.VVg.numpy().copy(), objv


@pytest.mark.parametrize("name,parents", NESTED,
                         ids=[n for n, _ in NESTED])
def test_every_span_under_a_callers_profiler(profiled_run, name, parents):
    ranges = profiled_run[0]
    assert ranges.get(name), f"no {name} range"
    if not parents:
        return
    outer = [iv for p in parents for iv in ranges[p]]
    for a, b in ranges[name]:
        assert any(p <= a and b <= q for p, q in outer), \
            f"{name} at {a} lies in none of {parents}"


def test_the_replayed_step_makes_seven_spans(profiled_run):
    ranges = profiled_run[0]
    streamed = ranges["consumer.dispatch"]
    replayed = [(a, b) for a, b in ranges["learner.dispatch"]
                if not any(p <= a and b <= q for p, q in streamed)]
    # epoch 1 replays as many steps as epoch 0 streamed, with no count
    # push
    assert len(replayed) == len(streamed) > 0
    assert len(ranges["step.count"]) == len(streamed)
    every = [(n, a, b) for n, iv in ranges.items() for a, b in iv]
    for p, q in replayed:
        inside = sorted(n for n, a, b in every if p <= a and b <= q)
        assert inside == sorted(
            ["learner.dispatch", "step.pull", "kernels.gather",
             "step.forward", "step.backward", "step.push",
             "kernels.push"])


def test_off_a_span_is_the_shared_noop(monkeypatch):
    assert not trace.active() and not trace.profiling()
    entered = []

    def counting(*a, **k):
        entered.append(a)
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    assert trace.span("a.b", part=1) is trace.span("c.d")
    with trace.span("a.b") as sid:
        assert sid == 0


def test_off_enters_no_range_and_keeps_the_trajectory(monkeypatch,
                                                      profiled_run):
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **k):
        entered.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    ln = _learner()
    objv = _run(ln)
    assert entered == []
    _, table, objv_prof = profiled_run
    assert ln.store.state.VVg.numpy().tobytes() == table.tobytes()
    assert objv.tobytes() == objv_prof.tobytes()


@pytest.fixture
def span_file():
    trace.drain_events()
    trace.start()
    try:
        yield
    finally:
        trace.stop()
        trace.drain_events()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_span_file_shares_the_profilers_clock(span_file, depth):
    names = [f"clock.level{i}" for i in range(depth)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span(names[0]):
                if depth > 1:
                    with trace.span(names[1]):
                        if depth > 2:
                            with trace.span(names[2]):
                                torch.ones(8).sum()
            time.sleep(0.002)
    ranges = _ranges(prof)
    events = [e for e in trace.drain_events() if e["name"] in names]
    assert len(events) == 3 * depth
    for name in names:
        starts = sorted(a for a, _ in ranges[name])
        mine = sorted(e["ts"] * 1e3 for e in events if e["name"] == name)
        assert len(starts) == len(mine) == 3
        for a, t in zip(starts, mine):
            assert abs(a - t) < 1e6, (name, a, t)


def test_a_worker_process_stamps_the_same_clock(tmp_path):
    code = ("import json, sys\n"
            "from difacto_tpu_torch.obs import trace\n"
            "with trace.span('worker.part', part=1):\n"
            "    pass\n"
            "json.dump(trace.drain_events(), open(sys.argv[1], 'w'))\n")
    out = tmp_path / "events.json"
    env = dict(os.environ, DIFACTO_OBS_CHILD="1", DIFACTO_TRACE="x",
               PYTHONPATH=str(REPO))
    env.pop("DIFACTO_TRACE_DEVICE", None)
    t0 = time.time_ns()
    r = subprocess.run([sys.executable, "-c", code, str(out)],
                       cwd=str(REPO), env=env, capture_output=True,
                       text=True, timeout=300)
    t1 = time.time_ns()
    assert r.returncode == 0, r.stderr[-2000:]
    import json
    (ev,) = json.loads(out.read_text())
    assert ev["name"] == "worker.part"
    assert t0 <= ev["ts"] * 1e3 <= t1


def test_step_mark_stays_with_the_modules_own_session(span_file):
    assert trace._prof is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("marked", step_num=4):
            torch.ones(2).sum()
    ranges = _ranges(prof)
    assert "marked" in ranges
    assert not any(n.startswith("ProfilerStep#") for n in ranges)


def test_a_profiler_stopped_or_started_inside_a_span(span_file):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with trace.span("outer.stop"):
        prof.stop()
    with trace.span("outer.start"):
        prof2 = profile(activities=[ProfilerActivity.CPU])
        prof2.start()
    prof2.stop()
    # the span file holds both; whether the profiler keeps a range it
    # saw open but not closed differs between torch versions
    names = [e["name"] for e in trace.drain_events()]
    assert names == ["outer.stop", "outer.start"]


def test_fetch_histogram_counts_every_fetch(monkeypatch):
    fetches, evals = [], []
    fetch = devtrace.fetch

    def counted(x, point):
        fetches.append(point)
        return fetch(x, point=point)

    monkeypatch.setattr(devtrace, "fetch", counted)
    ln = _learner()
    evaluate = ln.store.evaluate

    def counted_eval():
        evals.append(1)
        return evaluate()

    ln.store.evaluate = counted_eval
    _run(ln)
    series = ln.obs.snapshot()["hists"]["train_fetch_seconds"]
    merge = series[(("site", "merge"),)]
    report = series[(("site", "report"),)]
    assert fetches and sum(merge["counts"]) == len(fetches)
    assert evals and sum(report["counts"]) == len(evals)
    assert merge["sum"] > 0 and np.isfinite(report["sum"])
