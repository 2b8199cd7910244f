"""The device annotations of the port's obs/trace.py under its own
profiler session (``DIFACTO_TRACE_DEVICE``, utils/profiling.py), side by
side with the JAX package's
(tests/test_jaxflow.py:394-430):

- with ``DIFACTO_TRACE`` and ``DIFACTO_TRACE_DEVICE`` set on the CPU, in
  a subprocess of each package: the span file holds the span names, and
  the profiler writes under the logdir; the port's exported Chrome trace
  holds ``record_function`` events of the same names, a span with
  ``step_num`` also a ``ProfilerStep#<n>`` range around its own, and the
  body's operators inside the span's range;
- device annotations change no result: a traced SGD epoch's table under
  them equals one without them bit for bit;
- without the knob the module never creates a profiler.

tests/test_torch_spans.py holds the spans under any profiler.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from difacto_tpu_torch.obs import trace

REPO = pathlib.Path(__file__).resolve().parent.parent
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")

SCENARIO = {
    "difacto_tpu": """
import jax
import jax.numpy as jnp
from difacto_tpu.obs import trace
assert trace.active(), "DIFACTO_TRACE must activate spans"
with trace.span("gate.step", step_num=1):
    jax.jit(lambda x: x + 1)(jnp.ones(8)).block_until_ready()
with trace.span("gate.host"):
    pass
""",
    "difacto_tpu_torch": """
import torch
from difacto_tpu_torch.obs import trace
assert trace.active(), "DIFACTO_TRACE must activate spans"
with trace.span("gate.step", step_num=1):
    torch.mm(torch.ones(8, 8), torch.ones(8, 8))
with trace.span("gate.host"):
    pass
""",
}


def _run(pkg: str, tmp_path) -> tuple:
    logdir = tmp_path / f"{pkg}-device"
    span_file = tmp_path / f"{pkg}-spans.json"
    env = dict(os.environ, DIFACTO_TRACE=str(span_file),
               DIFACTO_TRACE_DEVICE=str(logdir), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    env.pop("DIFACTO_OBS_CHILD", None)
    r = subprocess.run([sys.executable, "-c", SCENARIO[pkg]],
                       cwd=str(REPO), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return span_file, logdir


@pytest.mark.parametrize("pkg", ["difacto_tpu", "difacto_tpu_torch"])
def test_span_file_and_profile_side_by_side(tmp_path, pkg):
    span_file, logdir = _run(pkg, tmp_path)
    doc = json.loads(span_file.read_text())
    names = {ev["name"] for ev in doc["traceEvents"]}
    assert {"gate.step", "gate.host"} <= names
    files = [p for p in logdir.rglob("*") if p.is_file()]
    assert files, f"{pkg}: the profiler wrote nothing under the logdir"


def test_port_chrome_trace_holds_the_span_ranges(tmp_path):
    _, logdir = _run("difacto_tpu_torch", tmp_path)
    (path,) = logdir.glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {}
    for ev in events:
        if ev.get("cat") == "user_annotation":
            ranges.setdefault(ev["name"], []).append(ev)
    assert {"gate.step", "gate.host", "ProfilerStep#1"} <= set(ranges)
    (step,) = ranges["gate.step"]
    (mark,) = ranges["ProfilerStep#1"]
    assert mark["ts"] <= step["ts"] and \
        step["ts"] + step["dur"] <= mark["ts"] + mark["dur"]
    # the body's operator ran inside the span's range
    mm = [ev for ev in events if ev.get("name") == "aten::mm"]
    assert mm and all(step["ts"] <= ev["ts"] <= step["ts"] + step["dur"]
                      for ev in mm)


def test_device_annotations_leave_training_bit_for_bit(tmp_path):
    code = """
import sys
import numpy as np
from difacto_tpu_torch.learners.sgd import SGDLearner
ln = SGDLearner(device="cpu")
ln.init([("data_in", sys.argv[1]), ("V_dim", "2"),
         ("hash_capacity", "4096"), ("batch_size", "20"),
         ("max_num_epochs", "2"), ("report_interval", "0"),
         ("num_producers", "1"), ("producer_mode", "thread")])
ln.run()
np.save(sys.argv[2], ln.store.state.VVg.numpy())
"""
    tables = []
    for mode in ("off", "on"):
        env = dict(os.environ, PYTHONPATH=str(REPO))
        for k in ("DIFACTO_TRACE", "DIFACTO_TRACE_DEVICE"):
            env.pop(k, None)
        if mode == "on":
            env["DIFACTO_TRACE"] = str(tmp_path / "spans.json")
            env["DIFACTO_TRACE_DEVICE"] = str(tmp_path / "dev")
        out = tmp_path / f"{mode}.npy"
        r = subprocess.run([sys.executable, "-c", code, RCV1, str(out)],
                           cwd=str(REPO), env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        tables.append(np.load(out))
    assert tables[0].tobytes() == tables[1].tobytes()
    names = {ev["name"] for ev in json.loads(
        (tmp_path / "spans.json").read_text())["traceEvents"]}
    assert {"epoch", "consumer.dispatch"} <= names
    (path,) = (tmp_path / "dev").glob("trace-*.json")
    ann = {ev["name"] for ev in json.loads(path.read_text())["traceEvents"]
           if ev.get("cat") == "user_annotation"}
    assert {"epoch", "consumer.dispatch", "ProfilerStep#0"} <= ann


def test_without_the_knob_no_profiler_exists(monkeypatch):
    monkeypatch.delenv("DIFACTO_TRACE_DEVICE", raising=False)
    assert trace._prof is None
    made = []
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda *a, **k: made.append(1))
    trace.start()
    try:
        with trace.span("plain", step_num=3):
            pass
    finally:
        trace.stop()
    assert made == [] and trace._prof is None
