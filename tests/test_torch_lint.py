"""The repo's analyzer over the port, and the port's lock and race
tracing (utils/locktrace.py, utils/shared.py) against its static model.

- ``difacto_tpu.analysis`` over ``difacto_tpu_torch/`` with no baseline
  reports 0 findings, and the port's static lock-order graph is
  cycle-free.
- ``difacto_tpu_torch/utils/lockorder.json`` is that static model as the
  card machine reads it: it must equal the JAX analyzer's output and the
  port's own analyzer's (``difacto_tpu_torch/analysis``, which writes
  it). Rewrite it with ``python -m difacto_tpu_torch.analysis
  --write-lockorder`` after moving a lock (``PYTHONPATH=. python
  tests/test_torch_lint.py`` runs the same).
- The port's locktrace records, dumps, loads and stays raw when disabled,
  and its race tracer runs Eraser's state machine (counterparts of
  tests/test_lint.py's tracer tests); both dump at exit; the batcher
  scenario's observed edges, run on the port's ``MicroBatcher``, are in
  the static graph; and a traced train epoch plus a served window in a
  subprocess with ``DIFACTO_LOCKTRACE=1 DIFACTO_RACETRACE=1`` records
  only static edges and raises race alarms only on suppressed fields.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from difacto_tpu.analysis import core
from difacto_tpu.analysis.concurrency import get_model
from difacto_tpu.analysis.races import get_race_model

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = "difacto_tpu_torch"
LOCKORDER = REPO_ROOT / PORT / "utils" / "lockorder.json"


def static_model() -> dict:
    """The analyzer's lock-order graph and race facts over the port, in
    the shape of ``lockorder.json``: creation site -> lock id, the edges
    between lock ids, the cycles, the suppressed fields, and which of
    the fields the port traces (``shared.attr()``) are known-safe."""
    project = core.Project(REPO_ROOT, [PORT])
    model = get_model(project)
    races = get_race_model(project)
    safe = races.known_safe()
    traced = sorted(f for f in races.fields if _is_traced(f))
    return {
        "version": 1,
        "sites": {f"{li.path}:{li.line}": lid
                  for lid, li in sorted(model.locks.items())},
        "edges": sorted([a, b] for a, b in model.edges),
        "cycles": [list(c) for c in model.cycles],
        "race_suppressed": sorted(races.suppressed_fields),
        "race_traced_known_safe": [f for f in traced if f in safe],
    }


def _is_traced(fid: str) -> bool:
    """A field declared ``name = shared.attr()`` in its class body."""
    path, qual = fid.split("::", 1)
    if "." not in qual:
        return False
    cls, name = qual.rsplit(".", 1)
    src = (REPO_ROOT / path).read_text()
    return f"    {name} = shared.attr()" in src and f"class {cls}" in src


@pytest.fixture(scope="module")
def model():
    return static_model()


def test_analyzer_reports_no_findings_over_the_port():
    project = core.Project(REPO_ROOT, [PORT])
    res = core.run_project(project, None)
    active = [f"{f.path}:{f.line}: [{f.rule}] {f.message}"
              for f in res.active]
    assert active == []
    assert res.counts()["files"] >= 80   # the whole port was read


def test_cli_over_the_port_exits_clean(capsys):
    from difacto_tpu.analysis.cli import main
    rc = main([PORT, "--root", str(REPO_ROOT), "--baseline", "none"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert " 0 finding(s)" in out


def test_static_lock_graph_is_cycle_free_and_committed(model):
    assert model["cycles"] == []
    assert model["edges"], "the port nests locks: the graph cannot be empty"
    committed = json.loads(LOCKORDER.read_text())
    assert committed == model, \
        "lockorder.json is stale: rewrite it with " \
        "`python -m difacto_tpu_torch.analysis --write-lockorder`"


def test_port_analyzer_writes_the_committed_lock_graph(model):
    """The port's own analyzer produces the committed graph, and it is
    the JAX analyzer's."""
    from difacto_tpu_torch.analysis.cli import lock_graph
    port = lock_graph(REPO_ROOT)
    assert port == model
    assert json.loads(LOCKORDER.read_text()) == port, \
        "lockorder.json is stale: rewrite it with " \
        "`python -m difacto_tpu_torch.analysis --write-lockorder`"


def test_every_port_lock_comes_from_the_factories():
    """No bare threading.Lock/RLock/Condition outside the tracer's own
    raw registry locks."""
    raw = {}
    for p in sorted((REPO_ROOT / PORT).rglob("*.py")):
        rel = p.relative_to(REPO_ROOT).as_posix()
        for i, line in enumerate(p.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            if any(f"threading.{k}()" in code
                   for k in ("Lock", "RLock", "Condition")) \
                    or "import Lock" in code:
                raw.setdefault(rel, []).append(i)
    allowed = {f"{PORT}/utils/locktrace.py", f"{PORT}/utils/shared.py",
               f"{PORT}/serve/fleethealth.py"}
    assert set(raw) <= allowed, raw
    # fleethealth: only the standalone-load fallback (no package) is raw
    fh = (REPO_ROOT / PORT / "serve" / "fleethealth.py").read_text()
    assert "from ..utils.locktrace import mutex" in fh


# ------------------------------------------------------------- locktrace


def test_locktrace_records_and_roundtrips_across_threads(tmp_path,
                                                         monkeypatch):
    from difacto_tpu_torch.utils import locktrace

    monkeypatch.setenv("DIFACTO_LOCKTRACE", "1")
    locktrace.reset()
    a = locktrace.mutex()
    b = locktrace.mutex()

    def nest():
        with a:
            with b:
                pass

    t = threading.Thread(target=nest, daemon=True)
    t.start()
    t.join()
    nest()

    edges = locktrace.edges()
    assert len(edges) == 1
    ((src, dst), count), = edges.items()
    assert count == 2
    assert src != dst
    assert all(s.startswith("tests/test_torch_lint.py:")
               for s in (src, dst))
    assert locktrace.sites()[src] == "Lock"

    out = tmp_path / "locks.json"
    locktrace.dump(out)
    data = locktrace.load(out)
    assert data["edges"] == edges
    assert data["sites"][dst] == "Lock"
    locktrace.reset()
    assert locktrace.edges() == {}


def test_locktrace_release_order_and_disabled(monkeypatch):
    from difacto_tpu_torch.utils import locktrace

    monkeypatch.delenv("DIFACTO_LOCKTRACE", raising=False)
    monkeypatch.delenv("DIFACTO_RACETRACE", raising=False)
    assert isinstance(locktrace.mutex(), type(threading.Lock()))
    assert isinstance(locktrace.rmutex(), type(threading.RLock()))
    assert isinstance(locktrace.condition(), threading.Condition)

    monkeypatch.setenv("DIFACTO_LOCKTRACE", "1")
    locktrace.reset()
    a = locktrace.mutex()
    b = locktrace.mutex()
    a.acquire()
    a.release()
    b.acquire()
    b.release()
    assert locktrace.edges() == {}
    with a:
        with b:
            assert b.locked()
    assert len(locktrace.edges()) == 1
    r = locktrace.rmutex()
    with r:
        with r:
            pass
    cv = locktrace.condition()
    with cv:
        cv.notify_all()
    assert len(locktrace.edges()) == 1
    locktrace.reset()


def test_port_locktrace_agrees_with_the_jax_tracer(tmp_path, monkeypatch):
    """The same nesting in both tracers gives the same dump, up to the
    creation lines of the two files."""
    from difacto_tpu.utils import locktrace as jlt
    from difacto_tpu_torch.utils import locktrace as tlt

    monkeypatch.setenv("DIFACTO_LOCKTRACE", "1")
    dumps = []
    for mod in (tlt, jlt):
        mod.reset()
        a = mod.mutex()
        b = mod.rmutex()
        c = mod.mutex()
        for _ in range(3):
            with a:
                with b:
                    with c:
                        pass
        with c:
            pass
        out = tmp_path / f"{mod.__name__}.json"
        mod.dump(out)
        data = json.loads(out.read_text())
        dumps.append(([e["count"] for e in data["edges"]],
                      sorted(data["sites"].values())))
        mod.reset()
    assert dumps[0] == dumps[1] == ([3, 3, 3], ["Lock", "Lock", "RLock"])


def test_shared_tracer_eraser_state_machine(tmp_path, monkeypatch):
    """The port's race tracer: disabled it is inert; enabled, a field
    goes exclusive -> shared-modified when a second thread writes it,
    its lockset is what every access held, and an unlocked read empties
    it into an alarm (tests/test_lint.py's state-machine case)."""
    from difacto_tpu_torch.utils import locktrace, shared

    monkeypatch.delenv("DIFACTO_RACETRACE", raising=False)
    assert shared.attr() is None
    monkeypatch.setenv("DIFACTO_RACETRACE", "1")
    shared.reset()
    locktrace.reset()

    class Box:
        val = shared.attr()
        ro = shared.attr()

        def __init__(self):
            self.mu = locktrace.mutex()
            self.val = 0
            self.ro = "config"

    b = Box()
    fid = "tests/test_torch_lint.py::" \
          "test_shared_tracer_eraser_state_machine.<locals>.Box.val"
    b.val = 1
    st = shared.fields()[fid]
    assert st["state"] == "exclusive" and st["lockset"] is None

    def other():
        with b.mu:
            b.val += 1

    t = threading.Thread(target=other, daemon=True)
    t.start()
    t.join()
    st = shared.fields()[fid]
    assert st["state"] == "shared-modified" and st["threads"] == 2
    assert len(st["lockset"]) == 1
    with b.mu:
        _ = b.val
    assert shared.fields()[fid]["lockset"] == st["lockset"]
    _ = b.val
    assert shared.fields()[fid]["lockset"] == []
    assert fid in shared.alarms()
    assert shared.fields()[fid.replace(".val", ".ro")]["state"] \
        == "exclusive"
    out = tmp_path / "races.json"
    shared.dump(out)
    assert shared.load(out)[fid]["lockset"] == []
    shared.reset()
    locktrace.reset()
    assert shared.fields() == {}


def test_tracers_dump_at_exit(tmp_path):
    """``DIFACTO_LOCKTRACE_OUT`` and ``DIFACTO_RACETRACE_OUT`` write the
    edges and the fields when the process exits."""
    code = textwrap.dedent("""
        import threading
        from difacto_tpu_torch.utils import locktrace, shared
        a = locktrace.mutex()
        b = locktrace.mutex()

        class Box:
            v = shared.attr()

        box = Box()
        box.v = 0
        with a:
            with b:
                box.v = 1

        def bump():
            with a:
                box.v += 1

        t = threading.Thread(target=bump)
        t.start()
        t.join()
    """)
    locks, races = tmp_path / "locks.json", tmp_path / "races.json"
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), DIFACTO_RACETRACE="1",
               DIFACTO_LOCKTRACE_OUT=str(locks),
               DIFACTO_RACETRACE_OUT=str(races))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    from difacto_tpu_torch.utils import locktrace, shared
    assert len(locktrace.load(locks)["edges"]) == 1
    (rec,) = shared.load(races).values()
    assert rec["state"] == "shared-modified" and len(rec["lockset"]) == 1


def test_batcher_edges_are_in_the_static_graph(model, monkeypatch):
    """tests/test_lint.py's batcher scenario, on the port's batcher: the
    shed counters tick under the admission lock, a real nesting."""
    monkeypatch.setenv("DIFACTO_LOCKTRACE", "1")
    from difacto_tpu_torch.data.rowblock import RowBlock
    from difacto_tpu_torch.serve.batcher import MicroBatcher, ServeStats
    from difacto_tpu_torch.utils import locktrace

    locktrace.reset()
    blk = RowBlock(offset=np.array([0, 1], dtype=np.int64),
                   label=np.zeros(1, dtype=np.float32),
                   index=np.zeros(1, dtype=np.uint32),
                   value=None, weight=None)
    stats = ServeStats()
    bat = MicroBatcher(lambda x: np.zeros(x.size, np.float32),
                       batch_size=2, queue_cap=1, stats=stats)
    try:
        assert bat.submit(blk) is not None
        assert bat.submit(blk) is None
        stats.record_latency(0.001)
        stats.snapshot()
    finally:
        bat.close()
    edges = locktrace.edges()
    locktrace.reset()
    assert edges, "the scenario must actually nest traced locks"
    assert_static(edges, model)


def assert_static(edges, model):
    sites = model["sites"]
    static = {tuple(e) for e in model["edges"]}
    for a, b in edges:
        assert a in sites, f"lock site {a} unknown to the static model"
        assert b in sites, f"lock site {b} unknown to the static model"
        assert (sites[a], sites[b]) in static, \
            f"observed edge {sites[a]} -> {sites[b]} missing from the " \
            "static graph"


def test_traced_epoch_and_served_window(model, tmp_path):
    """A train epoch on four producer threads and a served window in one
    traced subprocess: every observed lock edge is a static edge, and
    every race alarm is on a field the static model suppresses."""
    from chip_smoke import synthetic_criteo
    train = tmp_path / "train.txt"
    train.write_bytes(synthetic_criteo(2000, 51))
    rows = synthetic_criteo(200, 52)
    (tmp_path / "rows.txt").write_bytes(rows)
    scenario = textwrap.dedent(f"""
        import json, sys
        from difacto_tpu_torch.learners.sgd import SGDLearner
        from difacto_tpu_torch.online.log import OnlineLog
        from difacto_tpu_torch.serve import ServeClient, ServeServer
        from difacto_tpu_torch.utils import locktrace, shared
        ln = SGDLearner(device="cpu")
        ln.init([("data_in", {str(train)!r}), ("data_format", "criteo"),
                 ("V_dim", "4"), ("hash_capacity", "8192"),
                 ("batch_size", "100"), ("num_jobs_per_epoch", "4"),
                 ("max_num_epochs", "1"), ("num_producers", "4"),
                 ("producer_mode", "thread"), ("device_cache_mb", "0"),
                 ("report_interval", "0"),
                 ("model_out", {str(tmp_path / "m")!r})])
        ln.run()
        # a queue of 32 rows under a 200-row burst: the admission lock
        # counts sheds, and the online log counts rows under its own
        log = OnlineLog({str(tmp_path / "log")!r}, segment_rows=64)
        srv = ServeServer(ln.store, data_format="criteo", batch_size=16,
                          queue_cap=32, online_log=log).start()
        rows = open({str(tmp_path / "rows.txt")!r}, "rb").read()
        rows = [r for r in rows.splitlines() if r]
        with ServeClient(srv.host, srv.port) as c:
            got = c.predict(rows)
        srv.close()
        log.end()
        assert len(got) == len(rows) and any(g is not None for g in got)
        locktrace.dump({str(tmp_path / "locks.json")!r})
        shared.dump({str(tmp_path / "fields.json")!r})
    """)
    env = dict(os.environ, DIFACTO_LOCKTRACE="1", DIFACTO_RACETRACE="1",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO_ROOT))
    r = subprocess.run([sys.executable, "-c", scenario], cwd=REPO_ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "locks.json") as f:
        edges = {(e["src"], e["dst"]) for e in json.load(f)["edges"]}
    assert edges, "the traced run must nest locks"
    assert_static(edges, model)
    with open(tmp_path / "fields.json") as f:
        fields = json.load(f)["fields"]
    shared_f = {k: v for k, v in fields.items() if v["state"] != "exclusive"}
    assert shared_f, "the served window must share the batcher's fields"
    for fid, rec in shared_f.items():
        assert fid in model["race_traced_known_safe"], fid
        if rec["state"] == "shared-modified" and rec["lockset"] == []:
            assert fid in model["race_suppressed"], fid


if __name__ == "__main__":
    from difacto_tpu_torch.analysis.cli import main
    sys.exit(main(["--write-lockorder", "--root", str(REPO_ROOT)]))
