"""The port's counterparts of the last root tools that imported the JAX
package, held to the root tools on the same inputs.

- ``difacto_tpu_torch.tools.obs_report`` prints the root
  ``tools/obs_report.py``'s text byte for byte on one metrics JSONL (a
  port registry flushed by the port's MetricsFlusher: stages, histograms,
  gauges, the fleet, capacity and durability counters) and one Chrome
  trace, also over a rolled ``.1`` file.
- ``difacto_tpu_torch.tools.lockmap`` gives the root
  ``tools/lockmap.py``'s confirmed, predicted-only and ``dynamic_only``
  edges, cycles and ``--check`` exit codes on one small locked module and
  its dumps (a confirmed edge, a dynamic-only one, a static cycle), and
  over the port's own tree ``--check`` passes.
- ``store.local.collision_stats`` equals the JAX store's on seeded ids.
- ``difacto_tpu_torch.tools.collision_study`` writes the root tool's
  synthetic Criteo rows byte for byte and, at a few hundred rows on the
  CPU, prints the root tool's keys, one line per capacity.
"""

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _root_tool(name: str):
    """The root ``tools/<name>.py`` as a module (``tools`` is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _out(fn, *args, **kw) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kw)
    return rc, buf.getvalue()


# ------------------------------------------------------------ obs_report
def _metrics_file(path: pathlib.Path) -> None:
    """Two flushes of a port registry holding every section the report
    reads (the last line is the run's)."""
    from difacto_tpu_torch.obs.export import MetricsFlusher
    from difacto_tpu_torch.obs.metrics import Registry
    reg = Registry(enabled=True)
    stage = reg.counter("stage_seconds_total", "seconds per stage")
    for st, v in (("parse", 1.25), ("pack", 0.5), ("ring_wait", 0.0625),
                  ("transfer", 0.125), ("step", 2.5), ("extra", 0.01)):
        stage.labels(stage=st).inc(v)
    h = reg.histogram("train_step_seconds", "step time")
    rng = np.random.RandomState(0)
    for v in rng.exponential(0.003, 500):
        h.observe(float(v))
    lat = reg.histogram("serve_latency_seconds", "latency")
    for v in rng.exponential(0.02, 200):
        lat.labels(route="a").observe(float(v))
    for name, v in (("autoscale_spawns_total", 3),
                    ("store_tier_hits_total", 90),
                    ("store_tier_misses_total", 10),
                    ("wal_bytes_total", 4096),
                    ("faults_fired_total", 2)):
        reg.counter(name, name).inc(v)
    reg.counter("recovery_rung_total", "rungs").labels(rung="peer").inc(1)
    for name, v in (("autoscale_replicas", 2), ("train_behind_serve_s", 1.5)):
        reg.gauge(name, name).set(v)
    occ = reg.gauge("store_shard_occupancy", "occupancy")
    for s in range(4):
        occ.labels(shard=str(s)).set(0.25 * s)
    reg.gauge("replica_lag_generations", "lag").labels(peer="p0").set(1)
    fl = MetricsFlusher(str(path), registries=[reg])
    fl.flush()
    stage.labels(stage="step").inc(0.5)
    fl.flush()


def _trace_file(path: pathlib.Path) -> None:
    ev = [{"ph": "X", "name": n, "ts": i * 10, "dur": d, "pid": 1,
           "tid": 1}
          for i, (n, d) in enumerate([("epoch", 5e6), ("step", 2000.0),
                                      ("step", 3000.0),
                                      ("producer.pack", 700.0),
                                      ("consumer.dispatch", 1.5e6)])]
    ev.append({"ph": "i", "name": "mark", "ts": 0, "pid": 1, "tid": 1})
    path.write_text(json.dumps({"traceEvents": ev}))


def test_obs_report_text_equals_the_root_tools(tmp_path, monkeypatch):
    from difacto_tpu_torch.tools import obs_report
    root = _root_tool("obs_report")
    metrics, trace = tmp_path / "m.jsonl", tmp_path / "t.json"
    _metrics_file(metrics)
    _trace_file(trace)
    for args in (["--metrics", str(metrics)], ["--trace", str(trace)],
                 ["--metrics", str(metrics), "--trace", str(trace),
                  "--top", "3"]):
        monkeypatch.setattr(sys, "argv", ["obs_report.py"] + args)
        want = _out(root.main)
        got = _out(obs_report.main, args)
        assert got == want and want[0] == 0
        assert "== streamed stage table" in got[1] or "--metrics" \
            not in args
    # a rolled file: both read <path>.1 then the live file
    metrics.rename(str(metrics) + ".1")
    metrics.write_text("")
    monkeypatch.setattr(sys, "argv", ["obs_report.py", "--metrics",
                                      str(metrics)])
    want = _out(root.main)
    assert _out(obs_report.main, ["--metrics", str(metrics)]) == want
    assert "train_step_seconds" in want[1]


# --------------------------------------------------------------- lockmap
LOCKED = '''import threading


class Pair:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()
        self.c = threading.Lock()
        self.n = 0

    def ab(self):
        with self.a:
            with self.b:
                self.n += 1

    def bc(self):
        with self.b:
            with self.c:
                self.n += 1
'''
CYCLE = '''

    def ca(self):
        with self.c:
            with self.a:
                self.n += 1
'''


def _site(line: int) -> str:
    return f"tools/locked.py:{line}"


def _dump(path: pathlib.Path, edges) -> str:
    path.write_text(json.dumps({"version": 1, "sites": {}, "edges": [
        {"src": _site(a), "dst": _site(b), "count": n}
        for a, b, n in edges]}))
    return str(path)


@pytest.mark.parametrize("cycle", [False, True])
def test_lockmap_sets_and_check_equal_the_root_tools(tmp_path, cycle):
    from difacto_tpu_torch.tools import lockmap
    root = _root_tool("lockmap")
    (tmp_path / "tools").mkdir()
    (tmp_path / "tools" / "locked.py").write_text(
        LOCKED + (CYCLE if cycle else ""))
    a, b, c = 6, 7, 8          # the locks' creation lines
    dumps = {"confirmed only": _dump(tmp_path / "d1.json", [(a, b, 3)]),
             "dynamic only": _dump(tmp_path / "d2.json",
                                   [(a, b, 3), (c, b, 1)]),
             "none": None}
    for what, dump in dumps.items():
        want = root.build(tmp_path, dump)
        got = lockmap.build(tmp_path, dump, paths=["tools"])
        for key in ("confirmed", "dynamic_only", "cycles",
                    "unknown_sites"):
            assert got[key] == want[key], (what, key)
        predicted = set(got["static_edges"]) - set(got["confirmed"])
        assert predicted == set(want["static_edges"]) - set(
            want["confirmed"])
        assert got["dynamic_edges"] == want["dynamic_edges"]
        assert len(got["locks"]) == len(want["locks"]) == 3
        argv = ["--root", str(tmp_path), "--check"] + (
            ["--dynamic", dump] if dump else [])
        rc_want, _ = _out(root.main, argv)
        rc_got, text = _out(lockmap.main, argv + ["--paths", "tools"])
        assert rc_got == rc_want == int(cycle or what == "dynamic only")
        assert "lockmap: 3 locks" in text
    assert bool(want["cycles"]) == cycle


def test_lockmap_check_passes_over_the_port(tmp_path):
    from difacto_tpu_torch.tools import lockmap
    out = tmp_path / "lockmap.json"
    rc, text = _out(lockmap.main, ["--root", str(REPO), "--check",
                                   "--json", str(out)])
    assert rc == 0, text
    doc = json.loads(out.read_text())
    assert doc["dynamic_only"] == [] and doc["locks"]


# ------------------------------------------------------- collision_stats
@pytest.mark.parametrize("cap", [2, 97, 1 << 10, 1 << 20])
def test_collision_stats_equals_jax(cap):
    from difacto_tpu.store.local import collision_stats as jstats
    from difacto_tpu_torch.store.local import collision_stats
    rng = np.random.RandomState(cap)
    ids = rng.randint(0, 1 << 62, 3000, dtype=np.int64).astype(np.uint64)
    ids = np.concatenate([ids, ids[:100]])        # duplicates collapse
    assert collision_stats(ids, cap) == jstats(ids, cap)


# -------------------------------------------------------- collision_study
def test_collision_study_writes_the_root_rows_and_keys(tmp_path):
    from difacto_tpu.store.local import collision_stats as jstats
    from difacto_tpu_torch.tools import collision_study as cs
    download = _root_tool("download")
    (tmp_path / "root").mkdir()
    (tmp_path / "port").mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        download.synth_criteo(str(tmp_path / "root"), rows=300)
        cs.synth_criteo(str(tmp_path / "port"), rows=300)
    for split in ("train", "val"):
        name = f"criteo_{split}.txt"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "root" / name).read_bytes()
    rc, text = _out(cs.main, ["--rows", "300", "--data-dir",
                              str(tmp_path / "study"), "--batch", "100",
                              "--epochs", "2", "--mults", "2,0.5",
                              "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    assert lines[0]["rows"] == 300 and lines[0]["distinct_ids"] > 0
    keys = ["capacity_mult", *jstats(np.arange(1, 4, dtype=np.uint64),
                                     8), "val_auc_best",
            "val_auc_by_epoch", "wall_s"]
    assert [x["capacity_mult"] for x in lines[1:]] == [2.0, 0.5]
    for x in lines[1:]:
        assert list(x) == keys
        assert len(x["val_auc_by_epoch"]) == 2
        assert 0.0 <= x["val_auc_best"] <= 1.0
