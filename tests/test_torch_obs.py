"""The port's observability (difacto_tpu_torch/obs) against the JAX
package's, on the CPU.

- The same writes into the port's Registry and JAX's give equal
  snapshots, equal Prometheus text and equal quantiles; counters written
  from many threads stay exact; ``DIFACTO_OBS=off`` semantics (the no-op
  registry) hold.
- Worker processes of the port's ProcessProducerPool report into the
  consumer's registry exactly (the thread transport's totals).
- Host trace spans nest and save as Chrome trace JSON.
- ``metrics_path``: the learner's JSONL carries the JAX learner's metric
  names (every ``stage_seconds_total`` stage, ``train_step_seconds``,
  ``train_rows_total``, ``store_gather_bytes_total{path}``) and the
  process workers' ``producer_rows_total``/``producer_batches_total``;
  ``metrics_max_mb`` rolls the file to ``.1``.

The make_iter of the cross-process test lives at module level and the
module imports neither jax nor torch at its top, so spawned workers
unpickle it cheaply.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from difacto_tpu_torch import obs
from difacto_tpu_torch.obs import (MetricsFlusher, Registry,
                                   render_prometheus, trace)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(_ROOT, "tests", "data", "rcv1_100.libsvm")


def counted_items(part):
    """Four items per part, each counted into the worker's registry."""
    rows = obs.REGISTRY.counter("obs_port_rows_total")
    byts = obs.REGISTRY.counter("obs_port_bytes_total")
    for j in range(4):
        a = np.full(16, part * 10 + j, dtype=np.int64)
        rows.inc()
        byts.inc(a.nbytes)
        yield (part, j, a)


def _write(reg):
    """One fixed sequence of writes, the same on both packages."""
    reg.counter("reqs_total", "requests").labels(code="200").inc(5)
    reg.counter("reqs_total").labels(code="500").inc()
    reg.counter("plain_total").inc(2.5)
    reg.gauge("depth", "queue depth").set(3)
    reg.gauge("depth").labels(q="b").inc(4)
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.001, 0.002, 0.004, 0.2, 3.0, 5000.0):
        h.observe(v)
    reg.histogram("step_seconds").labels(path="train").observe(0.05)
    child = {"counters": {"reqs_total": {(("code", "200"),): 7.0}},
             "hists": {}, "gauges": {}, "help": {}}
    reg.set_child(("w", 1), child)
    return reg


def test_registry_snapshot_and_prometheus_equal_jax():
    from difacto_tpu.obs import Registry as JRegistry
    from difacto_tpu.obs import render_prometheus as jrender
    from difacto_tpu.obs.export import jsonable_snapshot as jjson
    port = _write(Registry(enabled=True))
    ref = _write(JRegistry(enabled=True))
    assert port.snapshot() == ref.snapshot()
    assert render_prometheus(port.snapshot()) == jrender(ref.snapshot())
    assert obs.jsonable_snapshot(port.snapshot()) == jjson(ref.snapshot())
    port.fold_children(("w",))
    ref.fold_children(("w",))
    assert port.snapshot() == ref.snapshot()
    assert port.value("reqs_total", code="200") == 12.0


def test_histogram_quantiles_and_merge_equal_jax():
    from difacto_tpu.obs import hist_quantiles as jq
    from difacto_tpu.obs import merge_into as jmerge
    rng = np.random.RandomState(5)
    a, b = Registry(enabled=True), Registry(enabled=True)
    for reg in (a, b):
        for v in rng.lognormal(-4, 2, 500):
            reg.histogram("x_seconds").observe(float(v))
    got = obs.merge_into(a.snapshot(), b.snapshot())
    want = jmerge(a.snapshot(), b.snapshot())
    assert got == want
    d = got["hists"]["x_seconds"][()]
    assert d["count"] == 1000
    assert obs.hist_quantiles(d, (0.5, 0.9, 0.99)) == jq(d, (0.5, 0.9,
                                                             0.99))


def test_counter_concurrent_writers_stay_exact():
    reg = Registry(enabled=True)
    c = reg.counter("n_total").labels(kind="x")

    def work():
        for _ in range(20_000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.value("n_total", kind="x") == 160_000


def test_disabled_registry_is_the_noop():
    reg = Registry(enabled=False)
    assert reg.counter("a") is obs.NOOP and reg.histogram("b") is obs.NOOP
    reg.counter("a").labels(x=1).inc(5)
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "hists": {},
                              "help": {}}


def test_worker_processes_report_exact_totals():
    """Worker processes count into their own registries; the pool's
    snapshot channel gives the consumer's registry the thread
    transport's totals exactly."""
    from difacto_tpu_torch.data.producer_pool import (OrderedProducerPool,
                                                      ProcessProducerPool)
    before = obs.REGISTRY.value("obs_port_rows_total")
    t_items = list(OrderedProducerPool(5, counted_items, n_workers=2))
    t_rows = obs.REGISTRY.value("obs_port_rows_total") - before
    reg = Registry(enabled=True)
    pool = ProcessProducerPool(5, counted_items, n_workers=2,
                               slot_bytes=1 << 20, obs_registry=reg,
                               join_timeout=60.0)
    p_items = [(p, (i[0], i[1], int(i[2][0]))) for p, i in pool]
    assert [(p, (i[0], i[1], int(i[2][0]))) for p, i in t_items] == p_items
    assert t_rows == 20
    assert reg.value("obs_port_rows_total") == 20
    assert reg.value("obs_port_bytes_total") == 20 * 16 * 8
    assert reg.value("stage_seconds_total", stage="ring_wait") >= 0.0


def test_trace_spans_nest_and_save(tmp_path):
    trace.drain_events()
    trace.start()
    try:
        with trace.span("outer", part=3) as outer_id:
            with trace.span("inner"):
                pass
            assert trace.current_span_id() == outer_id
        path = trace.save(str(tmp_path / "t.json"))
    finally:
        trace.stop()
        trace.drain_events()
    evs = json.load(open(path))["traceEvents"]
    by = {e["name"]: e for e in evs}
    assert set(by) == {"outer", "inner"}
    assert all(e["ph"] == "X" for e in evs)
    assert by["inner"]["args"]["parent"] == by["outer"]["args"]["span_id"]
    assert by["outer"]["args"]["part"] == 3


def _metric_keys(line: dict) -> set:
    """(kind, name, label names) of one JSONL snapshot line."""
    out = set()
    for kind in ("counters", "gauges", "hists"):
        for name, series in line["metrics"][kind].items():
            for key in series:
                labels = tuple(sorted(kv.split("=")[0]
                                      for kv in key.split(",") if kv))
                out.add((kind, name, labels))
    return out


def _learner_args(mpath, mode):
    return [("data_in", RCV1), ("V_dim", "2"), ("l1", "0.1"),
            ("num_jobs_per_epoch", "2"), ("batch_size", "50"),
            ("max_num_epochs", "1"), ("shuffle", "0"),
            ("report_interval", "0"), ("stop_rel_objv", "0"),
            ("device_cache_mb", "0"), ("hash_capacity", "4096"),
            ("num_producers", "2"), ("producer_mode", mode),
            ("metrics_path", mpath), ("metrics_interval_s", "999")]


def test_metrics_path_carries_the_jax_metric_names(tmp_path):
    from difacto_tpu.learners.sgd import SGDLearner as JLearner
    from difacto_tpu_torch.learners.sgd import SGDLearner
    lines, learners = {}, {}
    for who, mode in (("port", "thread"), ("port_proc", "process"),
                      ("jax", "thread")):
        mpath = str(tmp_path / f"{who}.jsonl")
        ln = JLearner() if who == "jax" else SGDLearner(device="cpu")
        ln.init(_learner_args(mpath, mode)
                + ([("fused_kernel", "jnp")] if who == "jax" else []))
        ln.run()
        lines[who] = [json.loads(x) for x in open(mpath)]
        learners[who] = ln
        assert ln.stage_stats()["producer_mode"] == mode
    port = lines["port"][-1]["metrics"]
    stages = port["counters"]["stage_seconds_total"]
    assert set(stages) == {f"stage={s}" for s in
                           ("parse", "pack", "ring_wait", "transfer",
                            "step")}
    assert stages["stage=parse"] > 0 and stages["stage=step"] > 0
    assert port["counters"]["train_rows_total"][""] == 100
    assert port["counters"]["store_gather_bytes_total"]["path=train"] > 0
    # every metric the JAX learner's own registry writes, with its labels
    jax_own = {k for k in _metric_keys(lines["jax"][-1])
               if k[1] in ("stage_seconds_total", "train_step_seconds",
                           "train_rows_total", "store_gather_bytes_total")}
    assert jax_own and jax_own <= _metric_keys(lines["port"][-1])
    # the workers' counters reach the learner's own registry exactly (the
    # JSONL also merges the process-global one, which other runs in this
    # process may have counted into)
    proc = learners["port_proc"].obs
    assert proc.value("producer_rows_total") == 100
    n_batches = proc.value("producer_batches_total")
    assert n_batches >= 2
    # one step per batch the workers produced
    assert port["hists"]["train_step_seconds"][""]["count"] == n_batches
    assert proc.value("stage_seconds_total", stage="pack") > 0
    assert {"producer_rows_total", "producer_batches_total"} <= set(
        lines["port_proc"][-1]["metrics"]["counters"])


def test_flusher_rolls_past_max_mb(tmp_path):
    reg = Registry(enabled=True)
    reg.counter("reqs_total").inc()
    probe = str(tmp_path / "probe.jsonl")
    MetricsFlusher(probe, interval_s=999.0, registries=[reg]).flush()
    cap_mb = os.path.getsize(probe) * 2.5 / (1 << 20)
    path = str(tmp_path / "m.jsonl")
    fl = MetricsFlusher(path, interval_s=999.0, registries=[reg],
                        max_mb=cap_mb)
    for _ in range(12):
        reg.counter("reqs_total").inc()
        fl.flush()
    fl.close()
    assert os.path.exists(path + ".1")
    for f in (path, path + ".1"):
        assert os.path.getsize(f) <= cap_mb * (1 << 20)
    last = json.loads(open(path).read().splitlines()[-1])
    assert last["metrics"]["counters"]["reqs_total"][""] == 13


def test_flusher_thread_writes_on_its_interval(tmp_path):
    reg = Registry(enabled=True)
    reg.counter("x_total").inc()
    path = str(tmp_path / "m.jsonl")
    fl = MetricsFlusher(path, interval_s=0.1, registries=[reg]).start()
    deadline = time.monotonic() + 30
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    fl.close()
    lines = open(path).read().splitlines()
    assert len(lines) >= 2     # at least one interval flush + the final


@pytest.mark.parametrize("value", ["off", "0", "false"])
def test_obs_off_env_disables_the_default_registry(monkeypatch, value):
    from difacto_tpu_torch.obs import metrics
    monkeypatch.setenv("DIFACTO_OBS", value)
    assert not Registry().enabled and not metrics._env_enabled()
