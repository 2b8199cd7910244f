"""The port's serve lifecycle against the JAX package's, on the CPU.

Three models trained by the JAX package on the rcv1 fixture: ``a`` and
``b`` share one geometry (V_dim 2, hash_capacity 4096), ``g`` has another
(V_dim 4, hash_capacity 2048). JAX's ``task=pred`` file of each is the
golden: every answer the port's server gives, before and after a
same-geometry or a blue/green ``#reload``, equals the pred column of the
model then serving byte for byte. Also: the ``#stats`` and ``#health``
key sets equal the JAX server's; the reload watcher ignores a save in
progress; ``#metrics``, drain (in process and by SIGTERM through the
CLI) and the ``#handoff`` takeover over ``SO_REUSEPORT``; ``ServeClient``
failover, ejection and timed reprobe; the shared ``FleetHealth``
blacklist (two and three writer processes); the fault points of the
serve path; and no serve thread left behind.

Every socket test runs under its own SIGALRM deadline.
"""

import contextlib
import json
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from difacto_tpu.__main__ import main as jmain
from difacto_tpu.serve import ModelReloader as JReloader
from difacto_tpu.serve import ServeServer as JServer
from difacto_tpu.serve import open_serving_store as jopen
from difacto_tpu_torch.config import format_endpoints, parse_endpoints
from difacto_tpu_torch.obs import DEFAULT_BOUNDS, REGISTRY
from difacto_tpu_torch.serve import (ModelReloader, ServeClient,
                                     ServeServer, open_serving_store,
                                     run_takeover)
from difacto_tpu_torch.serve.fleethealth import FleetHealth, open_blacklist
from difacto_tpu_torch.utils import faultinject

REPO = pathlib.Path(__file__).resolve().parent.parent
FLEETHEALTH = str(REPO / "difacto_tpu_torch" / "serve" / "fleethealth.py")
WORKER = str(REPO / "tests" / "fleethealth_worker.py")

_BASE = ["V_threshold=2", "lr=0.1", "l1=0.1", "l2=0",
         "num_jobs_per_epoch=1", "batch_size=100", "shuffle=0",
         "report_interval=0", "stop_rel_objv=0"]
_MODELS = {
    "a": ["V_dim=2", "hash_capacity=4096", "max_num_epochs=2"],
    "b": ["V_dim=2", "hash_capacity=4096", "max_num_epochs=1", "lr=0.2"],
    "g": ["V_dim=4", "hash_capacity=2048", "max_num_epochs=2"],
}


@contextlib.contextmanager
def deadline(seconds: int):
    def on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded {seconds}s deadline")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faultinject.configure("")


@pytest.fixture(scope="module")
def models(rcv1_path, tmp_path_factory):
    """{name: (model prefix, JAX pred probability column as bytes)}."""
    d = tmp_path_factory.mktemp("lifecycle_models")
    out = {}
    for name, extra in _MODELS.items():
        args = [f"data_in={rcv1_path}"] + _BASE + extra
        model = str(d / name)
        assert jmain(args + [f"model_out={model}"]) == 0
        assert jmain(args + ["task=pred", f"model_in={model}",
                             f"data_val={rcv1_path}",
                             f"pred_out={d / (name + '_pred')}"]) == 0
        with open(d / f"{name}_pred_part-0", "rb") as f:
            col = [l.split(b"\t")[1] for l in f.read().splitlines()]
        assert len(col) == 100
        out[name] = (model, col)
    # the three models answer differently on most rows
    assert sum(x != y for x, y in zip(out["a"][1], out["b"][1])) > 50
    assert sum(x != y for x, y in zip(out["a"][1], out["g"][1])) > 50
    return out


@pytest.fixture(scope="module")
def rows(rcv1_path):
    with open(rcv1_path, "rb") as f:
        return [r for r in f.read().splitlines() if r.strip()]


def _free_port() -> int:
    """A port that was just free: connecting to it is refused."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _server(model, **kw):
    store, _, _ = open_serving_store(model, device="cpu")
    return ServeServer(store, **kw).start()


def _ask(srv, lines):
    """Pipeline ``lines`` on one connection; one reply line each."""
    with socket.create_connection((srv.host, srv.port), timeout=30) as c:
        c.sendall(b"".join(l + b"\n" for l in lines))
        f = c.makefile("rb")
        return [f.readline().rstrip(b"\n") for _ in lines]


# --------------------------------------------------------- the repair
@pytest.mark.parametrize("with_reloader", [False, True],
                         ids=["bare", "reloader"])
def test_stats_and_health_keys_match_jax(models, rows, with_reloader):
    """``#stats`` and ``#health`` carry the JAX server's keys on the same
    model, so a client written against one reads the other."""
    model = models["a"][0]
    with deadline(120):
        # 10 rows flush one batch at 10 rows on either server
        jstore, _, _ = jopen(model)
        jsrv = JServer(jstore, batch_size=10, max_delay_ms=5000.0).start()
        tsrv = _server(model, batch_size=10, max_delay_ms=5000.0)
        if with_reloader:
            jsrv.reloader = JReloader(jsrv.executor, model, server=jsrv)
            tsrv.reloader = ModelReloader(tsrv.executor, model,
                                          server=tsrv)
        try:
            got = {}
            for name, srv in (("jax", jsrv), ("port", tsrv)):
                # the rows answered first, so both servers count them
                assert len(_ask(srv, rows[:10])) == 10
                out = _ask(srv, [b"#stats", b"#health"])
                got[name] = (json.loads(out[0]), json.loads(out[1]))
        finally:
            jsrv.close()
            tsrv.close()
    (js, jh), (ts, th) = got["jax"], got["port"]
    assert set(ts) == set(js), set(ts) ^ set(js)
    assert set(th) == set(jh), set(th) ^ set(jh)
    for k in ("requests", "responses", "dispatches", "model_generation",
              "buckets_compiled", "bucket_hits"):
        assert ts[k] == js[k], k
    assert th["status"] == "ready" and th["model_generation"] == 1


# -------------------------------------------------- reload under load
@pytest.mark.parametrize("new", ["b", "g"],
                         ids=["same_geometry", "bluegreen"])
def test_reload_under_load_answers_equal_jax_pred(models, rows, new):
    """A ``#reload`` under pipelined load: no ``!err``, every answer
    during the swap is the old or the new model's JAX pred bytes for its
    row (no batch splits across models), every answer before is the old
    model's and after is the new model's; a corrupt candidate fails typed
    and keeps the new model serving."""
    old_model, old_col = models["a"]
    new_model, new_col = models[new]
    seen, stop = [], threading.Event()

    with deadline(180):
        srv = _server(old_model, batch_size=16, max_delay_ms=1.0)
        srv.reloader = ModelReloader(srv.executor, old_model, server=srv)

        def load():
            with ServeClient(srv.host, srv.port) as c:
                while not stop.is_set():
                    seen.append(c.score_lines(rows))

        t = threading.Thread(target=load)
        try:
            assert _ask(srv, rows) == old_col
            blue = srv.executor
            _, warm_keys = blue.warm_set()
            t.start()
            while len(seen) < 2:
                time.sleep(0.01)
            with ServeClient(srv.host, srv.port) as c:
                res = c.reload(new_model)
                assert res["ok"] and res["model_generation"] == 2, res
                n_at_swap = len(seen)
                while len(seen) < n_at_swap + 3:
                    time.sleep(0.01)
                stop.set()
                t.join(timeout=60)
                assert _ask(srv, rows) == new_col
                bad = c.reload(str(REPO / "README.md"))
                assert bad["ok"] is False and bad["error"], bad
                st = c.stats()
                health = c.health()
            assert _ask(srv, rows) == new_col
        finally:
            stop.set()
            srv.close()
    assert not t.is_alive()
    assert st["model_generation"] == 2 and health["model_generation"] == 2
    assert st["reloads"] == 1 and st["reload_failures"] == 1
    assert st["errors"] == 0 and st["swap_state"] == "idle"
    for resp in seen:
        for i, r in enumerate(resp):
            assert r in (old_col[i], new_col[i]), (i, r)
    assert seen[0] == old_col and seen[-1] == new_col
    if new == "g":
        green = srv.executor
        assert green is not blue and green.store.param.V_dim == 4
        assert st["bluegreen_swaps"] == 1 and st["last_warm_ms"] > 0
        # every bucket blue served was registered on green by the warm
        assert set(warm_keys) <= set(green._buckets)
        assert green._warmed >= len(warm_keys)
        # a reloader without a server has no batcher to retarget: the
        # geometry change stays a typed failure
        bare = ModelReloader(blue, old_model)
        res = bare.reload(new_model)
        assert not res["ok"] and "geometry" in res["error"], res
    else:
        assert st["bluegreen_swaps"] == 0 and srv.executor is blue


def test_watcher_ignores_save_in_progress(models, rows, tmp_path):
    """The watcher reloads on a manifest generation move only: new npz
    bytes under the old manifest are a save in progress (no reload, no
    failure); the manifest landing with the next generation reloads."""
    src_a, col_a = models["a"]
    src_b, col_b = models["b"]
    dst = str(tmp_path / "live_part-0")
    man = ".manifest.json"
    shutil.copy(src_a + "_part-0", dst)
    shutil.copy(src_a + "_part-0" + man, dst + man)
    with deadline(120):
        srv = _server(dst, batch_size=16, max_delay_ms=1.0)
        srv.reloader = ModelReloader(srv.executor, dst, poll_s=0.05,
                                     server=srv).start()
        try:
            assert _ask(srv, rows) == col_a
            shutil.copy(src_b + "_part-0", dst)     # npz first ...
            time.sleep(0.5)
            st = srv.stats_snapshot()
            assert st["reloads"] == 0 and st["reload_failures"] == 0, st
            assert _ask(srv, rows) == col_a
            with open(src_b + "_part-0" + man) as f:
                mb = json.load(f)
            mb["generation"] = 2                    # ... manifest last
            with open(dst + man, "w") as f:
                json.dump(mb, f)
            t0 = time.monotonic()
            while srv.stats_snapshot()["reloads"] == 0:
                assert time.monotonic() - t0 < 30, "watcher never reloaded"
                time.sleep(0.05)
            assert _ask(srv, rows) == col_b
            assert srv.stats_snapshot()["reload_failures"] == 0
        finally:
            srv.reloader.close()
            srv.close()


# ------------------------------------------------ metrics and drain
def _metric(text: str, name: str, label: str = "") -> float:
    for ln in text.splitlines():
        if ln.startswith(name + label + " "):
            return float(ln.split()[-1])
    raise KeyError(name + label)


def test_metrics_parse_and_agree_with_stats(models, rows):
    """``#metrics`` is Prometheus text ended by one blank line; each
    latency quantile it derives lies in the histogram bucket that holds
    the exact percentile ``#stats`` reports; the served generation and
    the reload counters are mirrored."""
    model = models["a"][0]
    with deadline(120):
        srv = _server(model, batch_size=8, max_delay_ms=1.0)
        srv.reloader = ModelReloader(srv.executor, model, server=srv)
        try:
            with ServeClient(srv.host, srv.port) as c:
                for i in range(0, 100, 10):
                    assert None not in c.predict(rows[i:i + 10])
                assert c.reload()["ok"]
                st = c.stats()
                text = c.metrics()
            with socket.create_connection((srv.host, srv.port)) as s:
                s.sendall(b"#metrics\n#health\n")
                f = s.makefile("rb")
                raw = []
                while not raw or raw[-1] != b"\n":
                    raw.append(f.readline())
                after = json.loads(f.readline())
        finally:
            srv.close()
    # one blank line ends the text; the next reply follows it
    assert b"\n" not in raw[:-1] and len(raw) == len(text.splitlines()) + 1
    assert after["status"] == "ready"
    for ln in text.splitlines():
        assert ln.startswith("#") or len(ln.split()) == 2, ln
    bounds = (0.0,) + tuple(DEFAULT_BOUNDS)
    for q, key in ((0.5, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms")):
        exact = st[key] / 1e3
        got = _metric(text, "difacto_serve_latency_seconds_quantile",
                      '{quantile="%g"}' % q)
        i = int(np.searchsorted(bounds, exact))
        lo, hi = bounds[max(i - 1, 0)], bounds[min(i, len(bounds) - 1)]
        assert lo <= got <= hi, (q, exact, got, lo, hi)
    assert _metric(text, "difacto_serve_model_generation") == 2
    assert _metric(text, "difacto_serve_reloads") == 1
    assert _metric(text, "difacto_serve_responses_total") == 100
    assert "difacto_serve_generation_age_s" in text


def test_drain_answers_admitted_and_sheds_new(models, rows):
    """drain(): the listener closes at once, rows admitted before it are
    answered (the pred bytes), a row arriving during it answers ``!shed
    draining``, and the server ends closed."""
    model, col = models["a"]
    with deadline(120):
        srv = _server(model, batch_size=1000, max_delay_ms=400.0)
        try:
            with socket.create_connection((srv.host, srv.port)) as c:
                f = c.makefile("rb")
                c.sendall(b"".join(r + b"\n" for r in rows[:20]))
                while srv.batcher.rows_queued < 20:
                    time.sleep(0.005)
                out = {}
                t = threading.Thread(
                    target=lambda: out.update(s=srv.drain()))
                t.start()
                while not srv.draining:
                    time.sleep(0.005)
                c.sendall(rows[20] + b"\n")
                got = [f.readline().rstrip(b"\n") for _ in range(21)]
                t.join(timeout=60)
            with pytest.raises(OSError):
                socket.create_connection((srv.host, srv.port), timeout=5)
        finally:
            srv.close()
    assert got[:20] == col[:20]
    assert got[20] == b"!shed draining"
    assert not t.is_alive() and 0 < out["s"] < srv.drain_timeout_s
    assert srv._is_closed()


def test_sigterm_drains_cli_exits_zero(models, rows, tmp_path):
    """``task=serve`` through the port's CLI: SIGTERM under load drains
    and the process exits 0; answers before it equal JAX's pred bytes."""
    model, col = models["a"]
    ready = str(tmp_path / "ready")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("DIFACTO_FAULTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "difacto_tpu_torch", "task=serve",
         "device=cpu", f"model_in={model}", f"serve_ready_file={ready}",
         "serve_drain_timeout_s=10", "serve_max_seconds=120"],
        cwd=str(REPO), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        with deadline(180):
            while not (os.path.exists(ready) and open(ready).read()):
                time.sleep(0.05)
                assert proc.poll() is None, proc.communicate()[1][-2000:]
            host, port = open(ready).read().split()
            with ServeClient(host, int(port)) as c:
                assert c.score_lines(rows) == col
                assert c.health()["status"] == "ready"
            t0 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        assert rc == 0, proc.communicate()[1][-2000:]
        assert time.monotonic() - t0 < 15
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ----------------------------------------------------------- takeover
def test_handoff_takeover_inprocess(models, rows):
    """``run_takeover`` with an in-process successor on the shared
    SO_REUSEPORT port: the incumbent sees the ready file, reports it on
    ``#health``, drains and closes; fresh connections reach the
    successor, which answers the pred bytes; a ``#handoff`` naming the
    successor's own ready file is refused."""
    model, col = models["a"]
    with deadline(120):
        srv1 = _server(model, takeover=True)
        box = {}

        class _InProc:
            def poll(self):
                return None

        def spawn(ready_file):
            srv2 = _server(model, host=srv1.host, port=srv1.port,
                           takeover=True)
            srv2.ready_file = ready_file
            with open(ready_file, "w") as f:
                f.write(f"{srv2.host} {srv2.port}\n")
            box["srv2"] = srv2
            return _InProc()

        try:
            rep = run_takeover(srv1.host, srv1.port, spawn_fn=spawn,
                               wait_s=60.0)
            assert rep["ok"] and rep["incumbent"] != rep["successor"], rep
            assert rep["takeover_gap_ms"] >= 0 and rep["warm_s"] >= 0
            t0 = time.monotonic()
            while not srv1._is_closed():
                assert time.monotonic() - t0 < 60
                time.sleep(0.05)
            assert srv1.successor_ready and srv1.draining
            assert srv1.health_snapshot()["successor_ready"] is True
            srv2 = box["srv2"]
            with ServeClient(srv1.host, srv1.port) as c:
                assert c.health()["server_id"] == rep["successor"]
                assert c.score_lines(rows) == col
                resp = c.score_lines(
                    [b"#handoff " + srv2.ready_file.encode()])[0]
                assert resp.startswith(b"!err") and b"successor" in resp
                assert c.health()["status"] == "ready"
            assert not srv2.draining
        finally:
            srv1.close()
            if "srv2" in box:
                box["srv2"].close()


# ------------------------------------------------------------- client
def test_parse_endpoints_grammar():
    assert parse_endpoints("a:1,b:2") == [("a", 1), ("b", 2)]
    assert parse_endpoints(" a:1 , b:2 ") == [("a", 1), ("b", 2)]
    assert parse_endpoints([("h", 3), "i:4"]) == [("h", 3), ("i", 4)]
    assert format_endpoints([("h", 3), "i:4"]) == "h:3,i:4"
    with pytest.raises(ValueError, match="bad endpoint"):
        parse_endpoints("noport")
    with pytest.raises(ValueError, match="empty endpoint"):
        parse_endpoints("")


def test_client_multi_endpoint_failover(models, rows):
    """A dead first endpoint is skipped at connect; closing the active
    replica fails the unanswered tail over to the next one; answers stay
    the pred bytes."""
    model, col = models["a"]
    with deadline(120):
        srv1 = _server(model, batch_size=32, max_delay_ms=2.0)
        srv2 = _server(model, batch_size=32, max_delay_ms=2.0)
        dead = _free_port()
        try:
            with ServeClient(endpoints=[("127.0.0.1", dead),
                                        (srv1.host, srv1.port),
                                        (srv2.host, srv2.port)],
                             retries=2, eject_after=1,
                             reprobe_s=30.0) as c:
                assert c.port == srv1.port and c.failovers >= 1
                assert c.score_lines(rows[:5]) == col[:5]
                eh = c.endpoints_health()
                assert eh[0]["fails"] >= 1 and eh[0]["ejected"]
                assert eh[1]["active"] and not eh[1]["ejected"]
                srv1.close()
                assert c.score_lines(rows) == col
                assert c.port == srv2.port
        finally:
            srv1.close()
            srv2.close()


def test_client_ejection_and_timed_reprobe(models):
    """An ejected endpoint comes back after reprobe_s; a single endpoint
    with retries=0 fails fast."""
    with deadline(60):
        srv = _server(models["a"][0], batch_size=8, max_delay_ms=1.0)
        dead = _free_port()
        try:
            with ServeClient(endpoints=[("127.0.0.1", dead),
                                        (srv.host, srv.port)],
                             retries=1, eject_after=1,
                             reprobe_s=0.2) as c:
                assert c.endpoints_health()[0]["ejected"]
                time.sleep(0.25)
                assert not c.endpoints_health()[0]["ejected"]
                with pytest.raises(OSError):
                    ServeClient("127.0.0.1", dead, retries=0)
        finally:
            srv.close()


# -------------------------------------------------------- fleethealth
@pytest.mark.parametrize("writers,max_bytes", [(2, None), (3, 4096)],
                         ids=["two_processes", "three_compacting"])
def test_fleethealth_concurrent_writer_processes(tmp_path, writers,
                                                 max_bytes):
    """Writer processes hammer one blacklist file through the port's
    module (loaded standalone, stdlib only) while this process folds it:
    no torn line, and each writer's final per-endpoint state survives
    (compaction included)."""
    bl = str(tmp_path / "blacklist")
    n = 300 if max_bytes else 200
    tags = "abc"[:writers]
    stop, errs = threading.Event(), []
    reader = FleetHealth(bl, down_s=3600.0)

    def hammer():
        while not stop.is_set():
            try:
                reader.down_endpoints()
            except Exception as e:  # noqa: BLE001 - the assertion
                errs.append(repr(e))

    th = threading.Thread(target=hammer)
    with deadline(120):
        th.start()
        try:
            extra = [str(max_bytes)] if max_bytes else []
            procs = [subprocess.Popen(
                [sys.executable, WORKER, FLEETHEALTH, bl, tag, str(n)]
                + extra, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                for tag in tags]
            for p in procs:
                _, err = p.communicate(timeout=90)
                assert p.returncode == 0, err.decode()[-2000:]
        finally:
            stop.set()
            th.join()
    assert not errs, errs[:5]
    lines = [ln for ln in open(bl, "rb").read().splitlines() if ln.strip()]
    if not max_bytes:
        assert len(lines) == writers * n
    for ln in lines:
        rec = json.loads(ln)
        assert rec["op"] in ("down", "clear") and ":" in rec["ep"]
    downs = FleetHealth(bl, down_s=3600.0).down_endpoints()
    for tag in tags:
        want = set()
        for j in range(7):
            last = max(k for k in range(n) if k % 7 == j)
            if last % 2 == 0:
                want.add(f"host-{tag}:{1000 + j}")
        assert {ep for ep in downs if ep.startswith(f"host-{tag}:")} \
            == want


def test_fleethealth_marks_expire_clear_and_degrade(tmp_path):
    """A down mark suppresses for ``down_s`` only and a clear lifts it
    early, for every handle on the file; a missing file reads as nothing
    down, a torn line is skipped, and compaction bounds the file."""
    bl = str(tmp_path / "blacklist")
    fh = FleetHealth(bl, down_s=1.0)
    fh.mark_down("h", 9000)
    assert fh.is_down("h", 9000)
    assert 0.0 < fh.down_remaining("h", 9000) <= 1.001
    assert FleetHealth(bl, down_s=1.0).is_down("h", 9000)
    time.sleep(1.05)
    assert not fh.is_down("h", 9000)
    fh.mark_down("h", 9000)
    fh.mark_up("h", 9000)
    assert not FleetHealth(bl, down_s=1.0).is_down("h", 9000)
    fh.mark_down("other", 9001)
    assert not fh.is_down("h", 9000) and fh.is_down("other", 9001)

    assert FleetHealth(str(tmp_path / "never")).down_endpoints() == {}
    torn = str(tmp_path / "torn")
    good = FleetHealth(torn, down_s=60.0)
    good.mark_down("h", 1)
    with open(torn, "ab") as f:
        f.write(b'{"ts": 1, "op"')
    good.mark_down("h2", 2)
    assert set(FleetHealth(torn, down_s=60.0).down_endpoints()) \
        == {"h:1", "h2:2"}
    assert open_blacklist(None) is None and open_blacklist(good) is good
    assert isinstance(open_blacklist(torn), FleetHealth)

    small = str(tmp_path / "small")
    fs = FleetHealth(small, down_s=60.0, max_bytes=2048)
    for k in range(200):
        fs.mark_down("h", 7000 + k % 3)
        fs.mark_up("h", 7000 + k % 3)
    fs.mark_down("live", 8000)
    assert pathlib.Path(small).stat().st_size < 2048 + 512
    assert FleetHealth(small, down_s=60.0).is_down("live", 8000)


def test_fleethealth_clients_share_ejections(models, rows, tmp_path):
    """One client's ejection lands in the shared file; the next client
    skips the dead endpoint on its FIRST connect (no dial, no failover),
    and a client connected before a mark sees it at its next connect."""
    model, col = models["a"]
    bl = str(tmp_path / "blacklist")
    with deadline(120):
        srv = _server(model, batch_size=8, max_delay_ms=1.0)
        srv_b = _server(model, batch_size=8, max_delay_ms=1.0)
        dead = ("127.0.0.1", _free_port())
        live = (srv.host, srv.port)
        try:
            with ServeClient(endpoints=[dead, live], retries=3,
                             eject_after=1, backoff_s=0.01,
                             blacklist=bl) as ca:
                assert ca.failovers >= 1
                assert ca.endpoints_health()[0]["ejected"]
                assert ca.score_lines(rows[:3]) == col[:3]
            assert FleetHealth(bl, down_s=5.0).is_down(*dead)
            with ServeClient(endpoints=[dead, live], retries=1,
                             blacklist=bl) as cb:
                assert cb.failovers == 0 and (cb.host, cb.port) == live
                assert cb.endpoints_health()[0]["fails"] == 0
                assert cb.score_lines(rows[:2]) == col[:2]
                assert cb.endpoints_health()[1]["rows"] >= 2
            bl2 = str(tmp_path / "blacklist2")
            with ServeClient(endpoints=[live, (srv_b.host, srv_b.port)],
                             retries=1, blacklist=bl2) as cc:
                assert cc.score_lines(rows[:1]) == col[:1]
                cc.close()
                srv.close()
                FleetHealth(bl2, down_s=30.0).mark_down(*live)
                assert cc.score_lines(rows[:1]) == col[:1]
                assert cc.failovers == 0
                assert (cc.host, cc.port) == (srv_b.host, srv_b.port)
        finally:
            srv.close()
            srv_b.close()


# -------------------------------------------------------- fault points
@pytest.mark.parametrize("point", ["batcher.enqueue", "serve.sock.read",
                                   "serve.sock.write", "serve.handoff",
                                   "reload.warm"])
def test_serve_fault_points(models, rows, point):
    """Each fault point of the serve path fires, counts into
    ``faults_fired_total`` and fails safe: an admission fault answers
    ``!err`` per row and admission resumes when disarmed; a torn
    connection (read or write side) is survived by the retrying client,
    which scores every row; a handoff fault refuses the handoff (no
    drain); a warm fault aborts the blue/green swap with the old model
    serving."""
    model, col = models["a"]
    kind = "close" if point.startswith("serve.sock") else "err"
    before = REGISTRY.value("faults_fired_total", point=point, kind=kind)
    with deadline(120):
        srv = _server(model, batch_size=10, max_delay_ms=5.0)
        srv.reloader = ModelReloader(srv.executor, model, server=srv)
        try:
            with ServeClient(srv.host, srv.port, retries=10,
                             deadline_s=60.0) as c:
                assert c.score_lines(rows[:10]) == col[:10]
                if point == "batcher.enqueue":
                    faultinject.configure(f"{point}:err@1")
                    assert c.predict(rows[:10]) == [None] * 10
                    fired = faultinject.stats()
                    faultinject.configure("")
                    assert c.stats()["errors"] >= 10
                    assert c.score_lines(rows[:10]) == col[:10]
                elif kind == "close":
                    faultinject.configure(f"{point}:close@1:30")
                    got = []
                    for i in range(0, 100, 10):
                        got.extend(c.score_lines(rows[i:i + 10]))
                    fired = faultinject.stats()
                    faultinject.configure("")
                    assert got == col
                elif point == "serve.handoff":
                    faultinject.configure(f"{point}:err@1")
                    resp = c.score_lines([b"#handoff"])[0]
                    fired = faultinject.stats()
                    faultinject.configure("")
                    assert resp.startswith(b"!err"), resp
                    assert not srv.draining
                    assert c.health()["status"] == "ready"
                else:
                    faultinject.configure(f"{point}:err@1")
                    res = c.reload(models["g"][0])
                    fired = faultinject.stats()
                    faultinject.configure("")
                    assert not res["ok"], res
                    st = c.stats()
                    assert st["reload_failures"] == 1
                    assert st["model_generation"] == 1
                    assert st["bluegreen_swaps"] == 0
                    assert st["swap_state"] == "idle"
                    assert c.score_lines(rows) == col
        finally:
            faultinject.configure("")
            srv.close()
    assert fired.get(point, 0) >= 1, fired
    assert REGISTRY.value("faults_fired_total", point=point,
                          kind=kind) > before


def test_no_serve_threads_leak_overall():
    """Whatever ran before this test in this file, no serve thread is
    left (sockets close with their threads)."""
    names = [t.name for t in threading.enumerate()
             if t.name.startswith(("serve-", "bluegreen-"))]
    assert not names, names
