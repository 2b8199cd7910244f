"""The port's fleet (rolling restart, health gate, router groups, the
autoscaler and the fleet CLI) against the JAX package's, on the CPU.

One model trained by the JAX package on the rcv1 fixture; its
``task=pred`` column is the golden. The counterparts of the JAX fleet
acceptance tests run on the port's in-process replicas and routers (the
successors are in-process too, through ``spawn_fn``): a rolling restart
behind the router under ``run_loadgen`` with no ``!err`` and no
``!shed``, the ready-timeout abort, the unready-fleet gate, a router
group member killed and the group rolled under
``run_loadgen_failover``, the compound kill, roll and scale, the four
fault points' aborts and the ``routers`` supervisor's relaunches. On the
same scripted ``#health`` payloads the port's ``HealthGate`` gives JAX's
verdicts and its ``Autoscaler.step()`` JAX's actions. One test drives
the CLI (``python -m difacto_tpu_torch.tools.fleet route|roll|health``)
with a real successor process on the CPU. No fleet thread is left
behind.

Every socket test runs under its own SIGALRM deadline.
"""

import contextlib
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

import difacto_tpu.serve.autoscale as jautoscale
import difacto_tpu.serve.fleet as jfleet
from difacto_tpu.__main__ import main as jmain
from difacto_tpu.utils import faultinject as jfaults
import difacto_tpu_torch.serve.autoscale as pautoscale
import difacto_tpu_torch.serve.fleet as pfleet
from difacto_tpu_torch.obs import REGISTRY
from difacto_tpu_torch.serve import (Autoscaler, HealthGate, RouterServer,
                                     ServeClient, ServeServer,
                                     open_serving_store,
                                     run_rolling_restart,
                                     run_router_group_roll)
from difacto_tpu_torch.serve.fleet import fresh_health
from difacto_tpu_torch.tools import fleet as fleet_cli
from difacto_tpu_torch.tools.loadgen import (run_loadgen,
                                             run_loadgen_failover)
from difacto_tpu_torch.utils import faultinject

REPO = pathlib.Path(__file__).resolve().parent.parent
_TRAIN = ["V_dim=2", "hash_capacity=4096", "max_num_epochs=2",
          "V_threshold=2", "lr=0.1", "l1=0.1", "l2=0",
          "num_jobs_per_epoch=1", "batch_size=100", "shuffle=0",
          "report_interval=0", "stop_rel_objv=0"]


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
    jfaults.configure("")


@pytest.fixture(scope="module")
def model(rcv1_path, tmp_path_factory):
    """(model prefix, JAX pred probability column as bytes)."""
    d = tmp_path_factory.mktemp("fleet_model")
    prefix = str(d / "m")
    args = [f"data_in={rcv1_path}"] + _TRAIN
    assert jmain(args + [f"model_out={prefix}"]) == 0
    assert jmain(args + ["task=pred", f"model_in={prefix}",
                         f"data_val={rcv1_path}",
                         f"pred_out={d / 'pred'}"]) == 0
    with open(d / "pred_part-0", "rb") as f:
        col = [l.split(b"\t")[1] for l in f.read().splitlines()]
    assert len(col) == 100
    return prefix, col


@pytest.fixture(scope="module")
def rows(rcv1_path):
    with open(rcv1_path, "rb") as f:
        return [r for r in f.read().splitlines() if r.strip()]


def _serve(prefix, **kw):
    store, _, _ = open_serving_store(prefix, device="cpu")
    return ServeServer(store, batch_size=64, max_delay_ms=2.0,
                       takeover=True, **kw).start()


def _fleet(prefix, n):
    """n in-process takeover-ready port replicas: (servers dict
    endpoint -> [incumbent, successors...], endpoint list)."""
    servers, eps = {}, []
    for _ in range(n):
        srv = _serve(prefix)
        servers[f"{srv.host}:{srv.port}"] = [srv]
        eps.append((srv.host, srv.port))
    return servers, eps


def _inproc_spawn(prefix, servers):
    """spawn_fn of run_rolling_restart: an in-process successor on the
    shared SO_REUSEPORT port, kept in ``servers`` for teardown."""
    def spawn(i, host, port, ready_file):
        srv = _serve(prefix, host=host, port=port)
        srv.ready_file = ready_file
        with open(ready_file, "w") as f:
            f.write(f"{srv.host} {srv.port}\n")
        servers[f"{host}:{port}"].append(srv)
        return None
    return spawn


def _router_group(eps, n=2, **kw):
    group = [RouterServer(eps, takeover=True, **kw).start()]
    for _ in range(n - 1):
        group.append(RouterServer(eps, host=group[0].host,
                                  port=group[0].port, takeover=True,
                                  **kw).start())
    return group


def _inproc_router_spawn(eps, group):
    def spawn(i, host, port, ready_file):
        r = RouterServer(eps, host=host, port=port, takeover=True,
                         ready_file=ready_file).start()
        with open(ready_file, "w") as f:
            f.write(f"{r.host} {r.port}\n")
        group.append(r)
        return None
    return spawn


def _close(*groups):
    for g in groups:
        for lst in (g.values() if isinstance(g, dict) else [g]):
            for obj in (lst if isinstance(lst, list) else [lst]):
                obj.close()


# ------------------------------------------------------ rolling restart
def test_rolling_restart_behind_router_under_load(model, rows, tmp_path):
    """Three replicas rolled one at a time behind the router while
    ``run_loadgen`` offers 100 rows/s: every replica replaced, no ``!err``
    and no ``!shed`` (the router re-forwards each drain window's shed rows
    to a peer), the whole fleet ready afterwards and answering JAX's pred
    bytes."""
    prefix, col = model
    with deadline(300):
        servers, eps = _fleet(prefix, 3)
        router = RouterServer(eps, blacklist=str(tmp_path / "bl")).start()
        rep = {}
        t = threading.Thread(target=lambda: rep.update(
            run_loadgen(router.host, router.port, rows, qps=100,
                        duration_s=6.0)))
        try:
            t.start()
            time.sleep(1.0)
            roll = run_rolling_restart(eps, spawn_fn=_inproc_spawn(
                prefix, servers), wait_s=60.0)
            t.join()
            with ServeClient(router.host, router.port) as c:
                h = c.health()
                st = c.stats()
                assert c.score_lines(rows) == col
        finally:
            router.close()
            _close(servers)
    assert roll["ok"] and len(roll["replicas"]) == 3, roll
    for r in roll["replicas"]:
        assert r["incumbent"] != r["successor"], r
    assert rep["err"] == 0 and rep["shed"] == 0 and rep["ok"] > 0, rep
    assert h["router"] and h["status"] == "ready", h
    assert h["replicas_live"] == 3, h
    assert {r["server_id"] for r in h["replicas"]} == \
        {r["successor"] for r in roll["replicas"]}, h
    assert st["rows"] >= rep["ok"], st
    assert sum(b["rows"] for b in st["backends"]) == st["rows"], st


def test_rolling_restart_aborts_on_ready_timeout(model):
    """Replica 1's successor never writes its ready file: the rollout
    aborts at 1 with that incumbent serving, replica 2 untouched, replica
    0 replaced, and the half-up successor reaped."""
    prefix, _ = model

    class _NeverReady:
        terminated = False

        def poll(self):
            return None

        def terminate(self):
            self.terminated = True

    with deadline(120):
        servers, eps = _fleet(prefix, 3)
        good = _inproc_spawn(prefix, servers)
        stuck = _NeverReady()

        def spawn(i, host, port, ready_file):
            return stuck if i == 1 else good(i, host, port, ready_file)

        try:
            before = {ep: fresh_health(*ep)["server_id"] for ep in eps}
            roll = run_rolling_restart(eps, spawn_fn=spawn, wait_s=2.0,
                                       gate_wait_s=5.0)
            after = {ep: fresh_health(*ep) for ep in eps}
        finally:
            _close(servers)
    assert not roll["ok"] and roll["aborted_at"] == 1, roll
    assert "ready" in roll["reason"] and len(roll["completed"]) == 1, roll
    assert stuck.terminated
    for ep in eps[1:]:
        assert after[ep]["status"] == "ready"
        assert after[ep]["server_id"] == before[ep]
    assert after[eps[0]]["server_id"] != before[eps[0]]


def test_fleet_handoff_fault_aborts_rollout(model):
    """``fleet.handoff:err`` at replica 1's handoff step aborts the rollout
    there with its incumbent serving; the fire is counted."""
    prefix, _ = model
    fired0 = REGISTRY.value("faults_fired_total", point="fleet.handoff",
                            kind="err")
    with deadline(120):
        servers, eps = _fleet(prefix, 2)
        try:
            before = fresh_health(*eps[1])["server_id"]
            faultinject.configure("fleet.handoff:err@1:1")
            roll = run_rolling_restart(eps, spawn_fn=_inproc_spawn(
                prefix, servers), wait_s=60.0, gate_wait_s=5.0)
            faultinject.configure("")
            h = fresh_health(*eps[1])
        finally:
            faultinject.configure("")
            _close(servers)
    assert not roll["ok"] and roll["aborted_at"] == 1, roll
    assert "fleet.handoff" in roll["reason"], roll
    assert len(roll["completed"]) == 1, roll
    assert h["status"] == "ready" and h["server_id"] == before, h
    assert REGISTRY.value("faults_fired_total", point="fleet.handoff",
                          kind="err") > fired0


def test_gate_rejects_unready_fleet(model):
    """A draining replica stops the rollout at the first gate, before any
    successor is spawned."""
    prefix, _ = model
    with deadline(120):
        servers, eps = _fleet(prefix, 2)
        spawned = []
        try:
            list(servers.values())[1][0].draining = True
            roll = run_rolling_restart(
                eps, spawn_fn=lambda *a: spawned.append(a[0]),
                wait_s=5.0, gate_wait_s=0.5)
        finally:
            _close(servers)
    assert not roll["ok"] and roll["aborted_at"] == 0, roll
    assert not roll["completed"] and "not ready" in roll["reason"], roll
    assert not spawned


# ------------------------------------------------- decisions vs JAX
def _scripted_health(monkeypatch, script, modules):
    """Replace ``fresh_health`` in ``modules`` with a reader of
    ``script[endpoint]``: one payload per call (an Exception instance is
    raised), the last one repeating. Each module gets its own cursor."""
    for mod in modules:
        pos = {}

        def fake(host, port, timeout=5.0, _pos=pos):
            ep = f"{host}:{port}"
            seq = script[ep]
            k = _pos.get(ep, 0)
            _pos[ep] = k + 1
            item = seq[min(k, len(seq) - 1)]
            if isinstance(item, Exception):
                raise item
            return dict(item)

        monkeypatch.setattr(mod, "fresh_health", fake)


def _h(status="ready", depth=0, cap=1024, shed=0.0):
    return {"status": status, "queue_depth": depth, "queue_cap": cap,
            "shed_rate": shed}


def test_health_gate_verdicts_match_jax(monkeypatch):
    """``HealthGate.check_one``, ``check`` and ``check_settled`` give JAX's
    verdicts, word for word, on the same scripted ``#health`` payloads:
    healthy, unreachable, not ready, a queue past ``queue_frac``, a shed
    spike over the first sighting's baseline, and a blip that settles."""
    script = {
        "h:1": [_h(), _h(depth=500), _h(depth=950), _h(shed=0.1),
                _h(shed=0.3), _h(shed=0.36), _h()],
        "h:2": [ConnectionError("connection closed"), _h("draining"),
                _h(), _h(depth=2000, cap=0), _h(shed=0.5)],
        "h:3": [_h("draining"), _h("draining"), _h()],
        "h:4": [_h("down")],
    }
    _scripted_health(monkeypatch, script, [jfleet, pfleet])
    eps = [("h", 1), ("h", 2)]
    out = {}
    for name, cls in (("jax", jfleet.HealthGate), ("port", HealthGate)):
        gate = cls(queue_frac=0.9, shed_spike=0.25)
        seq = [gate.check_one("h", 1) for _ in range(7)]
        seq += [gate.check(eps) for _ in range(4)]
        seq.append(gate.check_settled([("h", 3)], wait_s=5.0,
                                      poll_s=0.01))
        seq.append(gate.check_settled([("h", 4)], wait_s=0.05,
                                      poll_s=0.01))
        out[name] = seq
    assert out["port"] == out["jax"]
    assert out["port"][0] is None and out["port"][-2] is None
    assert sum(v is not None for v in out["port"]) >= 5, out["port"]


def _run_scaler(cls, mod, monkeypatch, tmp_path, name, steps,
                cooldown_s, faults=None):
    """Drive ``cls`` (the JAX or the port Autoscaler) through ``steps``
    scripted polls; returns every step's measurement and what it did."""
    calls = []
    monkeypatch.setattr(mod, "notify_backends",
                        lambda h, p, op, tgt, timeout=5.0:
                        calls.append(("nudge", op, tgt)))
    monkeypatch.setattr(mod, "drain_endpoint",
                        lambda h, p, timeout=10.0:
                        calls.append(("drain", f"{h}:{p}")))
    k = {"i": 0}

    def fake(host, port, timeout=5.0):
        load = steps[k["i"]]["load"].get(f"{host}:{port}", _h())
        if isinstance(load, Exception):
            raise load
        return dict(load)

    monkeypatch.setattr(mod, "fresh_health", fake)

    def spawn(idx):
        if idx == 3:
            raise RuntimeError("no free port")
        return ("10.0.0.1", 7000 + idx)

    ring = tmp_path / f"{name}.ring"
    scaler = cls([("10.0.0.1", 7000)], spawn, router=("10.0.0.9", 9),
                 min_replicas=1, max_replicas=4, up_ticks=2,
                 down_ticks=3, cooldown_s=cooldown_s, up_p99_ms=50.0,
                 down_shed_rate=0.01,
                 latency_fn=lambda: steps[k["i"]]["p99"],
                 endpoints_file=str(ring), ewma=0.5)
    if faults:
        faults.configure("autoscale.spawn:err@1:4")
    seq = []
    try:
        for i in range(len(steps)):
            k["i"] = i
            m = scaler.step()
            seq.append({key: (round(v, 9) if isinstance(v, float) else v)
                        for key, v in m.items()})
    finally:
        if faults:
            faults.configure("")
    events = [{key: v for key, v in e.items() if key != "t"}
              for e in scaler.events]
    return seq, calls, events, ring.read_text()


@pytest.mark.parametrize("cooldown_s", [0.0, 3600.0],
                         ids=["no_cooldown", "cooling"])
def test_autoscaler_actions_match_jax(monkeypatch, tmp_path, cooldown_s):
    """On the same scripted signals (queue depth, shed rate, the latency
    function's p99, an unreachable replica) the port's ``step()`` takes
    JAX's actions in JAX's order (``up``, ``down``, ``abort`` from the
    injected ``autoscale.spawn`` fault and from a failing ``spawn_fn``,
    nothing while cooling), with the same EWMA signals, ring nudges,
    drains, events and ``endpoints_file``."""
    busy = {"10.0.0.1:7000": _h(depth=900)}
    steps = ([{"load": busy, "p99": 10.0}] * 4
             + [{"load": {}, "p99": 80.0}] * 4
             + [{"load": {"10.0.0.1:7001": ConnectionError("gone")},
                 "p99": 0.0}] * 3
             + [{"load": {"10.0.0.1:7000": _h(shed=0.5)},
                 "p99": 0.0}] * 6
             + [{"load": {}, "p99": 0.0}] * 12)
    jseq = _run_scaler(jautoscale.Autoscaler, jautoscale, monkeypatch,
                       tmp_path, "jax", steps, cooldown_s, jfaults)
    pseq = _run_scaler(Autoscaler, pautoscale, monkeypatch, tmp_path,
                       "port", steps, cooldown_s, faultinject)
    assert pseq == jseq
    acts = [m["action"] for m in pseq[0]]
    if cooldown_s:
        assert [a for a in acts if a] == ["up"], acts
    else:
        assert {"up", "down", "abort"} <= set(acts), acts


def test_autoscale_spawn_fault_aborts_then_recovers():
    """``autoscale.spawn:err``: the scale-up is refused and counted in
    ``autoscale_aborts_total``; disarmed, the same overload spawns."""
    fired0 = REGISTRY.value("faults_fired_total", point="autoscale.spawn",
                            kind="err")
    aborts0 = REGISTRY.value("autoscale_aborts_total")
    spawns0 = REGISTRY.value("autoscale_spawns_total")
    spawned = []

    def spawn_fn(idx):
        spawned.append(idx)
        return ("127.0.0.1", 59000 + idx)

    with deadline(60):
        scaler = Autoscaler([("127.0.0.1", 1)], spawn_fn, min_replicas=1,
                            max_replicas=3, poll_s=0.05, up_ticks=1,
                            cooldown_s=0.0, up_p99_ms=10.0,
                            latency_fn=lambda: 1000.0, timeout=0.2)
        faultinject.configure("autoscale.spawn:err@1")
        m = scaler.step()
        assert m["action"] == "abort" and spawned == [], m
        faultinject.configure("")
        m = scaler.step()
    assert m["action"] == "up" and spawned == [1], m
    assert len(scaler.endpoints()) == 2
    assert [e["action"] for e in scaler.events] == ["abort", "up"]
    assert REGISTRY.value("faults_fired_total", point="autoscale.spawn",
                          kind="err") > fired0
    assert REGISTRY.value("autoscale_aborts_total") > aborts0
    assert REGISTRY.value("autoscale_spawns_total") > spawns0


# -------------------------------------------------------- router groups
def test_router_group_survives_member_kill(model, rows):
    """Two routers on one ``SO_REUSEPORT`` port; one closes abruptly
    mid-run. The failover client sees no ``!err``; the survivor answers
    the port, with JAX's pred bytes."""
    prefix, col = model
    with deadline(120):
        servers, eps = _fleet(prefix, 2)
        group = []
        try:
            group = _router_group(eps)
            addr = [(group[0].host, group[0].port)]
            rep = {}
            t = threading.Thread(target=lambda: rep.update(
                run_loadgen_failover(addr, rows, qps=80, duration_s=4.0)))
            t.start()
            time.sleep(1.0)
            group[0].close()
            t.join()
            h = fresh_health(*addr[0])
            with ServeClient(*addr[0]) as c:
                assert c.score_lines(rows) == col
        finally:
            _close(group, servers)
    assert rep["err"] == 0 and rep["ok"] > 0, rep
    assert h["router"] and h["status"] == "ready", h


def test_router_group_roll_zero_errors(model, rows):
    """``run_router_group_roll`` replaces both members of a group under
    ``run_loadgen_failover``: no ``!err``, successors distinct from the
    incumbents."""
    prefix, _ = model
    with deadline(180):
        servers, eps = _fleet(prefix, 2)
        group = []
        try:
            group = _router_group(eps)
            addr = [(group[0].host, group[0].port)]
            rep = {}
            t = threading.Thread(target=lambda: rep.update(
                run_loadgen_failover(addr, rows, qps=80, duration_s=6.0)))
            t.start()
            time.sleep(1.0)
            roll = run_router_group_roll(
                group[0].host, group[0].port, group_size=2,
                spawn_fn=_inproc_router_spawn(eps, group), wait_s=120.0)
            t.join()
        finally:
            _close(group, servers)
    assert roll["ok"] and len(roll["routers"]) == 2, roll
    assert not ({r["incumbent"] for r in roll["routers"]}
                & {r["successor"] for r in roll["routers"]}), roll
    assert rep["err"] == 0 and rep["ok"] > 0, rep


def test_compound_kill_roll_scale(model, rows):
    """Two routers x two replicas under open-loop load: one router is
    killed, every replica rolled and a scale-up forced. No ``!err``; the
    spawn joins the surviving router's ring (``#backends add`` through
    ``notify_backends``) and its counter rides that router's ``#metrics``;
    the settled fleet sheds nothing and answers JAX's pred bytes."""
    prefix, col = model
    spawns0 = REGISTRY.value("autoscale_spawns_total")
    with deadline(300):
        servers, eps = _fleet(prefix, 2)
        group, extra, scaler = [], [], None
        try:
            group = _router_group(eps)
            addr = [(group[0].host, group[0].port)]

            def spawn_fn(idx):
                srv = _serve(prefix)
                extra.append(srv)
                return (srv.host, srv.port)

            box = {"p99": 0.0}
            scaler = Autoscaler(
                eps, spawn_fn, router=addr[0], min_replicas=2,
                max_replicas=3, poll_s=0.1, up_ticks=1,
                down_ticks=10 ** 6, cooldown_s=0.5, up_p99_ms=50.0,
                latency_fn=lambda: box["p99"], ewma=1.0).start()
            rep = {}
            t = threading.Thread(target=lambda: rep.update(
                run_loadgen_failover(addr, rows, qps=80, duration_s=8.0)))
            t.start()
            time.sleep(1.0)
            group[0].close()
            time.sleep(0.5)
            roll = run_rolling_restart(eps, spawn_fn=_inproc_spawn(
                prefix, servers), wait_s=60.0)
            box["p99"] = 1000.0
            t0 = time.monotonic()
            while (not any(e["action"] == "up" for e in scaler.events)
                   and time.monotonic() - t0 < 20.0):
                time.sleep(0.05)
            box["p99"] = 0.0
            t.join()
            with ServeClient(*addr[0]) as c:
                h = c.health()
                text = c.metrics()
                assert c.score_lines(rows) == col
            rep2 = run_loadgen_failover(addr, rows, qps=80, duration_s=1.5)
        finally:
            if scaler is not None:
                scaler.close()
            _close(group, servers, extra)
    assert roll["ok"], roll
    assert rep["err"] == 0 and rep["ok"] > 0, rep
    assert sum(e["action"] == "up" for e in scaler.events) >= 1
    assert REGISTRY.value("autoscale_spawns_total") > spawns0
    assert h["router"] and h["status"] == "ready", h
    assert h["replicas_live"] == 3, h
    assert "autoscale_spawns_total" in text, text[:400]
    assert "router_affinity_hit_rate" in text, text[:400]
    assert rep2["err"] == 0 and rep2["shed"] == 0, rep2


def test_routers_supervisor_relaunches_dead_member():
    """``run_router_group``: a member that exits is relaunched on the
    backoff schedule (counted), the live one is left alone."""
    before = REGISTRY.value("router_group_relaunches_total")
    sleeps = []

    def sleep_fn(d):
        sleeps.append(d)
        time.sleep(min(d, 0.02))

    def cmd_fn(i):
        if i == 0:
            return [sys.executable, "-c", "import time; time.sleep(60)"]
        return [sys.executable, "-c", "pass"]

    with deadline(60):
        rep = fleet_cli.run_router_group(
            2, cmd_fn, max_seconds=3.0, poll_s=0.01, backoff_base_s=0.01,
            sleep_fn=sleep_fn, max_relaunches=3)
    assert rep["ok"] and rep["relaunches"] == 3, rep
    assert len(sleeps) >= 3
    assert REGISTRY.value("router_group_relaunches_total") >= before + 3
    # JAX's launcher schedule: floored at the base, capped, jittered
    import random
    rng = random.Random(5)
    ds = [fleet_cli.relaunch_delay(a, 1.0, rng) for a in range(12)]
    assert all(1.0 <= d <= 1.5 * fleet_cli.RELAUNCH_BACKOFF_CAP_S
               for d in ds), ds


# ------------------------------------------------------------------ CLI
def _running(pid: int) -> bool:
    """The process exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _cli(*args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("DIFACTO_FAULTS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "difacto_tpu_torch.tools.fleet", *args],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, **kw)


def test_fleet_cli_route_roll_health(model, rows, tmp_path):
    """The port's CLI: ``route`` in front of a replica, ``roll`` replacing
    it with a real ``python -m difacto_tpu_torch task=serve device=cpu``
    successor, ``health`` passing the gate; the router's answers equal
    JAX's pred bytes before and after, and the successor drains on
    SIGTERM."""
    prefix, col = model
    ready = tmp_path / "router.ready"
    succ_pid = None
    with deadline(240):
        srv = _serve(prefix)
        ep = f"{srv.host}:{srv.port}"
        route = _cli("route", "--endpoints", ep, "--ready-file",
                     str(ready), "--max-seconds", "200")
        try:
            while not (ready.exists() and ready.read_text()):
                assert route.poll() is None, route.communicate()[1][-2000:]
                time.sleep(0.05)
            rh, rp = ready.read_text().split()
            with ServeClient(rh, int(rp)) as c:
                assert c.score_lines(rows) == col
            roll = _cli("roll", "--endpoints", ep, "--model", prefix,
                        "--serve-arg", "device=cpu", "--wait-s", "120")
            out, err = roll.communicate(timeout=200)
            assert roll.returncode == 0, err[-3000:]
            rep = json.loads(out.strip().splitlines()[-1])
            assert rep["ok"] and len(rep["replicas"]) == 1, rep
            h = fresh_health(srv.host, srv.port)
            succ_pid = h["pid"]
            assert succ_pid != os.getpid()
            assert h["server_id"] == rep["replicas"][0]["successor"]
            health = _cli("health", "--endpoints", ep)
            hout, herr = health.communicate(timeout=120)
            assert health.returncode == 0, herr[-2000:]
            assert json.loads(hout.strip().splitlines()[-1])["ok"]
            with ServeClient(rh, int(rp)) as c:
                assert c.score_lines(rows) == col
                st = c.stats()
            assert st["errors"] == 0 and st["rows"] == 200, st
            assert srv._is_closed()
            os.kill(succ_pid, signal.SIGTERM)
            t0 = time.monotonic()
            while time.monotonic() - t0 < 60:
                if not _running(succ_pid):
                    succ_pid = None
                    break
                time.sleep(0.05)
            assert succ_pid is None, "the successor did not exit on SIGTERM"
        finally:
            srv.close()
            if succ_pid is not None and _running(succ_pid):
                os.kill(succ_pid, signal.SIGKILL)
            route.terminate()
            route.communicate(timeout=60)


def test_fleet_cli_routers_and_scale(model, rows, tmp_path):
    """``routers`` supervises a group of two ``route --takeover`` members
    on one port (fresh dials reach both, and each answers JAX's pred
    bytes) and takes them down with it on SIGTERM; ``scale`` at min = max
    = 1 measures the fleet, writes the ring file and exits with its
    report."""
    prefix, col = model
    with deadline(180):
        srv = _serve(prefix)
        ep = f"{srv.host}:{srv.port}"
        port = _free_port()
        group = _cli("routers", "--n", "2", "--port", str(port),
                     "--endpoints", ep, "--max-seconds", "60")
        scale = None
        try:
            seen = {}
            t0 = time.monotonic()
            while len(seen) < 2 and time.monotonic() - t0 < 90:
                assert group.poll() is None, group.communicate()[1][-2000:]
                try:
                    seen.setdefault(
                        fresh_health("127.0.0.1", port)["server_id"], 1)
                except (OSError, ConnectionError, ValueError):
                    time.sleep(0.1)
            assert len(seen) == 2, seen
            for _ in range(4):
                with ServeClient("127.0.0.1", port) as c:
                    assert c.score_lines(rows[:20]) == col[:20]
            ring = tmp_path / "ring"
            scale = _cli("scale", "--endpoints", ep, "--model", prefix,
                         "--serve-arg", "device=cpu", "--min", "1",
                         "--max", "1",
                         "--poll-s", "0.2", "--max-seconds", "1.5",
                         "--endpoints-file", str(ring))
            out, err = scale.communicate(timeout=120)
            assert scale.returncode == 0, err[-2000:]
            rep = json.loads(out.strip().splitlines()[-1])
            assert rep == {"replicas": 1, "events": []}, rep
            assert ring.read_text() == f"{ep}\n"
            group.terminate()
            group.communicate(timeout=30)
            assert group.returncode == 0
            with pytest.raises(OSError):
                fresh_health("127.0.0.1", port, timeout=2.0)
        finally:
            srv.close()
            if group.poll() is None:
                group.kill()
                group.communicate()
            if scale is not None and scale.poll() is None:
                scale.kill()
                scale.wait()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_no_fleet_threads_leak_overall():
    """Whatever ran before this test in this file, no router, serve or
    autoscaler thread is left."""
    names = [t.name for t in threading.enumerate()
             if t.name.startswith(("router-", "serve-", "autoscaler"))]
    assert not names, names
