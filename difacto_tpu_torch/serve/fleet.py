"""Fleet orchestration over the wire (counterpart of
difacto_tpu/serve/fleet.py): the held control connection
(:class:`EndpointRpc`), fresh ``#health``/``#stats`` probes, the
scale-down drain, one ``SO_REUSEPORT`` takeover (:func:`run_takeover`),
the health-gated rolling restart over N replicas, the router group roll
and the autoscaler's ring nudge.

One takeover: hold a connection to the incumbent while it is the only
listener, spawn the successor (``python -m difacto_tpu_torch task=serve
serve_takeover=1 ...``, which writes its ready file once listening),
send ``#handoff <ready_file>`` on the held connection, then poll fresh
connections until the successor's ``server_id`` answers ready.

:func:`run_rolling_restart` repeats it replica by replica behind a
:class:`HealthGate`: ``#health`` of EVERY replica is polled before each
handoff and after it, and the rollout aborts, leaving the incumbent
serving, on a replica not ``ready``, a queue past ``queue_frac`` of its
cap, a shed rate past the rollout's baseline, or a successor whose
ready file never appears. ``fleet.handoff`` is the fault point at each
replica's handoff step (``err`` aborts the rollout).

:func:`run_router_group_roll` replaces every member of an N-router
``SO_REUSEPORT`` group (``python -m difacto_tpu_torch.tools.fleet route
--takeover``): members share one port, so the roll redials it until
the connection it HOLDS answers ``#health`` with the ``server_id`` it
means, and sends ``#handoff`` there. :func:`notify_backends` is the
autoscaler's ``#backends add|remove`` nudge to every member, by the same
redialing.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..config import parse_endpoints
from ..utils import faultinject

log = logging.getLogger("difacto_tpu_torch")

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class EndpointRpc:
    """One newline-JSON control channel over a held TCP connection.

    Holding matters under SO_REUSEPORT: a FRESH connection hashes to any
    listener on the port, but an ESTABLISHED one stays with its owner —
    so a ``#handoff`` sent on a connection opened while the incumbent was
    the only listener provably reaches the incumbent."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.rfile = self.sock.makefile("rb")

    def call(self, line: str) -> dict:
        self.sock.sendall(line.encode() + b"\n")
        resp = self.rfile.readline()
        if not resp:
            raise ConnectionError("connection closed")
        if resp.startswith(b"!err"):
            raise ConnectionError(resp.rstrip(b"\n").decode())
        return json.loads(resp)

    def close(self) -> None:
        try:
            self.rfile.close()
            self.sock.close()
        except OSError:
            pass


def fresh_health(host: str, port: int, timeout: float = 5.0) -> dict:
    """#health over a throwaway connection — what a load balancer polls;
    under a takeover it answers from whichever replica currently owns
    fresh connections."""
    rpc = EndpointRpc(host, port, timeout=timeout)
    try:
        return rpc.call("#health")
    finally:
        rpc.close()


def fresh_stats(host: str, port: int, timeout: float = 5.0) -> dict:
    """#stats over a throwaway connection: a replica's serving
    counters."""
    rpc = EndpointRpc(host, port, timeout=timeout)
    try:
        return rpc.call("#stats")
    finally:
        rpc.close()


def drain_endpoint(host: str, port: int, timeout: float = 10.0) -> dict:
    """Scale-down primitive: a bare ``#handoff`` (no ready file) tells
    the replica or router to drain NOW — in-flight work finishes, fresh
    connections land elsewhere, the process leaves its serve loop."""
    rpc = EndpointRpc(host, port, timeout=timeout)
    try:
        return rpc.call("#handoff")
    finally:
        rpc.close()


def notify_backends(host: str, port: int, op: str, target: str,
                    max_dials: int = 16, settle: int = 4,
                    timeout: float = 5.0) -> dict:
    """Tell every member of a router group about a ring change:
    ``#backends <op> <target>`` (op ``add``/``remove``, target
    ``host:port``). Fresh connections hash across the SO_REUSEPORT
    group, so dial until ``settle`` consecutive dials reach only
    already-acked members; the op is idempotent per member. Best-effort
    by design — the routers' ``endpoints_file`` re-fold is the durable
    channel, this is the low-latency nudge."""
    acks: Dict[str, dict] = {}
    misses = dials = 0
    line = f"#backends {op} {target}".strip()
    while dials < max_dials and misses < settle:
        dials += 1
        try:
            rpc = EndpointRpc(host, port, timeout=timeout)
            try:
                r = rpc.call(line)
            finally:
                rpc.close()
        except (OSError, ConnectionError, ValueError):
            misses += 1
            continue
        sid = str(r.get("server_id", f"dial-{dials}"))
        if sid in acks:
            misses += 1
        else:
            misses = 0
            acks[sid] = r
    return {"ok": bool(acks), "routers": acks}


class HealthGate:
    """The regression detector around every handoff.

    One instance spans a rollout: the first sighting of each endpoint
    records its baseline shed rate, so "spike" means *worse than when
    this rollout started*, not worse than zero (a fleet already shedding
    at its admission bound is not a reason to freeze rollouts — getting
    MORE shed during one is)."""

    def __init__(self, queue_frac: float = 0.9, shed_spike: float = 0.25,
                 timeout: float = 5.0):
        self.queue_frac = queue_frac
        self.shed_spike = shed_spike
        self.timeout = timeout
        self._baseline_shed: Dict[str, float] = {}

    def check_one(self, host: str, port: int) -> Optional[str]:
        """None when healthy, else the human-readable regression."""
        ep = f"{host}:{port}"
        try:
            h = fresh_health(host, port, timeout=self.timeout)
        except (OSError, ConnectionError, ValueError) as e:
            return f"{ep} unreachable: {e}"
        if h.get("status") != "ready":
            return f"{ep} not ready (status={h.get('status')!r})"
        depth, cap = h.get("queue_depth", 0), h.get("queue_cap", 0)
        if cap and depth > self.queue_frac * cap:
            return (f"{ep} queue depth blowup: {depth}/{cap} rows "
                    f"(gate at {self.queue_frac:.0%})")
        shed = float(h.get("shed_rate", 0.0))
        base = self._baseline_shed.setdefault(ep, shed)
        if shed > base + self.shed_spike:
            return (f"{ep} shed-rate spike: {shed:.4f} vs baseline "
                    f"{base:.4f} (gate at +{self.shed_spike})")
        return None

    def check(self, endpoints: List[Tuple[str, int]]) -> Optional[str]:
        """First regression across the fleet, or None."""
        for host, port in endpoints:
            reason = self.check_one(host, port)
            if reason is not None:
                return reason
        return None

    def check_settled(self, endpoints: List[Tuple[str, int]],
                      wait_s: float = 10.0,
                      poll_s: float = 0.2) -> Optional[str]:
        """``check`` with a settle window: a handoff's transient blip —
        the incumbent's dying listener resetting a probe that raced into
        its backlog, a queue momentarily deep while the tail fails over
        — is not a regression; STAYING unhealthy for ``wait_s`` is. The
        rollout gates on this, so it halts on real damage without
        flapping on the rotation it is itself causing."""
        t0 = time.monotonic()
        reason = self.check(endpoints)
        while reason is not None and time.monotonic() - t0 < wait_s:
            time.sleep(poll_s)
            reason = self.check(endpoints)
        return reason


def spawn_successor(model: str, port: int, ready_file: str, extra=(),
                    host: str = "127.0.0.1",
                    device="cuda") -> "subprocess.Popen":
    """Default successor: a fresh task=serve process of the port on the
    shared port (serve_takeover=1 so the kernel accepts the second
    binding), on ``device``. Its output goes to ``<ready_file>.log`` —
    not the caller's inherited pipes, which a parent capturing the
    caller's output would otherwise wait on for the successor's life."""
    args = [sys.executable, "-m", "difacto_tpu_torch", "task=serve",
            f"model_in={model}", f"serve_host={host}",
            f"serve_port={port}", "serve_takeover=1",
            f"serve_ready_file={ready_file}", f"device={device}", *extra]
    logf = open(ready_file + ".log", "ab")
    try:
        return subprocess.Popen(args, cwd=REPO, stdin=subprocess.DEVNULL,
                                stdout=logf, stderr=logf,
                                start_new_session=True)
    finally:
        logf.close()   # the child holds its own descriptor


def _wait_ready_file(ready_file: str, proc, wait_s: float,
                     poll_s: float) -> float:
    """Block until the successor writes its ready file; returns the warm
    seconds. Raises on successor exit or timeout — BEFORE any handoff,
    so the incumbent is untouched."""
    t0 = time.monotonic()
    while not os.path.exists(ready_file):
        if proc is not None and getattr(proc, "poll", None) \
                and proc.poll() is not None:
            raise RuntimeError(
                f"successor exited rc={proc.poll()} before ready")
        if time.monotonic() - t0 > wait_s:
            raise TimeoutError(
                f"successor not ready after {wait_s:.0f}s")
        time.sleep(poll_s)
    return time.monotonic() - t0


def _wait_takeover(host: str, port: int, incumbent_id: str,
                   wait_s: float, poll_s: float) -> dict:
    """Poll fresh connections until the successor answers ready."""
    t0 = time.monotonic()
    while True:
        try:
            h = fresh_health(host, port)
            if h.get("server_id") != incumbent_id \
                    and h.get("status") == "ready":
                return h
        except (OSError, ConnectionError, ValueError):
            pass
        if time.monotonic() - t0 > wait_s:
            raise TimeoutError(
                "takeover never completed: fresh connections still "
                "reach the incumbent (or nothing)")
        time.sleep(poll_s)


def _wait_departed(incumbent: EndpointRpc, wait_s: float) -> None:
    """Block until the draining incumbent closes the held connection
    (its drain ends in close(), which shuts every connection down). The
    next replica hands off only then, so no two incumbents drain at
    once: a router re-forwards a draining replica's shed rows to a peer
    once, and that peer must not be draining too."""
    incumbent.sock.settimeout(wait_s)
    try:
        while incumbent.rfile.readline():
            pass
    except socket.timeout:
        raise TimeoutError(f"the incumbent still held its connections "
                           f"{wait_s:.0f}s after the handoff") from None
    except OSError:
        pass


def run_takeover(host: str, port: int, model: str = "", extra=(),
                 spawn_fn=None, wait_s: float = 180.0,
                 poll_s: float = 0.05, device="cuda") -> dict:
    """Sequence ONE takeover; returns the report dict. ``spawn_fn``
    (ready_file -> handle with .poll(), or None) overrides the
    subprocess successor (on ``device``) for in-process tests."""
    # 1. hold a connection to the incumbent while it is the only
    #    listener — #handoff later rides this connection, immune to
    #    SO_REUSEPORT's fresh-connection hashing
    incumbent = EndpointRpc(host, port)
    try:
        h0 = incumbent.call("#health")
        if not h0.get("takeover"):
            raise SystemExit(
                "incumbent is not running serve_takeover=1 — restart it "
                "once with the knob before zero-downtime handoffs work")
        incumbent_id = h0["server_id"]

        # 2. spawn the successor; it loads + warms, binds the shared
        #    port, then writes its ready file
        fd, ready_file = tempfile.mkstemp(suffix=".ready")
        os.close(fd)
        os.unlink(ready_file)   # the successor's write IS the signal
        proc = (spawn_fn(ready_file) if spawn_fn is not None
                else spawn_successor(model, port, ready_file, extra,
                                     host=host, device=device))
        warm_s = _wait_ready_file(ready_file, proc, wait_s, poll_s)

        # 3. handoff: the incumbent confirms the ready file, drains and
        #    exits; its established connections finish first
        t1 = time.monotonic()
        res = incumbent.call(f"#handoff {ready_file}")

        # 4. fresh connections answer from the successor, ready
        h = _wait_takeover(host, port, incumbent_id, wait_s, poll_s)
        out = {"ok": True, "incumbent": incumbent_id,
               "successor": h["server_id"],
               "model_generation": h.get("model_generation"),
               "warm_s": round(warm_s, 3), "handoff": res,
               "takeover_gap_ms":
                   round((time.monotonic() - t1) * 1e3, 1)}
        if spawn_fn is None:
            out["successor_log"] = ready_file + ".log"
        return out
    finally:
        incumbent.close()


# --------------------------------------------------- rolling restart (N)

def run_rolling_restart(
        endpoints, model: str = "", extra=(),
        spawn_fn: Optional[Callable] = None,
        wait_s: float = 180.0, poll_s: float = 0.05,
        gate: Optional[HealthGate] = None,
        gate_wait_s: float = 10.0) -> dict:
    """Health-gated rolling restart: replace every replica in
    ``endpoints`` (``"h1:p1,h2:p2"`` or pairs), one at a time, each
    behind a fleet-wide ``#health`` gate. ``spawn_fn(i, host, port,
    ready_file)`` overrides the subprocess successor for in-process
    tests.

    Returns ``{"ok": True, "replicas": [per-replica reports]}`` on a
    complete rollout, or ``{"ok": False, "aborted_at": i, "endpoint":
    "h:p", "reason": ..., "completed": [...]}`` — with replica *i*'s
    incumbent still serving — on the first regression."""
    eps = parse_endpoints(endpoints)
    gate = gate if gate is not None else HealthGate()
    completed: List[dict] = []

    def abort(i: int, reason: str) -> dict:
        host, port = eps[i]
        log.warning("rolling restart ABORTED at replica %d (%s:%d): %s",
                    i, host, port, reason)
        return {"ok": False, "aborted_at": i,
                "endpoint": f"{host}:{port}", "reason": reason,
                "completed": completed}

    for i, (host, port) in enumerate(eps):
        # pre-handoff gate: the WHOLE fleet must be healthy before this
        # replica gives up its port — a rollout never compounds an
        # outage already in progress (settled: the previous handoff's
        # transient blip must not masquerade as one)
        reason = gate.check_settled(eps, wait_s=gate_wait_s)
        if reason is not None:
            return abort(i, f"pre-handoff health gate: {reason}")
        # chaos point: an injected err here models a botched rotation
        # (scheduler bug, mis-addressed handoff) — the rollout must stop
        # with the incumbent serving, and the fire is counted in
        # faults_fired_total{point="fleet.handoff"}
        try:
            faultinject.act_default(faultinject.fire("fleet.handoff"))
        except faultinject.FaultInjected as e:
            return abort(i, f"injected fleet.handoff fault: {e}")
        try:
            incumbent = EndpointRpc(host, port)
        except OSError as e:
            return abort(i, f"cannot reach incumbent: {e}")
        try:
            h0 = incumbent.call("#health")
            if not h0.get("takeover"):
                return abort(i, "incumbent not running serve_takeover=1")
            incumbent_id = h0["server_id"]
            fd, ready_file = tempfile.mkstemp(suffix=".ready")
            os.close(fd)
            os.unlink(ready_file)
            proc = (spawn_fn(i, host, port, ready_file)
                    if spawn_fn is not None
                    else spawn_successor(model, port, ready_file, extra,
                                         host=host))
            try:
                warm_s = _wait_ready_file(ready_file, proc, wait_s,
                                          poll_s)
            except (RuntimeError, TimeoutError) as e:
                # the successor never made it: nothing was handed off,
                # the incumbent is still serving — stop the rollout and
                # reap the half-up successor
                if proc is not None and hasattr(proc, "terminate"):
                    try:
                        proc.terminate()
                    except OSError:  # pragma: no cover
                        pass
                return abort(i, f"successor ready-file: {e}")
            res = incumbent.call(f"#handoff {ready_file}")
            try:
                h = _wait_takeover(host, port, incumbent_id, wait_s,
                                   poll_s)
                _wait_departed(incumbent, wait_s)
            except TimeoutError as e:
                return abort(i, str(e))
        except (OSError, ConnectionError, ValueError) as e:
            return abort(i, f"handoff failed: {e}")
        finally:
            incumbent.close()
        report = {"endpoint": f"{host}:{port}",
                  "incumbent": incumbent_id,
                  "successor": h["server_id"],
                  "model_generation": h.get("model_generation"),
                  "warm_s": round(warm_s, 3), "handoff": res}
        if spawn_fn is None:
            report["successor_log"] = ready_file + ".log"
        completed.append(report)
        # post-handoff gate: the successor (and the rest of the fleet)
        # must be healthy before the next incumbent gives up its port
        reason = gate.check_settled(eps, wait_s=gate_wait_s)
        if reason is not None:
            return abort(min(i + 1, len(eps) - 1),
                         f"post-handoff health gate after "
                         f"{host}:{port}: {reason}")
        log.info("rolling restart: replica %d/%d (%s:%d) -> %s "
                 "(warm %.1fs)", i + 1, len(eps), host, port,
                 h["server_id"], warm_s)
    return {"ok": True, "replicas": completed}


# --------------------------------------------------- router group roll

def spawn_router(endpoints: str, port: int, ready_file: str, extra=(),
                 host: str = "127.0.0.1") -> "subprocess.Popen":
    """Default router successor: ``python -m
    difacto_tpu_torch.tools.fleet route --takeover`` on the shared group
    port, ready-file signaled, log next to the ready file (same
    detachment rules as :func:`spawn_successor`)."""
    args = [sys.executable, "-m", "difacto_tpu_torch.tools.fleet",
            "route", "--host", host, "--port", str(port),
            "--endpoints", endpoints, "--takeover",
            "--ready-file", ready_file, *extra]
    logf = open(ready_file + ".log", "ab")
    try:
        return subprocess.Popen(args, cwd=REPO, stdin=subprocess.DEVNULL,
                                stdout=logf, stderr=logf,
                                start_new_session=True)
    finally:
        logf.close()   # the child holds its own descriptor


def _dial_member(host: str, port: int, want: Optional[str] = None,
                 avoid=(), max_dials: int = 32,
                 timeout: float = 5.0):
    """Hold a connection to a SPECIFIC member of a SO_REUSEPORT router
    group. Fresh connections hash over the group, so redial until the
    connection we HOLD answers ``#health`` with the ``server_id`` we
    mean (``want``), or with any id not in ``avoid`` (``want=None``).
    Returns ``(rpc, health)`` — the caller owns the rpc — or
    ``(None, None)`` after ``max_dials``."""
    for _ in range(max_dials):
        try:
            rpc = EndpointRpc(host, port, timeout=timeout)
        except OSError:
            time.sleep(0.05)
            continue
        try:
            h = rpc.call("#health")
        except (OSError, ConnectionError, ValueError):
            rpc.close()
            time.sleep(0.05)
            continue
        sid = h.get("server_id")
        if sid == want or (want is None and sid not in avoid):
            return rpc, h
        rpc.close()
    return None, None


def _discover_group(host: str, port: int, group_size: int,
                    max_dials: int, timeout: float = 5.0) -> Dict[str, dict]:
    """Enumerate a router group's members by server_id: dial the shared
    port until ``group_size`` distinct ids answered (or the dial budget
    ran out — the caller decides whether a partial census aborts)."""
    seen: Dict[str, dict] = {}
    for _ in range(max_dials):
        if len(seen) >= group_size:
            break
        try:
            h = fresh_health(host, port, timeout=timeout)
        except (OSError, ConnectionError, ValueError):
            time.sleep(0.05)
            continue
        sid = h.get("server_id")
        if sid:
            seen[str(sid)] = h
    return seen


def run_router_group_roll(
        host: str, port: int, group_size: int,
        spawn_fn: Optional[Callable] = None, endpoints: str = "",
        extra=(), wait_s: float = 180.0, poll_s: float = 0.05,
        max_dials: int = 64) -> dict:
    """Roll every member of an N-router SO_REUSEPORT group, one at a
    time, with zero client-visible errors — the routing-tier analog of
    :func:`run_rolling_restart`, reusing its ready-file/handoff
    sequencing with one twist: group members share ONE port, so each
    step (a) spawns the successor and waits for its ready file, (b)
    learns the successor's server_id (the first NEW id fresh dials
    reach), (c) redials until it holds a connection to the incumbent it
    means and sends ``#handoff <ready_file>`` there (the router refuses
    a handoff naming its own ready file, so a misrouted dial is caught
    even if the census raced), then (d) polls fresh connections until
    the incumbent has left the group. ``spawn_fn(i, host, port,
    ready_file)`` overrides the subprocess successor for in-process
    tests; the default spawns ``python -m difacto_tpu_torch.tools.fleet
    route`` with ``endpoints``/``extra``."""
    census = _discover_group(host, port, group_size, max_dials)
    if len(census) < group_size:
        return {"ok": False, "aborted_at": 0,
                "reason": (f"discovered {len(census)} of {group_size} "
                           "group members"), "completed": []}
    completed: List[dict] = []
    known = set(census)

    def abort(i: int, sid: str, reason: str) -> dict:
        log.warning("router group roll ABORTED at member %d (%s): %s",
                    i, sid, reason)
        return {"ok": False, "aborted_at": i, "incumbent": sid,
                "reason": reason, "completed": completed}

    for i, sid in enumerate(list(census)):
        fd, ready_file = tempfile.mkstemp(suffix=".ready")
        os.close(fd)
        os.unlink(ready_file)
        proc = (spawn_fn(i, host, port, ready_file)
                if spawn_fn is not None
                else spawn_router(endpoints, port, ready_file, extra,
                                  host=host))
        try:
            warm_s = _wait_ready_file(ready_file, proc, wait_s, poll_s)
        except (RuntimeError, TimeoutError) as e:
            if proc is not None and hasattr(proc, "terminate"):
                try:
                    proc.terminate()
                except OSError:  # pragma: no cover
                    pass
            return abort(i, sid, f"successor ready-file: {e}")
        succ_rpc, succ_h = _dial_member(host, port, avoid=known,
                                        max_dials=max_dials)
        if succ_rpc is None:
            return abort(i, sid,
                         "successor wrote its ready file but never "
                         "answered a fresh dial")
        succ_id = str(succ_h.get("server_id"))
        succ_rpc.close()
        known.add(succ_id)
        rpc, _h = _dial_member(host, port, want=sid,
                               max_dials=max_dials)
        if rpc is None:
            return abort(i, sid, "could not re-reach the incumbent "
                         "on the shared port")
        try:
            res = rpc.call(f"#handoff {ready_file}")
        except (OSError, ConnectionError, ValueError) as e:
            return abort(i, sid, f"handoff failed: {e}")
        finally:
            rpc.close()
        # (d) the incumbent leaves: fresh dials stop reaching its id
        # (probabilistic under kernel hashing, so count consecutive
        # non-sightings, bounded by the wait budget)
        t0 = time.monotonic()
        gone_after = 2 * group_size + 4
        gone = 0
        while gone < gone_after:
            if time.monotonic() - t0 > wait_s:
                return abort(i, sid,
                             "incumbent still answering fresh "
                             "connections after handoff")
            try:
                h = fresh_health(host, port)
            except (OSError, ConnectionError, ValueError):
                time.sleep(poll_s)
                continue
            if h.get("server_id") == sid \
                    and h.get("status") != "draining":
                gone = 0
                time.sleep(poll_s)
            else:
                gone += 1
        completed.append({"incumbent": sid, "successor": succ_id,
                          "warm_s": round(warm_s, 3), "handoff": res})
        log.info("router group roll: member %d/%d %s -> %s "
                 "(warm %.1fs)", i + 1, group_size, sid, succ_id,
                 warm_s)
    return {"ok": True, "routers": completed}
