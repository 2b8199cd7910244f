"""Elastic capacity: a control loop that sizes the replica fleet
(counterpart of difacto_tpu/serve/autoscale.py: the same signals,
decisions, fault point and metric names).

Signals, per poll (EWMA-smoothed so one deep queue sample cannot flap
the fleet):

- **queue_frac** — summed admission queue depth over summed capacity
  across reachable replicas (``#health``): the leading indicator, rises
  before shed does;
- **shed_rate** — the worst replica's shed rate (``#health``);
- **p99_ms** — optional, from ``latency_fn`` (the caller's client-side
  view, e.g. the load generator's window p99).

Decisions, with hysteresis and bounds:

- ``up_ticks`` consecutive polls with ANY signal past its ``up_*``
  threshold (or a replica unreachable) -> **scale up** (bounded by
  ``max_replicas``): fire the ``autoscale.spawn`` fault point, call
  ``spawn_fn(index)`` for a fresh READY endpoint, publish it
  (``endpoints_file`` rewrite + ``#backends add`` nudge to every router
  group member);
- ``down_ticks`` consecutive polls with EVERY signal under its
  ``down_*`` threshold -> **scale down** (bounded by ``min_replicas``):
  un-publish the newest replica first (ring nudge + endpoints_file),
  THEN drain it with a bare ``#handoff`` — the ring stops routing to it
  before it stops serving, so the drain sheds nothing;
- every action opens a ``cooldown_s`` window in which no further action
  fires.

``autoscale_{spawns,drains,aborts}_total`` counters and
``autoscale_{replicas,queue_frac,shed_rate,p99_ms}`` gauges go on the
process-global registry, so a router's ``#metrics`` in the same process
shows them. ``python -m difacto_tpu_torch.tools.fleet scale`` is the
CLI.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

from ..config import parse_endpoints
from ..utils import faultinject
from ..utils.locktrace import mutex
from .fleet import drain_endpoint, fresh_health, notify_backends

log = logging.getLogger("difacto_tpu_torch")


class Autoscaler:
    """One control loop instance. ``endpoints`` is the starting fleet;
    ``spawn_fn(index) -> (host, port)`` must return a replica that is
    already serving (ready-file waited) — the loop publishes it.
    ``router=(host, port)`` names the router group's shared port for
    ``#backends`` nudges (None = endpoints_file only)."""

    def __init__(self, endpoints, spawn_fn: Callable[[int], Tuple[str, int]],
                 router: Optional[Tuple[str, int]] = None,
                 min_replicas: int = 1, max_replicas: int = 8,
                 poll_s: float = 0.5, ewma: float = 0.4,
                 up_queue_frac: float = 0.6, up_shed_rate: float = 0.02,
                 up_p99_ms: Optional[float] = None,
                 down_queue_frac: float = 0.1,
                 down_shed_rate: float = 0.0,
                 up_ticks: int = 2, down_ticks: int = 6,
                 cooldown_s: float = 5.0,
                 latency_fn: Optional[Callable[[], float]] = None,
                 endpoints_file: str = "", timeout: float = 5.0,
                 obs=None):
        from ..obs import REGISTRY
        self._eps: List[Tuple[str, int]] = list(parse_endpoints(endpoints))
        self.spawn_fn = spawn_fn
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.poll_s = poll_s
        self.ewma = ewma
        self.up_queue_frac = up_queue_frac
        self.up_shed_rate = up_shed_rate
        self.up_p99_ms = up_p99_ms
        self.down_queue_frac = down_queue_frac
        self.down_shed_rate = down_shed_rate
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.cooldown_s = cooldown_s
        self.latency_fn = latency_fn
        self.endpoints_file = endpoints_file
        self.timeout = timeout
        reg = obs if obs is not None else REGISTRY
        self._spawn_c = reg.counter(
            "autoscale_spawns_total",
            "replicas spawned into the ring by the autoscaler")
        self._drain_c = reg.counter(
            "autoscale_drains_total",
            "replicas drained out of the ring by the autoscaler")
        self._abort_c = reg.counter(
            "autoscale_aborts_total",
            "scale-ups refused (injected autoscale.spawn fault or "
            "spawn_fn failure)")
        self._replicas_g = reg.gauge(
            "autoscale_replicas", "current published fleet size")
        self._qf_g = reg.gauge(
            "autoscale_queue_frac",
            "EWMA fleet admission-queue fill fraction")
        self._shed_g = reg.gauge(
            "autoscale_shed_rate", "EWMA worst-replica shed rate")
        self._p99_g = reg.gauge(
            "autoscale_p99_ms", "EWMA client-side p99 (latency_fn)")
        self._mu = mutex()
        self._qf = self._shed = self._p99 = 0.0
        self._primed = False
        self._up_streak = self._down_streak = 0
        self._cool_until = 0.0
        self.events: List[dict] = []   # (t, action, endpoint, replicas)
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._replicas_g.set(len(self._eps))
        self._write_endpoints_file()

    # ------------------------------------------------------------ state
    def endpoints(self) -> List[Tuple[str, int]]:
        with self._mu:
            return list(self._eps)

    def _write_endpoints_file(self) -> None:
        """Durable membership: rewrite atomically so a router's
        ``(mtime, size)`` re-fold never reads a half-written ring."""
        if not self.endpoints_file:
            return
        with self._mu:
            body = "".join(f"{h}:{p}\n" for h, p in self._eps)
        tmp = self.endpoints_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, self.endpoints_file)

    def _notify(self, op: str, host: str, port: int) -> None:
        if self.router is None:
            return
        rh, rp = self.router
        try:
            notify_backends(rh, rp, op, f"{host}:{port}",
                            timeout=self.timeout)
        except (OSError, ConnectionError, ValueError) as e:
            log.warning("autoscale: router nudge %s %s:%d failed (%s); "
                        "endpoints_file re-fold will catch up",
                        op, host, port, e)

    # ------------------------------------------------------------- poll
    def poll(self) -> dict:
        """One measurement: fold every reachable replica's ``#health``
        into the EWMA signals (an unreachable replica contributes
        nothing — ejection is the router's job, not the scaler's)."""
        depth = cap = 0
        shed = 0.0
        reachable = 0
        for host, port in self.endpoints():
            try:
                h = fresh_health(host, port, timeout=self.timeout)
            except (OSError, ConnectionError, ValueError):
                continue
            reachable += 1
            depth += int(h.get("queue_depth", 0))
            cap += int(h.get("queue_cap", 0))
            shed = max(shed, float(h.get("shed_rate", 0.0)))
        qf = depth / cap if cap else 0.0
        p99 = float(self.latency_fn()) if self.latency_fn else 0.0
        a = self.ewma
        with self._mu:
            if not self._primed:
                self._qf, self._shed, self._p99 = qf, shed, p99
                self._primed = True
            else:
                self._qf += a * (qf - self._qf)
                self._shed += a * (shed - self._shed)
                self._p99 += a * (p99 - self._p99)
            out = {"replicas": len(self._eps), "reachable": reachable,
                   "queue_frac": self._qf, "shed_rate": self._shed,
                   "p99_ms": self._p99}
        self._qf_g.set(out["queue_frac"])
        self._shed_g.set(out["shed_rate"])
        self._p99_g.set(out["p99_ms"])
        return out

    # --------------------------------------------------------- decision
    def _overloaded(self, m: dict) -> bool:
        if m["reachable"] < len(self.endpoints()):
            # a hole in the fleet IS missing capacity
            return True
        return (m["queue_frac"] > self.up_queue_frac
                or m["shed_rate"] > self.up_shed_rate
                or (self.up_p99_ms is not None and self.latency_fn
                    and m["p99_ms"] > self.up_p99_ms))

    def _idle(self, m: dict) -> bool:
        return (m["reachable"] >= len(self.endpoints())
                and m["queue_frac"] < self.down_queue_frac
                and m["shed_rate"] <= self.down_shed_rate)

    def step(self) -> dict:
        """Poll, update streaks, maybe act. Returns the measurement plus
        ``action`` (``"up"``/``"down"``/None) and ``endpoint`` when an
        action fired."""
        m = self.poll()
        m["action"] = None
        now = time.monotonic()
        over, idle = self._overloaded(m), self._idle(m)
        with self._mu:
            self._up_streak = self._up_streak + 1 if over else 0
            self._down_streak = self._down_streak + 1 if idle else 0
            up_streak, down_streak = self._up_streak, self._down_streak
            cooling = now < self._cool_until
            n = len(self._eps)
        if cooling:
            return m
        if up_streak >= self.up_ticks and n < self.max_replicas:
            return self._scale_up(m)
        if down_streak >= self.down_ticks and n > self.min_replicas:
            return self._scale_down(m)
        return m

    def _scale_up(self, m: dict) -> dict:
        # chaos point: an injected err models the spawn path failing
        # (no binary, no ports, quota) — the decision is refused,
        # counted, and the loop keeps measuring; it does NOT crash
        try:
            faultinject.act_default(faultinject.fire("autoscale.spawn"))
        except faultinject.FaultInjected as e:
            self._abort_c.inc()
            log.warning("autoscale: scale-up refused: %s", e)
            m["action"] = "abort"
            return self._settle(m)
        with self._mu:
            idx = len(self._eps)
        try:
            host, port = self.spawn_fn(idx)
        except Exception as e:   # spawn_fn is caller code: stay serving
            self._abort_c.inc()
            log.warning("autoscale: spawn_fn failed: %s", e)
            m["action"] = "abort"
            return self._settle(m)
        with self._mu:
            self._eps.append((host, int(port)))
            n = len(self._eps)
        self._write_endpoints_file()
        self._notify("add", host, int(port))
        self._spawn_c.inc()
        self._replicas_g.set(n)
        log.info("autoscale: UP -> %d replicas (+%s:%d) "
                 "[queue_frac=%.3f shed=%.4f p99=%.1fms]",
                 n, host, port, m["queue_frac"], m["shed_rate"],
                 m["p99_ms"])
        m.update(action="up", endpoint=f"{host}:{port}", replicas=n)
        return self._settle(m)

    def _scale_down(self, m: dict) -> dict:
        with self._mu:
            host, port = self._eps.pop()   # newest first
            n = len(self._eps)
        self._write_endpoints_file()
        self._notify("remove", host, port)
        try:
            drain_endpoint(host, port, timeout=self.timeout)
        except (OSError, ConnectionError, ValueError) as e:
            log.warning("autoscale: drain of %s:%d failed (%s) — "
                        "already gone?", host, port, e)
        self._drain_c.inc()
        self._replicas_g.set(n)
        log.info("autoscale: DOWN -> %d replicas (-%s:%d) "
                 "[queue_frac=%.3f shed=%.4f]", n, host, port,
                 m["queue_frac"], m["shed_rate"])
        m.update(action="down", endpoint=f"{host}:{port}", replicas=n)
        return self._settle(m)

    def _settle(self, m: dict) -> dict:
        with self._mu:
            self._cool_until = time.monotonic() + self.cooldown_s
            self._up_streak = self._down_streak = 0
            self.events.append({"t": time.monotonic() - self._t0,
                                "action": m["action"],
                                "endpoint": m.get("endpoint"),
                                "replicas": m["replicas"]})
        return m

    # ------------------------------------------------------------- loop
    def run(self, duration_s: Optional[float] = None) -> dict:
        end = (time.monotonic() + duration_s
               if duration_s is not None else None)
        while not self._stop.is_set():
            self.step()
            if end is not None and time.monotonic() >= end:
                break
            self._stop.wait(self.poll_s)
        with self._mu:
            return {"replicas": len(self._eps),
                    "events": list(self.events)}

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self.run,
                                        name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
