"""Python client for the serving front-end (serve/server.py), with
transparent retry and multi-endpoint failover (counterpart of
difacto_tpu/serve/client.py; it speaks to either package's server).

Speaks the newline protocol: send data rows, read one response line per
row in order. ``predict`` returns probabilities (or raw margins when the
server runs pred_prob=false) as floats.

Resilience contract (the client half of the serve lifecycle):

- **connect/read failures retry** with capped exponential backoff + full
  jitter, up to ``retries`` reconnect attempts PER ENDPOINT and never
  past the per-call ``deadline_s``. Responses arrive in request order,
  so on a dropped connection the client knows exactly which rows were
  answered and resends only the tail (scoring is pure — a row scored
  twice server-side is harmless).
- **multi-endpoint failover**: construct with ``endpoints=`` (a list of
  ``(host, port)`` pairs or an ``"h1:p1,h2:p2"`` string —
  config.parse_endpoints) and a failure fails the unanswered tail over
  to the NEXT replica immediately, no backoff nap while a healthy
  replica is available. Per-endpoint health is tracked: ``eject_after``
  consecutive failures eject an endpoint for ``reprobe_s`` seconds
  (timed re-probe — the first use after the window IS the probe); when
  every endpoint is ejected the least-recently-ejected one is tried
  anyway (a client never deadlocks itself into "no replicas").
- **shared endpoint health**: pass ``blacklist=`` (a path or a
  fleethealth.FleetHealth handle) and ejections propagate fleet-wide —
  this client seeds its ejection windows from the shared file at
  construction (a blacklisted endpoint is skipped on the FIRST connect,
  no timeout paid) and on every failover, writes its own ejections
  down, and clears an entry early when its re-probe succeeds, so one
  discovery of a dead replica serves every client.
- ``!shed`` (queue full, or a draining replica) is **retryable**: the
  server explicitly asked for the row again later, so ``predict`` backs
  off and resends just the shed rows within the same budget.
- ``!err`` (malformed row, oversized row, executor error) is **not
  retryable**: the same bytes would fail the same way; it surfaces as
  None immediately.

``retries=0`` (default) keeps the old fail-fast behavior byte-for-byte
for a single endpoint; with N endpoints it means one try per replica.
"""

from __future__ import annotations

import json
import random
import socket
import time
from typing import List, Optional, Sequence, Union

from ..config import parse_endpoints

Line = Union[str, bytes]


def _to_bytes(line: Line) -> bytes:
    b = line.encode() if isinstance(line, str) else line
    return b if b.endswith(b"\n") else b + b"\n"


class _Endpoint:
    """Per-replica health: consecutive failures + ejection window, plus
    the per-endpoint tallies a rollout chaos run reads back (which
    replica absorbed the handoff traffic)."""

    __slots__ = ("host", "port", "fails", "down_until", "rows",
                 "ejections")

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)
        self.fails = 0
        self.down_until = 0.0
        self.rows = 0         # response lines answered by this endpoint
        self.ejections = 0    # times the ejection window opened


class ServeClient:
    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None, timeout: float = 60.0,
                 retries: int = 0, backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 deadline_s: Optional[float] = None,
                 endpoints=None, eject_after: int = 3,
                 reprobe_s: float = 5.0, blacklist=None):
        from .fleethealth import open_blacklist
        if endpoints is not None:
            eps = parse_endpoints(endpoints)
        elif host is not None and port is not None:
            eps = [(host, int(port))]
        else:
            raise ValueError("pass host+port or endpoints=[(h, p), ...]")
        self._eps = [_Endpoint(h, p) for h, p in eps]
        self._cur = 0
        self.eject_after = eject_after
        self.reprobe_s = reprobe_s
        self.blacklist = open_blacklist(blacklist, down_s=reprobe_s)
        self._bl_stamp = None
        # seed ejection windows from the fleet's shared discoveries and
        # start on a replica nobody has marked down — a blacklisted
        # endpoint is skipped on the FIRST connect, before any timeout
        self._refresh_blacklist()
        now = time.monotonic()
        for k, ep in enumerate(self._eps):
            if ep.down_until <= now:
                self._cur = k
                break
        self.failovers = 0           # times the active endpoint moved
        self.timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.deadline_s = deadline_s
        self._rng = random.Random(0x5E12E)
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        # constructor connect honors the same retry/failover budget: a
        # client racing a replica restart should wait for it, not crash
        self._ensure_conn(self._deadline(), {})

    # ------------------------------------------------------------- conn
    @property
    def host(self) -> str:
        """Host of the endpoint currently in use."""
        return self._eps[self._cur].host

    @property
    def port(self) -> int:
        return self._eps[self._cur].port

    def endpoints_health(self) -> List[dict]:
        """Per-endpoint view: rows answered, consecutive failures,
        ejection count/state — which replica absorbed the traffic, which
        got ejected."""
        now = time.monotonic()
        return [{"host": e.host, "port": e.port, "rows": e.rows,
                 "fails": e.fails, "ejections": e.ejections,
                 "ejected": e.down_until > now,
                 "active": i == self._cur}
                for i, e in enumerate(self._eps)]

    def _absorb_blacklist(self) -> None:
        """Fold fleet-wide down marks into the local ejection windows —
        another client's consecutive-failure discovery suppresses the
        endpoint here without this client ever dialing it."""
        if self.blacklist is None:
            return
        downs = self.blacklist.down_endpoints()
        if not downs:
            return
        now = time.monotonic()
        for ep in self._eps:
            rem = downs.get(f"{ep.host}:{ep.port}", 0.0)
            if rem > 0:
                ep.down_until = max(ep.down_until, now + rem)

    def _refresh_blacklist(self) -> None:
        """Absorb only when the shared file actually MOVED — one os.stat
        per endpoint selection, so a long-lived client also sees marks
        written after it connected: every reconnect path re-folds on a
        ``(mtime, size)`` change."""
        if self.blacklist is None:
            return
        stamp = self.blacklist.stamp()
        if stamp == self._bl_stamp:
            return
        # lint: ok(data-race) single-owner instance (see _failover)
        self._bl_stamp = stamp
        self._absorb_blacklist()

    def _deadline(self) -> Optional[float]:
        return (time.monotonic() + self.deadline_s
                if self.deadline_s is not None else None)

    def _backoff(self, attempt: int, deadline: Optional[float]) -> None:
        """Sleep exp(attempt) * jitter, capped; raises ConnectionError
        instead of sleeping past the deadline (fail before burning the
        caller's whole budget on a nap)."""
        delay = min(self.backoff_s * (2 ** attempt), self.backoff_max_s)
        delay *= 0.5 + self._rng.random()  # full jitter in [0.5, 1.5)
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ConnectionError(
                    f"deadline_s={self.deadline_s} exhausted retrying "
                    f"{self.host}:{self.port}")
            delay = min(delay, remaining)
        time.sleep(delay)

    def _note_success(self, rows: int = 0) -> None:
        ep = self._eps[self._cur]
        was_down = ep.down_until > 0.0
        ep.fails = 0
        ep.down_until = 0.0
        ep.rows += rows
        if was_down and self.blacklist is not None:
            # the re-probe succeeded: clear the entry fleet-wide early
            # instead of every client waiting out its own window
            self.blacklist.mark_up(ep.host, ep.port)

    def _failover(self, attempts: dict, deadline: Optional[float],
                  err: BaseException) -> None:
        """Record a failure on the active endpoint and pick the next one
        for this call. Ejects the endpoint after ``eject_after``
        consecutive failures (re-probed after ``reprobe_s``). Moving to
        a fresh replica is immediate; re-trying one already attempted
        this call backs off on ITS attempt count (per-endpoint backoff
        semantics). Re-raises ``err`` once every endpoint is out of
        budget."""
        i = self._cur
        ep = self._eps[i]
        ep.fails += 1
        if ep.fails >= self.eject_after:
            if ep.down_until <= time.monotonic():
                ep.ejections += 1
                if self.blacklist is not None:
                    # first discovery: every other client/router reading
                    # the shared file now skips this endpoint
                    self.blacklist.mark_down(ep.host, ep.port)
            ep.down_until = time.monotonic() + self.reprobe_s
        self._refresh_blacklist()  # learn the fleet's discoveries too
        attempts[i] = attempts.get(i, 0) + 1
        n = len(self._eps)
        order = [(i + k) % n for k in range(1, n + 1)]  # others first
        cands = [j for j in order if attempts.get(j, 0) <= self.retries]
        if not cands:
            raise err
        now = time.monotonic()
        healthy = [j for j in cands if self._eps[j].down_until <= now]
        j = healthy[0] if healthy else \
            min(cands, key=lambda k: self._eps[k].down_until)
        if j != i:
            # lint: ok(data-race) a ServeClient instance is owned by ONE
            # thread; the roots are distinct instances (counter likewise)
            self.failovers += 1
        self._cur = j  # lint: ok(data-race) single-owner instance
        a = attempts.get(j, 0)
        if a > 0:
            self._backoff(a - 1, deadline)

    def _drop_conn(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
            # lint: ok(data-race) single-owner instance (see _failover)
            self._rfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            # lint: ok(data-race) single-owner instance (see _failover)
            self._sock = None

    def _ensure_conn(self, deadline: Optional[float],
                     attempts: Optional[dict] = None) -> None:
        if self._sock is not None:
            return
        if attempts is None:
            attempts = {}
        # a mark that arrived since we last looked side-steps the
        # current endpoint WITHOUT burning a failure or a failover on
        # it — the fleet already paid that discovery, we just route
        # around it before dialing
        self._refresh_blacklist()
        now = time.monotonic()
        if self._eps[self._cur].down_until > now:
            n = len(self._eps)
            for j in ((self._cur + k) % n for k in range(1, n)):
                if self._eps[j].down_until <= now:
                    self._cur = j
                    break
        while True:
            ep = self._eps[self._cur]
            try:
                self._sock = socket.create_connection(
                    (ep.host, ep.port), timeout=self.timeout)
                try:
                    self._sock.setsockopt(socket.IPPROTO_TCP,
                                          socket.TCP_NODELAY, 1)
                except OSError:  # pragma: no cover
                    pass
                self._rfile = self._sock.makefile("rb")
                return
            except OSError as e:
                self._drop_conn()
                self._failover(attempts, deadline, e)

    # ------------------------------------------------------------- io
    def score_lines(self, lines: Sequence[Line]) -> List[bytes]:
        """Pipeline a batch of request rows; returns the raw response
        line per row (no trailing newline), in request order. For very
        large batches prefer several calls — the whole request block is
        written before responses are drained. Reconnects — to the next
        replica when more than one endpoint is configured — and resends
        the unanswered tail on connection failures (module docstring)."""
        pending = [_to_bytes(l) for l in lines]
        out: List[bytes] = []
        deadline = self._deadline()
        attempts: dict = {}
        while pending:
            answered = 0
            try:
                self._ensure_conn(deadline, attempts)
                self._sock.sendall(b"".join(pending))
                for _ in range(len(pending)):
                    resp = self._rfile.readline()
                    if not resp:
                        raise ConnectionError(
                            "server closed the connection")
                    out.append(resp.rstrip(b"\n"))
                    answered += 1
                self._note_success(answered)
                return out
            except (OSError, ConnectionError) as e:
                # in-order responses: rows already appended to ``out``
                # are answered for good (credited to the endpoint that
                # answered them); only the tail resends
                pending = pending[answered:]
                self._eps[self._cur].rows += answered
                self._drop_conn()
                self._failover(attempts, deadline, e)
        return out

    def predict(self, lines: Sequence[Line]) -> List[Optional[float]]:
        """Scores per row; None where the server rejected the row
        (``!err`` — not retryable) or kept shedding it past the retry
        budget (``!shed`` — retried with backoff when ``retries`` > 0;
        inspect score_lines for raw reasons)."""
        out: List[Optional[float]] = [None] * len(lines)
        todo = list(range(len(lines)))
        deadline = self._deadline()
        attempt = 0
        while todo:
            resp = self.score_lines([lines[i] for i in todo])
            shed = []
            for i, r in zip(todo, resp):
                if r.startswith(b"!shed"):
                    shed.append(i)
                elif not r.startswith(b"!err"):
                    out[i] = float(r)
            if not shed or attempt >= self.retries:
                break
            try:
                self._backoff(attempt, deadline)
            except ConnectionError:
                break   # deadline spent: exhausted sheds surface as None
            attempt += 1
            todo = shed
        return out

    def stats(self) -> dict:
        """The server's live serving + executor counters (#stats)."""
        return json.loads(self.score_lines([b"#stats"])[0])

    def health(self) -> dict:
        """Readiness + queue depth (#health) — what a load balancer
        polls to rotate a draining replica out before it exits."""
        return json.loads(self.score_lines([b"#health"])[0])

    def metrics(self) -> str:
        """Prometheus-format metric text (#metrics): the one multi-line
        control reply — the server terminates it with a single blank
        line (the exposition format never emits blank lines itself), so
        this reads until that sentinel instead of one line per request."""
        deadline = self._deadline()
        attempts: dict = {}
        while True:
            try:
                self._ensure_conn(deadline, attempts)
                self._sock.sendall(b"#metrics\n")
                lines = []
                while True:
                    resp = self._rfile.readline()
                    if not resp:
                        raise ConnectionError(
                            "server closed the connection")
                    if resp == b"\n":
                        self._note_success()
                        return b"".join(lines).decode()
                    if not lines and resp.startswith(b"!err"):
                        raise RuntimeError(resp.rstrip(b"\n").decode())
                    lines.append(resp)
            except (OSError, ConnectionError) as e:
                self._drop_conn()
                self._failover(attempts, deadline, e)

    def reload(self, path: Optional[str] = None) -> dict:
        """Trigger a synchronous model hot-reload (#reload [path]);
        returns the server's {'ok', 'model_generation'|'error'} verdict."""
        line = b"#reload" if path is None else b"#reload " + path.encode()
        return json.loads(self.score_lines([line])[0])

    def handoff(self, ready_file: str = "") -> dict:
        """Ask THIS connection's replica to hand its port off
        (#handoff): it waits for ``ready_file`` (the successor's
        serve_ready_file), then drains. Hold the connection open from
        before the successor binds so the request provably reaches the
        incumbent (serve/fleet.py run_takeover)."""
        line = b"#handoff" + (b" " + ready_file.encode()
                              if ready_file else b"")
        return json.loads(self.score_lines([line])[0])

    def close(self) -> None:
        self._drop_conn()

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
