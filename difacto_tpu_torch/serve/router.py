"""Thin routing tier: one address in front of a replica fleet
(counterpart of difacto_tpu/serve/router.py: the same knobs, wire
protocol, control lines, metric names and fault points).

Clients speak the replicas' own libsvm/control wire protocol to ONE
address, and the router

- **balances** rows across replicas with power-of-two-choices over live
  per-endpoint stats — two random live backends (``random.Random(
  0x20072)``, so the same stats and draw order pick the same backends as
  the JAX router), send to the one with the lower (in-flight,
  recent-latency-EWMA) score;
- **retries the unanswered tail on a peer** exactly like
  ``ServeClient._failover``: backend responses are in request order, so
  a dropped backend connection splits the chunk at the exact answered
  boundary and only the tail is resent — to a DIFFERENT replica,
  immediately. Per-forward retry budgets exhausted across every backend
  degrade to explicit ``!shed`` backpressure (retryable), never a hang;
- **absorbs drain windows**: a replica mid-rotation answers ``!shed
  draining`` over a healthy connection; the draining backend is
  side-stepped for ``drain_eject_s`` and the shed rows get ONE
  re-forward to a peer — a rolling restart behind the router costs
  clients neither errors nor sheds;
- **shares endpoint health**: ``eject_after`` consecutive failures
  eject a backend for ``reprobe_s`` (timed re-probe), written through
  the shared blacklist file (serve/fleethealth.py) so every other
  router and client skips the endpoint without dialing it;
- serves **aggregated control lines** for the whole fleet: ``#health``
  (fleet-wide status + per-replica payloads), ``#stats`` (router
  counters + per-backend balance state + summed replica counters),
  ``#metrics`` (Prometheus text of the router registry, per-endpoint
  labeled, merged with the process-global one).

Ordering contract: per client connection, responses come back in
request order — data rows are forwarded in arrival-order chunks (a
chunk closes at ``chunk`` rows, at a control line, or when the reader
has nothing more buffered), and control replies are emitted in line
with the rows around them.

``router.forward`` is a fault point in the forward path
(utils/faultinject.py): ``err``/``close`` model a backend failing
mid-chunk and must surface as a peer retry, not a client error.

Router groups: with ``takeover=True`` the listener binds
``SO_REUSEPORT``, so N router processes share ONE advertised port; every
member folds the same blacklist, and one member dying loses only the
connections it held. ``#handoff [ready_file]`` waits for the
successor's ready file, then ``drain()`` leaves the group (the listener
is shut down before it is closed, so the kernel stops hashing fresh
connections to it at once), finishes the chunk in flight on every held
connection and closes each at a line boundary. ``router.takeover`` is
the fault point on that path.

Balance policies: ``balance="p2c"`` (default) or ``balance="affinity"``
— rows pinned by their leading feature key to one replica, mirroring the
store's hashed-slot and contiguous-range arithmetic when
``affinity_capacity`` is set, a splitmix64 ring otherwise. An owner that
is ejected or draining falls back to p2c (every replica serves the full
model, so the answers do not change).

Elastic membership: ``#backends [add|remove host:port]`` adjusts the
ring at runtime (the autoscaler's nudge), and an ``endpoints_file``
re-folds on ``(mtime, size)`` change.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import random
import socket
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..config import parse_endpoints
from ..utils import faultinject
from ..utils.locktrace import mutex
from .fleethealth import open_blacklist

log = logging.getLogger("difacto_tpu_torch")


class _Backend:
    """Shared balance/health state for one replica endpoint (the
    connections themselves are per client handler — two client
    connections never interleave on one backend socket)."""

    __slots__ = ("host", "port", "in_flight", "ewma_ms", "fails",
                 "down_until", "rows", "ejections", "removed")

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)
        self.in_flight = 0
        self.ewma_ms = 0.0      # recent per-row latency, milliseconds
        self.fails = 0          # consecutive failures
        self.down_until = 0.0   # monotonic ejection deadline
        self.rows = 0           # rows answered by this backend
        self.ejections = 0
        self.removed = False    # tombstone (indices stay stable)

    @property
    def key(self) -> str:
        return f"{self.host}:{self.port}"


class RouterServer:
    def __init__(self, endpoints, host: str = "127.0.0.1", port: int = 0,
                 chunk: int = 64, retries: int = 2, eject_after: int = 3,
                 reprobe_s: float = 5.0, blacklist=None,
                 timeout: float = 30.0, probe_timeout: float = 2.0,
                 drain_eject_s: float = 1.0, takeover: bool = False,
                 ready_file: str = "", handoff_wait_s: float = 30.0,
                 balance: str = "p2c", affinity_capacity: int = 0,
                 endpoints_file: str = ""):
        from ..obs import Registry
        if balance not in ("p2c", "affinity"):
            raise ValueError(f"unknown balance policy {balance!r} "
                             "(want p2c or affinity)")
        self._backends = ([_Backend(h, p)
                           for h, p in parse_endpoints(endpoints)]
                          if endpoints else [])
        self.chunk = chunk
        self.retries = retries
        self.eject_after = eject_after
        self.reprobe_s = reprobe_s
        self.timeout = timeout
        self.probe_timeout = probe_timeout
        self.drain_eject_s = drain_eject_s
        self.takeover = bool(takeover)
        self.ready_file = ready_file
        self.handoff_wait_s = handoff_wait_s
        self.balance = balance
        self.affinity_capacity = int(affinity_capacity)
        self.endpoints_file = endpoints_file
        self.blacklist = open_blacklist(blacklist, down_s=reprobe_s)
        self._rng = random.Random(0x20072)
        self.obs = Registry(enabled=True)
        self._rows_c = self.obs.counter(
            "router_rows_forwarded_total",
            "rows answered through the router, per backend endpoint")
        self._retry_c = self.obs.counter(
            "router_retries_total",
            "chunk tails retried on a peer after a backend failure")
        self._shed_c = self.obs.counter(
            "router_shed_total",
            "rows answered !shed because no backend was available")
        self._err_c = self.obs.counter(
            "router_errors_total", "rows rejected at the router")
        self._aff_hit_c = self.obs.counter(
            "router_affinity_hits_total",
            "affinity forwards that landed on the ring owner")
        self._aff_miss_c = self.obs.counter(
            "router_affinity_misses_total",
            "affinity forwards diverted off the owner (ejected/draining)")
        self._mu = mutex()               # backend stats + membership
        self._eps_stamp: Optional[tuple] = None
        self._eps_next_poll = 0.0
        # SO_REUSEPORT group bind: N routers share this port; fresh
        # connections hash across whichever members still listen
        self._sock = socket.create_server((host, port),
                                          reuse_port=takeover)
        self._sock.settimeout(0.25)
        self.host, self.port = self._sock.getsockname()[:2]
        self._alive = False
        self._closed = False
        self._draining = False
        self.successor_ready = False
        self._successor_file: Optional[str] = None
        self._handoff_thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conn_threads: list = []
        self._cmu = mutex()              # connection + handoff state
        self._refresh_endpoints(force=True)
        if not self._backends:
            raise ValueError(
                "router needs endpoints (inline or endpoints_file)")

    # ---------------------------------------------------------- control
    def start(self) -> "RouterServer":
        # lint: ok(data-race) monotonic stop flag; accept loop re-checks
        self._alive = True
        # lint: ok(data-race) written once in start(); drain() only runs
        # after start() returned (callers hold the instance)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="router-accept", daemon=True)
        self._accept_thread.start()
        log.info("routing %s:%d -> %s", self.host, self.port,
                 ",".join(b.key for b in self._backends))
        return self

    def wait(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)

    def drain(self) -> None:
        """Leave the SO_REUSEPORT group gracefully: shut the listener
        down (the kernel shifts fresh connections onto the surviving
        members at once), finish the chunk in flight on every held connection,
        and close each at a line boundary — the failover client sees a
        clean EOF and resends its unanswered tail on a reconnect that
        lands on a group peer."""
        with self._cmu:
            if self._draining or self._closed:
                return
            self._draining = True
        self._alive = False
        self._stop_listening()
        t = self._accept_thread
        if t is not None:
            t.join()
            self._accept_thread = None
        with self._cmu:
            threads = list(self._conn_threads)
        for t in threads:
            t.join()
        self.close()

    def close(self) -> None:
        with self._cmu:
            if self._closed:
                return
            self._closed = True
        self._alive = False
        self._done.set()
        self._stop_listening()
        if self._accept_thread is not None:
            self._accept_thread.join()
            self._accept_thread = None
        with self._cmu:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        # snapshot under _cmu: the accept loop appends under the same
        # lock until its join above
        with self._cmu:
            threads = list(self._conn_threads)
            self._conn_threads = []
        for t in threads:
            t.join()

    def _stop_listening(self) -> None:
        """Leave the port now. A close alone keeps the listener in the
        kernel's SO_REUSEPORT group until the accept thread's 0.25 s poll
        returns, and a fresh connection hashed to it in that window is
        reset; the shutdown unhashes it at once, so fresh connections
        reach only the surviving group members."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass

    # ------------------------------------------------------- accept loop
    def _accept_loop(self) -> None:
        while self._alive:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(None)
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:  # pragma: no cover
                pass
            with self._cmu:
                self._conns.add(conn)
                self._conn_threads = [t for t in self._conn_threads
                                      if t.is_alive()]
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name="router-conn", daemon=True)
            t.start()
            with self._cmu:
                self._conn_threads.append(t)

    # ---------------------------------------------------- client handler
    def _handle(self, conn: socket.socket) -> None:
        """Order-preserving per-connection loop: a reader thread feeds a
        queue; this thread folds consecutive data rows into chunks,
        forwards them, and interleaves control replies in arrival
        order."""
        q: "queue.Queue" = queue.Queue()

        def reader() -> None:
            try:
                rfile = conn.makefile("rb")
                for line in rfile:
                    line = line.strip()
                    if line:
                        q.put(line)
            except (OSError, ValueError):
                pass
            finally:
                q.put(None)

        rt = threading.Thread(target=reader, name="router-conn-reader",
                              daemon=True)
        rt.start()
        pool: Dict[int, Tuple[socket.socket, object]] = {}
        forward = (self._forward_affinity if self.balance == "affinity"
                   else self._forward)
        try:
            eof = False
            while not eof:
                try:
                    item = q.get(timeout=0.25)
                except queue.Empty:
                    # idle moment: a draining router leaves here — the
                    # connection closes at a line boundary, nothing owed
                    if self._drain_pending():
                        break
                    continue
                if item is None:
                    break
                if item.startswith(b"#"):
                    conn.sendall(self._control(item))
                    continue
                # fold the contiguous data-row run the reader has already
                # buffered (bounded by chunk) into one backend forward
                rows = [item]
                carry = None
                while len(rows) < self.chunk:
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        eof = True
                        break
                    if nxt.startswith(b"#"):
                        carry = nxt
                        break
                    rows.append(nxt)
                conn.sendall(b"".join(forward(rows, pool)))
                if carry is not None:
                    conn.sendall(self._control(carry))
                if self._drain_pending():
                    # the chunk in flight was answered; a pipelining
                    # client never pins a draining router past one chunk
                    break
        except OSError:   # client went away mid-reply
            pass
        finally:
            for s, rf in pool.values():
                try:
                    rf.close()
                    s.close()
                except OSError:
                    pass
            try:
                # shutdown (not just close) so the blocked reader thread
                # wakes with EOF when WE end the connection (drain path)
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            with self._cmu:
                self._conns.discard(conn)
            rt.join()

    def _drain_pending(self) -> bool:
        with self._cmu:
            return self._draining or self._closed

    # -------------------------------------------------------- balancing
    def _refresh_blacklist(self) -> None:
        """Fold fleet-wide down marks into the local ejection windows, so
        an ejection ANY client recorded suppresses the backend here too."""
        if self.blacklist is None:
            return
        downs = self.blacklist.down_endpoints()
        if not downs:
            return
        now = time.monotonic()
        with self._mu:
            for b in self._backends:
                rem = downs.get(b.key, 0.0)
                if rem > 0:
                    b.down_until = max(b.down_until, now + rem)

    # ------------------------------------------------------- membership
    def _live_backends(self) -> List[_Backend]:
        with self._mu:
            return [b for b in self._backends if not b.removed]

    def _add_backend(self, host: str, port: int) -> None:
        """Join (or un-tombstone) an endpoint. The backend list is
        append-only — indices held by in-flight forwards stay valid."""
        key = f"{host}:{int(port)}"
        with self._mu:
            for b in self._backends:
                if b.key == key:
                    b.removed = False
                    return
            self._backends.append(_Backend(host, port))
        log.info("router: backend %s joined the ring", key)

    def _remove_backend(self, host: str, port: int) -> None:
        key = f"{host}:{int(port)}"
        with self._mu:
            for b in self._backends:
                if b.key == key and not b.removed:
                    b.removed = True
                    log.info("router: backend %s left the ring", key)

    def _refresh_endpoints(self, force: bool = False) -> None:
        """Durable group membership: when an ``endpoints_file`` is
        configured, a ``(mtime, size)`` change re-folds the file into
        the backend ring (one ``host:port`` per whitespace-separated
        token) — a relaunched router recovers autoscaler decisions it
        never saw as ``#backends`` nudges. One os.stat per check,
        throttled to ~2/s off the hot path."""
        if not self.endpoints_file:
            return
        now = time.monotonic()
        with self._mu:
            if not force and now < self._eps_next_poll:
                return
            self._eps_next_poll = now + 0.5
        try:
            st = os.stat(self.endpoints_file)
        except OSError:
            return
        stamp = (st.st_mtime, st.st_size)
        with self._mu:
            if stamp == self._eps_stamp:
                return
            self._eps_stamp = stamp
        try:
            with open(self.endpoints_file) as f:
                toks = [t for t in f.read().split() if t]
            eps = parse_endpoints(",".join(toks)) if toks else []
        except (OSError, ValueError) as e:
            log.warning("router: unreadable endpoints file %s (%s)",
                        self.endpoints_file, e)
            return
        want = {f"{h}:{int(p)}" for h, p in eps}
        for h, p in eps:
            self._add_backend(h, p)
        with self._mu:
            stale = [b for b in self._backends
                     if b.key not in want and not b.removed]
            for b in stale:
                b.removed = True

    def _pick(self, attempts: Dict[int, int],
              prefer: Optional[int] = None) -> Optional[int]:
        """Power-of-two-choices over live backends still inside this
        forward's retry budget; all-ejected falls back to the least-
        recently-ejected (the router never deadlocks itself into "no
        replicas" while one might answer). None = budget exhausted.
        ``prefer`` (affinity owner) wins while it is live and untried —
        after its first failure the pick degrades to plain p2c."""
        self._refresh_endpoints()
        self._refresh_blacklist()
        now = time.monotonic()
        with self._mu:
            cands = [i for i in range(len(self._backends))
                     if not self._backends[i].removed
                     and attempts.get(i, 0) <= self.retries]
            if not cands:
                return None
            live = [i for i in cands
                    if self._backends[i].down_until <= now]
            if prefer is not None and prefer in live \
                    and attempts.get(prefer, 0) == 0:
                return prefer
            if not live:
                return min(cands,
                           key=lambda i: self._backends[i].down_until)
            if len(live) == 1:
                return live[0]
            a, b = self._rng.sample(live, 2)
            ba, bb = self._backends[a], self._backends[b]
            return a if (ba.in_flight, ba.ewma_ms) <= \
                (bb.in_flight, bb.ewma_ms) else b

    def _conn(self, pool: dict, i: int):
        got = pool.get(i)
        if got is not None:
            return got
        b = self._backends[i]
        s = socket.create_connection((b.host, b.port),
                                     timeout=self.timeout)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover
            pass
        pool[i] = (s, s.makefile("rb"))
        return pool[i]

    def _drop(self, pool: dict, i: int) -> None:
        got = pool.pop(i, None)
        if got is not None:
            try:
                got[1].close()
                got[0].close()
            except OSError:
                pass

    def _note_success(self, i: int, rows: int, dt_s: float) -> None:
        b = self._backends[i]
        with self._mu:
            was_down = b.down_until > 0.0 or b.fails >= self.eject_after
            b.fails = 0
            b.down_until = 0.0
            b.rows += rows
            per_row_ms = dt_s * 1e3 / max(rows, 1)
            b.ewma_ms = (per_row_ms if b.ewma_ms == 0.0
                         else 0.8 * b.ewma_ms + 0.2 * per_row_ms)
        self._rows_c.labels(endpoint=b.key).inc(rows)
        if was_down and self.blacklist is not None:
            self.blacklist.mark_up(b.host, b.port)

    def _note_failure(self, i: int, attempts: Dict[int, int],
                      err: BaseException) -> None:
        b = self._backends[i]
        attempts[i] = attempts.get(i, 0) + 1
        self._retry_c.inc()
        ejected = False
        with self._mu:
            b.fails += 1
            if b.fails >= self.eject_after:
                b.down_until = time.monotonic() + self.reprobe_s
                b.ejections += 1
                ejected = True
        if ejected:
            log.warning("router: ejecting backend %s for %.1fs (%s)",
                        b.key, self.reprobe_s, err)
            if self.blacklist is not None:
                self.blacklist.mark_down(b.host, b.port)

    def _note_draining(self, i: int) -> None:
        """The backend said ``!shed draining``: it is mid-rotation, not
        dead — side-step it briefly (no blacklist write, no ejection
        count; its successor inherits the endpoint within seconds)."""
        b = self._backends[i]
        with self._mu:
            b.down_until = max(b.down_until,
                               time.monotonic() + self.drain_eject_s)

    def _retry_shed(self, rows: List[bytes], out: List[bytes],
                    pool: dict) -> List[bytes]:
        """One re-forward of the rows a backend shed: under a rolling
        restart the shed came from a draining replica (now side-stepped
        by _note_draining), so the peer pass usually converts the whole
        drain window into ordinary answers. Positions are exact — one
        response line per row — so the splice preserves ordering."""
        idx = [k for k, line in enumerate(out)
               if line.startswith(b"!shed")]
        if not idx:
            return out
        sub = self._forward([rows[k] for k in idx], pool,
                            _retry_shed=False)
        for k, line in zip(idx, sub):
            out[k] = line
        return out

    # --------------------------------------------------------- affinity
    def _affinity_key(self, row: bytes) -> int:
        """Consistent-hash key of a libsvm row (``label idx:val ...``):
        its leading feature index. Per-key/per-user request streams put
        the identifying feature first, so the whole stream pins to one
        replica's warm cache and fs-shard."""
        parts = row.split(None, 2)
        if len(parts) < 2:
            return 0
        tok = parts[1].split(b":", 1)[0]
        try:
            return int(tok)
        except ValueError:
            return zlib.crc32(tok)

    def _affinity_owner(self, row: bytes, ring: List[int]) -> int:
        """Backend index that owns the row's key. With
        ``affinity_capacity`` set this mirrors the store's hashed-slot
        plus contiguous-range arithmetic (store/local.py ``hash_slots``,
        parallel/mesh.py ``fs_shard_bounds``): slot = key %% (cap-1) + 1
        and shard i owns slots [i*cap/n, (i+1)*cap/n) — the row lands on
        the replica whose fs-shard holds its leading key. capacity=0
        hashes the key straight onto the ring (splitmix64 finalizer, so
        adjacent integer keys spread)."""
        n = len(ring)
        key = self._affinity_key(row)
        cap = self.affinity_capacity
        if cap > 1:
            slot = key % (cap - 1) + 1
            return ring[min(slot * n // cap, n - 1)]
        z = (key + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return ring[(z ^ (z >> 31)) % n]

    def _forward_affinity(self, rows: List[bytes],
                          pool: dict) -> List[bytes]:
        """Partition the chunk by ring owner, forward each partition
        with its owner preferred, splice responses back into arrival
        order (positions are exact — ``_forward`` answers one line per
        row, always). Owner ejected/draining degrades that partition to
        p2c (counted as affinity misses), never to an error."""
        with self._mu:
            ring = [i for i, b in enumerate(self._backends)
                    if not b.removed]
        if not ring:
            return self._forward(rows, pool)
        groups: Dict[int, List[int]] = {}
        for k, r in enumerate(rows):
            groups.setdefault(self._affinity_owner(r, ring),
                              []).append(k)
        out: List[bytes] = [b""] * len(rows)
        for owner, ks in sorted(groups.items()):
            sub = self._forward([rows[k] for k in ks], pool,
                                prefer=owner)
            for k, resp in zip(ks, sub):
                out[k] = resp
        return out

    # ---------------------------------------------------------- forward
    def _forward(self, rows: List[bytes], pool: dict,
                 _retry_shed: bool = True,
                 prefer: Optional[int] = None) -> List[bytes]:
        """Forward one chunk; returns one newline-terminated response
        line per row, in order. Backend failures resend the unanswered
        tail on a peer; exhausting every backend's budget answers the
        remainder ``!shed`` (retryable backpressure — the fleet may be
        mid-rotation, the rows are not wrong)."""
        pending = [r + b"\n" for r in rows]
        out: List[bytes] = []
        attempts: Dict[int, int] = {}
        first_pick = prefer is not None
        while pending:
            i = self._pick(attempts, prefer)
            if first_pick and i is not None:
                (self._aff_hit_c if i == prefer
                 else self._aff_miss_c).inc(len(pending))
                first_pick = False
            if i is None:
                self._shed_c.inc(len(pending))
                out.extend([b"!shed router: no backend available\n"]
                           * len(pending))
                return out
            answered = 0
            b = self._backends[i]
            n = len(pending)
            with self._mu:
                b.in_flight += n
            try:
                # chaos point: ``close`` tears this backend connection
                # down mid-chunk, ``err`` raises — both must surface as
                # a tail retry on a peer, never a client-visible error
                kind = faultinject.fire("router.forward")
                if kind == "close":
                    self._drop(pool, i)
                    raise ConnectionError(
                        "injected router.forward close")
                faultinject.act_default(kind)
                s, rf = self._conn(pool, i)
                t0 = time.monotonic()
                s.sendall(b"".join(pending))
                saw_draining = False
                for _ in range(len(pending)):
                    resp = rf.readline()
                    if not resp:
                        raise ConnectionError(
                            "backend closed the connection")
                    if resp.startswith(b"!shed draining"):
                        saw_draining = True
                    out.append(resp)
                    answered += 1
                self._note_success(i, answered,
                                   time.monotonic() - t0)
                if saw_draining:
                    self._note_draining(i)
                return (self._retry_shed(rows, out, pool)
                        if _retry_shed else out)
            except (OSError, ConnectionError) as e:
                # in-order responses: answered rows in ``out`` stand
                # (credited to this backend); only the tail travels to
                # a peer. Crediting does NOT clear the failure streak —
                # _note_failure below still advances the ejection.
                pending = pending[answered:]
                if answered:
                    with self._mu:
                        b.rows += answered
                    self._rows_c.labels(endpoint=b.key).inc(answered)
                self._drop(pool, i)
                self._note_failure(i, attempts, e)
            finally:
                with self._mu:
                    b.in_flight -= n
        return out

    # ------------------------------------------------------ aggregation
    def _probe_json(self, b: _Backend, line: bytes) -> dict:
        """One-shot control call on a fresh connection (fresh on purpose:
        under a SO_REUSEPORT takeover it reaches whichever replica
        currently owns fresh connections — the thing a health poll is
        supposed to measure)."""
        s = socket.create_connection((b.host, b.port),
                                     timeout=self.probe_timeout)
        try:
            s.sendall(line + b"\n")
            rf = s.makefile("rb")
            resp = rf.readline()
            if not resp or resp.startswith(b"!err"):
                raise ConnectionError(
                    resp.rstrip(b"\n").decode() or "connection closed")
            return json.loads(resp)
        finally:
            try:
                s.close()
            except OSError:  # pragma: no cover
                pass

    def backends_snapshot(self) -> List[dict]:
        now = time.monotonic()
        with self._mu:
            return [{"endpoint": b.key, "in_flight": b.in_flight,
                     "ewma_ms": round(b.ewma_ms, 3), "fails": b.fails,
                     "ejected": b.down_until > now, "rows": b.rows,
                     "ejections": b.ejections}
                    for b in self._backends if not b.removed]

    def health_snapshot(self) -> dict:
        """Fleet-wide #health: ready while ANY replica is ready (that is
        what a router buys you), per-replica payloads attached so one
        poll shows which replica is the problem. ``server_id`` names
        WHICH group member answered — the group roll dials the shared
        port until it holds a connection to the member it means."""
        replicas = []
        ready = queue_depth = 0
        live = self._live_backends()
        for b in live:
            try:
                h = self._probe_json(b, b"#health")
            except (OSError, ConnectionError, ValueError) as e:
                replicas.append({"endpoint": b.key, "error": str(e)})
                continue
            replicas.append(dict(h, endpoint=b.key))
            if h.get("status") == "ready":
                ready += 1
            queue_depth += int(h.get("queue_depth", 0))
        with self._cmu:
            draining = self._draining
            successor_file = self._successor_file
            successor_ready = self.successor_ready
        out = {"status": ("draining" if draining
                          else "ready" if ready else "down"),
               "router": True, "pid": os.getpid(),
               "server_id": f"router.{os.getpid()}.{id(self):x}",
               "takeover": self.takeover,
               "balance": self.balance,
               "replicas_live": ready,
               "replicas_total": len(live),
               "queue_depth": queue_depth,
               "replicas": replicas}
        if successor_file is not None:
            out["successor_ready"] = successor_ready
        return out

    def stats_snapshot(self) -> dict:
        """Router counters + balance state + the fleet's summed serving
        counters (each replica's #stats, best-effort)."""
        fleet: Dict[str, float] = {}
        replicas = []
        for b in self._live_backends():
            try:
                st = self._probe_json(b, b"#stats")
            except (OSError, ConnectionError, ValueError) as e:
                replicas.append({"endpoint": b.key, "error": str(e)})
                continue
            replicas.append(dict(st, endpoint=b.key))
            for k in ("requests", "responses", "shed", "errors",
                      "batches"):
                if k in st:
                    fleet[k] = fleet.get(k, 0) + st[k]
        with self._mu:
            rows = sum(b.rows for b in self._backends)
        return {"router": True,
                "rows": rows,
                "balance": self.balance,
                "retries": int(self._retry_c.value()),
                "shed": int(self._shed_c.value()),
                "errors": int(self._err_c.value()),
                "affinity_hits": int(self._aff_hit_c.value()),
                "affinity_misses": int(self._aff_miss_c.value()),
                "backends": self.backends_snapshot(),
                "fleet": fleet, "replicas": replicas}

    def metrics_text(self) -> str:
        """Prometheus text for ``#metrics``: the router registry
        (per-endpoint labeled forward counters + balance gauges) merged
        with the process-global registry (fault fires)."""
        from ..obs import REGISTRY, merge_into, render_prometheus
        now = time.monotonic()
        up = self.obs.gauge("router_backend_up",
                            "1 while the backend is not ejected")
        infl = self.obs.gauge("router_backend_in_flight",
                              "rows currently forwarded to the backend")
        ewma = self.obs.gauge("router_backend_ewma_ms",
                              "recent per-row backend latency (EWMA)")
        with self._mu:
            for b in self._backends:
                if b.removed:
                    continue
                up.labels(endpoint=b.key).set(
                    0.0 if b.down_until > now else 1.0)
                infl.labels(endpoint=b.key).set(b.in_flight)
                ewma.labels(endpoint=b.key).set(b.ewma_ms)
        hits = self._aff_hit_c.value()
        misses = self._aff_miss_c.value()
        self.obs.gauge(
            "router_affinity_hit_rate",
            "fraction of affinity forwards landing on the ring owner"
        ).set(hits / (hits + misses) if (hits + misses) else 0.0)
        snap = merge_into(self.obs.snapshot(), REGISTRY.snapshot())
        return render_prometheus(snap)

    # ----------------------------------------------------- handoff roll
    def _control_handoff(self, line: bytes) -> bytes:
        """``#handoff [ready_file]``: acknowledge, then wait for the
        successor's ready file and drain out of the SO_REUSEPORT group
        on a BACKGROUND thread — drain joins connection threads, so it
        must never run on the requesting connection's own thread.
        ``router.takeover`` is the chaos point: an injected err refuses
        the roll before any state changes."""
        try:
            faultinject.act_default(faultinject.fire("router.takeover"))
        except faultinject.FaultInjected as e:
            self._err_c.inc()
            return b"!err %s\n" % str(e).encode()
        arg = line[len(b"#handoff"):].strip().decode()
        if arg and self.ready_file and \
                os.path.abspath(arg) == os.path.abspath(self.ready_file):
            # the group port hashed this connection to the successor:
            # the named ready file is OUR OWN — refuse, the group roll
            # redials until it holds a connection to the incumbent
            return (b"!err handoff addressed to the successor "
                    b"(this router owns the ready file)\n")
        with self._cmu:
            if self._handoff_thread is not None:
                return (json.dumps({"ok": True, "state": "draining"})
                        + "\n").encode()
            self._successor_file = arg
            t = threading.Thread(target=self._handoff, args=(arg,),
                                 name="router-handoff", daemon=True)
            self._handoff_thread = t
        t.start()
        return (json.dumps({"ok": True, "state": "handoff",
                            "successor_file": arg}) + "\n").encode()

    def _handoff(self, ready_file: str) -> None:
        """Wait (bounded by ``handoff_wait_s``) for the successor's
        ready file, then drain. An empty ready_file drains immediately —
        the autoscaler's scale-down primitive. A successor that never
        appears does not pin the incumbent: the handoff was an explicit
        operator request to leave, so after the budget we drain anyway —
        loudly."""
        ready = True
        if ready_file:
            end = time.monotonic() + self.handoff_wait_s
            while (not os.path.isfile(ready_file)
                   and time.monotonic() < end
                   and not self._drain_pending()):
                time.sleep(0.05)
            ready = os.path.isfile(ready_file)
            if not ready and not self._drain_pending():
                log.warning("router handoff: successor never became "
                            "ready (%s); draining anyway", ready_file)
        with self._cmu:
            self.successor_ready = ready
        log.info("router handoff: draining (successor_ready=%s)", ready)
        self.drain()

    def _control_backends(self, line: bytes) -> bytes:
        """``#backends [add|remove host:port]``: runtime ring
        membership — the autoscaler's nudge to every group member. A
        bare ``#backends`` just lists the live ring."""
        arg = line[len(b"#backends"):].strip().decode()
        if arg:
            parts = arg.split()
            if len(parts) != 2 or parts[0] not in ("add", "remove"):
                self._err_c.inc()
                return b"!err router: want add|remove host:port\n"
            try:
                host, port = parse_endpoints(parts[1])[0]
            except ValueError as e:
                self._err_c.inc()
                return b"!err router: %s\n" % str(e).encode()
            if parts[0] == "add":
                self._add_backend(host, port)
            else:
                self._remove_backend(host, port)
        return (json.dumps(
            {"ok": True,
             "server_id": f"router.{os.getpid()}.{id(self):x}",
             "backends": [b.key for b in self._live_backends()]})
            + "\n").encode()

    def _control(self, line: bytes) -> bytes:
        if line == b"#health":
            return (json.dumps(self.health_snapshot()) + "\n").encode()
        if line == b"#stats":
            return (json.dumps(self.stats_snapshot()) + "\n").encode()
        if line == b"#metrics":
            # multi-line payload, blank-line terminated (server.py
            # contract — ServeClient.metrics() works unchanged)
            return self.metrics_text().encode() + b"\n"
        if line == b"#handoff" or line.startswith(b"#handoff "):
            return self._control_handoff(line)
        if line == b"#backends" or line.startswith(b"#backends "):
            return self._control_backends(line)
        self._err_c.inc()
        return b"!err router: unsupported control %s\n" % line[:32]
