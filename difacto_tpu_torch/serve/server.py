"""Threaded TCP serving front-end (counterpart of
difacto_tpu/serve/server.py, the same wire grammar).

Wire protocol (newline-delimited):

- request line = one data row in ``data_format`` (default libsvm; the
  label is ignored for scoring but keeps the row grammar of training
  files);
- response line = the ``%g``-formatted probability (``pred_prob=False``:
  the raw clamped margin) for that row, in request order per connection —
  the formatting of the ``task=pred`` writer, so responses equal the pred
  file's column byte for byte;
- ``#stats`` -> one JSON line of serving, executor and reload counters;
- ``#health`` -> one JSON line: readiness, queue depth, shed rate, the
  served ``model_generation``, which replica answered (``pid``,
  ``server_id``), ``takeover``, ``swap_state`` and, once a ``#handoff``
  is pending, ``successor_ready``;
- ``#metrics`` -> Prometheus text of the server's obs registry merged
  with the process-global one, ended by one blank line;
- ``#reload [path]`` -> a synchronous hot reload (serve/reload.py),
  ``{"ok": true, "model_generation": N, ...}`` or ``{"ok": false,
  "error": ...}``;
- ``#handoff [ready_file]`` -> replica takeover: reply at once, then (on
  a background thread) wait for the successor's ready file and drain.
  With ``takeover=True`` the listening socket is bound ``SO_REUSEPORT``,
  so a successor process binds the SAME port while this one drains;
  established connections stay with their owner (``serve.handoff`` is a
  fault point);
- ``#score <id> <row>`` -> score ``row`` like a plain request line and,
  when an online log is attached, log it under the client's id;
- ``#label <id> <y>`` -> join the delayed label ``y`` onto the pending
  logged row ``id`` (online/log.py): ``{"ok": true}`` joined,
  ``{"ok": false}`` the row had already resolved. Plain rows are logged
  too, under automatic ids;
- ``!shed`` -> the admission queue was full (``!shed draining`` while
  draining); ``!err <reason>`` -> the row or line was rejected.

One reader and one writer thread per connection: the reader parses and
admits rows into the shared MicroBatcher, the writer resolves futures in
request order, so a pipelined client never deadlocks against the batching
delay. ``close()`` joins every thread and closes every socket;
``serve.sock.read`` and ``serve.sock.write`` are fault points on each
side of a connection.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import threading
import time
from typing import Optional

from ..data.parsers import get_parser
from ..obs import counter as _counter
from ..utils import faultinject, stream
from ..utils.reporter import Reporter
from .batcher import MicroBatcher, ServeStats
from .executor import PredictExecutor, sigmoid
from ..utils.locktrace import mutex

log = logging.getLogger("difacto_tpu_torch")

_c_log_drops = _counter(
    "online_log_drops_total",
    "served rows the online training log failed to append (the row was "
    "still answered — serving never fails because logging failed)")


class ServeServer:
    def __init__(self, store, host: str = "127.0.0.1", port: int = 0,
                 batch_size: int = 256,
                 max_delay_ms: float = 2.0, queue_cap: int = 1024,
                 pred_prob: bool = True, data_format: str = "libsvm",
                 max_row_nnz: int = 4096, report_every_s: float = 30.0,
                 reporter: Optional[Reporter] = None,
                 drain_timeout_s: float = 10.0, takeover: bool = False,
                 handoff_wait_s: float = 30.0, online_log=None):
        self.executor = PredictExecutor(store)
        if reporter is None:
            reporter = Reporter(every=1)
            reporter.set_monitor(
                lambda _node, payload: log.info("serve: %s", payload))
        self.stats = ServeStats(reporter, report_every_s=report_every_s)
        self.obs = self.stats.obs
        self.batcher = MicroBatcher(self.executor.predict_scores,
                                    batch_size=batch_size,
                                    max_delay_ms=max_delay_ms,
                                    queue_cap=queue_cap, stats=self.stats)
        self.pred_prob = pred_prob
        self.max_row_nnz = max_row_nnz
        self.drain_timeout_s = drain_timeout_s
        # a reload.ModelReloader, attached by run_serve or the caller
        self.reloader = None
        self.online_log = online_log
        self.draining = False
        # takeover: run_serve sets ready_file so a #handoff naming our
        # own ready file (SO_REUSEPORT hashed the caller's connection to
        # the successor) is refused
        self.takeover = takeover
        self.handoff_wait_s = handoff_wait_s
        self.ready_file = ""
        self.successor_ready = False
        self._successor_file: Optional[str] = None
        self._handoff_thread: Optional[threading.Thread] = None
        self._parser = get_parser(data_format)
        # every replica of a takeover pair binds SO_REUSEPORT, the
        # incumbent included: the kernel refuses mixed bindings
        self._sock = socket.create_server((host, port),
                                          reuse_port=takeover)
        self._sock.settimeout(0.25)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._done = threading.Event()     # set once close() has finished
        self._mu = mutex()
        self._closed = False
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()            # guarded by _mu
        self._conn_threads: list = []       # guarded by _mu
        # serve_generation_age_s: when the served generation last moved
        self._gen_seen = self.executor.generation
        self._gen_ts = time.monotonic()

    # ---------------------------------------------------------- control
    def start(self) -> "ServeServer":
        self.batcher.start()
        t = threading.Thread(target=self._accept_loop, name="serve-accept",
                             daemon=True)
        with self._mu:
            self._accept_thread = t
        t.start()
        log.info("serving on %s:%d (batch<=%d rows, delay<=%.1fms, "
                 "queue<=%d rows, %s)", self.host, self.port,
                 self.batcher.batch_size, self.batcher.max_delay_s * 1e3,
                 self.batcher.queue_cap, self.executor.store.device)
        return self

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until close() has finished (or the timeout elapses). A
        ``#handoff`` closes the server on its own thread: the caller that
        exits the process after this returns must not tear the
        interpreter down under a batch still running there."""
        self._done.wait(timeout)

    def _is_closed(self) -> bool:
        with self._mu:
            return self._closed

    def close(self) -> None:
        """Stop accepting, drop connections, join every thread —
        idempotent, and safe to race from a signal handler."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._stop_listening()
        with self._mu:
            accept, self._accept_thread = self._accept_thread, None
        if accept is not None:
            accept.join()
        with self._mu:
            conns = list(self._conns)
            threads, self._conn_threads = self._conn_threads, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        # #handoff -> drain -> close runs on a connection's thread
        # family; never join the calling thread itself
        me = threading.current_thread()
        for t in threads:
            if t is not me:
                t.join()
        self.batcher.close()
        self._done.set()

    def drain(self, timeout_s: Optional[float] = None) -> float:
        """Graceful shutdown: stop accepting, answer new rows ``!shed
        draining``, wait (at most ``drain_timeout_s``) until every
        admitted row — queued or mid-batch — resolved, then close.
        Returns the seconds it took; idempotent with close()."""
        timeout = self.drain_timeout_s if timeout_s is None else timeout_s
        t0 = time.monotonic()
        # lint: ok(data-race) monotonic False->True flip (GIL-atomic); the
        # per-row readers see it at the next row and answer !shed draining
        self.draining = True
        self._stop_listening()       # the accept loop exits on OSError
        deadline = t0 + timeout
        while time.monotonic() < deadline:
            if self.batcher.idle:
                break
            time.sleep(0.02)
        else:
            log.warning("drain timed out after %.1fs with %d rows queued",
                        timeout, self.batcher.rows_queued)
        # one beat for the writers to flush resolved futures
        time.sleep(0.05)
        self.close()
        return time.monotonic() - t0

    def _stop_listening(self) -> None:
        """Leave the port now. A close alone keeps the listener in the
        kernel's SO_REUSEPORT group until the accept thread's poll
        returns, and a fresh connection hashed to it in that window is
        reset; the shutdown unhashes it at once, so under a takeover new
        connections reach only the successor."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def swap_executor(self, new) -> None:
        """Blue/green commit point (serve/reload.py): the batcher reads
        ``predict_fn`` afresh per flush, so the batch in flight finishes
        on blue and the next one runs on green."""
        # lint: ok(data-race) atomic reference swap (blue/green commit):
        # each reader takes the executor once per use
        self.executor = new
        self.batcher.predict_fn = new.predict_scores

    def stats_snapshot(self) -> dict:
        """Serving counters + executor stats + reload counters."""
        out = dict(self.stats.snapshot(), **self.executor.stats())
        if self.reloader is not None:
            out.update(self.reloader.stats())
        return out

    def health_snapshot(self) -> dict:
        """The ``#health`` payload (the JAX server's keys)."""
        with self._mu:
            successor_file = self._successor_file
            successor_ready = self.successor_ready
        out = {
            "status": "draining" if self.draining else "ready",
            "queue_depth": self.batcher.rows_queued,
            "queue_cap": self.batcher.queue_cap,
            "shed_rate": self.stats.shed_rate(),
            "model_generation": self.executor.generation,
            "pid": os.getpid(),
            "server_id": f"{os.getpid()}.{id(self):x}",
            "takeover": self.takeover,
            "swap_state": (self.reloader.stats()["swap_state"]
                           if self.reloader is not None else "idle"),
        }
        if successor_file is not None:
            out["successor_ready"] = successor_ready
        return out

    # ------------------------------------------------------- connection
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name="serve-conn", daemon=True)
            with self._mu:
                self._conns.add(conn)
                self._conn_threads = [x for x in self._conn_threads
                                      if x.is_alive()]
                self._conn_threads.append(t)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        """Per-connection reader: parse + admit each line, hand ordered
        reply slots to the writer thread."""
        replies: "queue.Queue" = queue.Queue()
        writer = threading.Thread(target=self._writer, args=(conn, replies),
                                  name="serve-conn-writer", daemon=True)
        writer.start()
        try:
            with conn.makefile("rb") as rfile:
                for line in rfile:
                    # an injected close models the peer tearing the
                    # connection down mid-request
                    if faultinject.fire("serve.sock.read") == "close":
                        try:
                            conn.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        break
                    line = line.strip()
                    if not line:
                        continue
                    if line.startswith(b"#score "):
                        replies.put(self._admit_scored(line))
                    elif line.startswith(b"#"):
                        replies.put(("raw", self._control(line), 0.0))
                    else:
                        replies.put(self._admit(line))
        except (OSError, ValueError):
            pass
        finally:
            replies.put(None)
            writer.join()
            conn.close()
            with self._mu:
                self._conns.discard(conn)

    def _admit(self, row: bytes, row_id: Optional[int] = None):
        """Parse + admit one data row; returns the writer-queue item
        (``("fut", future, t0)`` or a raw reply)."""
        t0 = time.monotonic()
        if self.draining:
            self.stats.record_shed()
            return ("raw", b"!shed draining\n", 0.0)
        try:
            blk = self._parser(row)
        except ValueError as e:
            log.debug("bad row %r: %s", row[:80], e)
            blk = None
        if blk is None or blk.size != 1:
            self.stats.record_error()
            return ("raw", b"!err bad row\n", 0.0)
        if blk.nnz > self.max_row_nnz:
            self.stats.record_error()
            return ("raw", b"!err row exceeds serve_max_row_nnz=%d\n"
                    % self.max_row_nnz, 0.0)
        try:
            fut = self.batcher.submit(blk)
        except faultinject.FaultInjected as e:
            self.stats.record_error()
            return ("raw", b"!err %s\n" % str(e).encode(), 0.0)
        if fut is None:
            return ("raw", b"!shed\n", 0.0)
        # log AFTER the admit: the training log holds served rows only
        self._log_row(blk, row_id)
        return ("fut", fut, t0)

    def _admit_scored(self, line: bytes):
        """``#score <id> <row>``: a plain row logged under the client's
        id, so ``#label <id> <y>`` can join onto it."""
        parts = line.split(None, 2)
        if len(parts) != 3:
            self.stats.record_error()
            return ("raw", b"!err bad #score line\n", 0.0)
        try:
            rid = int(parts[1])
        except ValueError:
            self.stats.record_error()
            return ("raw", b"!err bad #score id\n", 0.0)
        return self._admit(parts[2], row_id=rid)

    def _log_row(self, blk, row_id: Optional[int]) -> None:
        """Append a served row to the online log. A failure (an injected
        ``online.log.append``, disk trouble) is counted and the row is
        still answered."""
        online_log = self.online_log
        if online_log is None:
            return
        try:
            online_log.append(blk, row_id=row_id)
        except Exception as e:  # boundary: serving never fails on logging
            _c_log_drops.inc()
            log.debug("online log append dropped row: %s", e)

    def metrics_text(self) -> str:
        """Prometheus text for ``#metrics``: the server's registry with
        the executor and reloader state mirrored into gauges, merged with
        the process-global registry (faults, the online loop's
        freshness gauges)."""
        from ..obs import REGISTRY, merge_into, render_prometheus
        ex = self.executor.stats()
        self.obs.gauge("serve_model_generation",
                       "generation of the model currently serving"
                       ).set(ex["model_generation"])
        self.obs.gauge("serve_buckets_compiled",
                       "predict shape buckets registered so far"
                       ).set(ex["buckets_compiled"])
        self.obs.gauge("serve_dispatches",
                       "predict executor dispatches").set(ex["dispatches"])
        self.obs.gauge("serve_queue_cap", "admission bound in rows"
                       ).set(self.batcher.queue_cap)
        self.obs.gauge("serve_draining",
                       "1 while draining for shutdown"
                       ).set(1.0 if self.draining else 0.0)
        now = time.monotonic()
        with self._mu:
            if ex["model_generation"] != self._gen_seen:
                self._gen_seen = ex["model_generation"]
                self._gen_ts = now
            gen_age = now - self._gen_ts
        self.obs.gauge("serve_generation_age_s",
                       "seconds since the serving model generation "
                       "last advanced").set(gen_age)
        if self.reloader is not None:
            rs = self.reloader.stats()
            self.obs.gauge("serve_reloads",
                           "successful model hot-reloads"
                           ).set(rs["reloads"])
            self.obs.gauge("serve_reload_failures",
                           "failed model hot-reloads (old model kept)"
                           ).set(rs["reload_failures"])
            self.obs.gauge("serve_swap_warming",
                           "1 while a blue/green warm or swap is in "
                           "flight").set(
                0.0 if rs["swap_state"] == "idle" else 1.0)
        snap = merge_into(self.obs.snapshot(), REGISTRY.snapshot())
        return render_prometheus(snap)

    def _control(self, line: bytes) -> bytes:
        if line == b"#stats":
            return (json.dumps(self.stats_snapshot()) + "\n").encode()
        if line == b"#metrics":
            # multi-line, ended by one blank line (the text format never
            # emits one itself)
            return self.metrics_text().encode() + b"\n"
        if line == b"#health":
            return (json.dumps(self.health_snapshot()) + "\n").encode()
        if line.startswith(b"#label "):
            return self._control_label(line)
        if line == b"#handoff" or line.startswith(b"#handoff "):
            return self._control_handoff(line)
        if line == b"#reload" or line.startswith(b"#reload "):
            # synchronous on THIS connection's reader: other connections
            # keep scoring through the batcher while the model loads
            if self.reloader is None:
                return b"!err no reloader configured (set model_in)\n"
            path = line[len(b"#reload"):].strip().decode() or None
            return (json.dumps(self.reloader.reload(path)) + "\n").encode()
        return b"!err unknown control %s\n" % line[:32]

    def _control_label(self, line: bytes) -> bytes:
        """``#label <id> <y>``: typed replies for every failure shape."""
        online_log = self.online_log
        if online_log is None:
            return b"!err no online log attached\n"
        parts = line.split()
        if len(parts) != 3:
            return b"!err bad #label line\n"
        try:
            rid, y = int(parts[1]), float(parts[2])
        except ValueError:
            return b"!err bad #label args\n"
        try:
            joined = online_log.label(rid, y)
        except faultinject.FaultInjected as e:
            self.stats.record_error()
            return b"!err %s\n" % str(e).encode()
        return (json.dumps({"ok": joined}) + "\n").encode()

    def _control_handoff(self, line: bytes) -> bytes:
        """``#handoff [ready_file]``: acknowledge, then wait for the
        successor and drain on a BACKGROUND thread — the drain joins the
        connection threads, so it never runs on the requester's reader."""
        try:
            faultinject.act_default(faultinject.fire("serve.handoff"))
        except faultinject.FaultInjected as e:
            return b"!err %s\n" % str(e).encode()
        arg = line[len(b"#handoff"):].strip().decode()
        if arg and self.ready_file and \
                os.path.abspath(arg) == os.path.abspath(self.ready_file):
            return (b"!err handoff addressed to the successor "
                    b"(this replica owns the ready file)\n")
        with self._mu:
            if self._handoff_thread is not None:
                return (json.dumps({"ok": True, "state": "draining"})
                        + "\n").encode()
            self._successor_file = arg
            t = threading.Thread(target=self._handoff, args=(arg,),
                                 name="serve-handoff", daemon=True)
            self._handoff_thread = t
        t.start()
        return (json.dumps({"ok": True, "state": "handoff",
                            "successor_file": arg}) + "\n").encode()

    def _handoff(self, ready_file: str) -> None:
        """Wait (at most ``handoff_wait_s``) for the successor's ready
        file, then drain — anyway, loudly, if it never appears: the
        handoff asked this replica to leave."""
        end = time.monotonic() + self.handoff_wait_s
        if ready_file:
            while (not stream.isfile(ready_file)
                   and time.monotonic() < end
                   and not self._is_closed()):
                time.sleep(0.05)
            ready = stream.isfile(ready_file)
            if not ready and not self._is_closed():
                log.warning("handoff: successor never became ready "
                            "(%s); draining anyway", ready_file)
        else:
            ready = True
        with self._mu:
            self.successor_ready = ready
        log.info("handoff: draining incumbent (successor_ready=%s)",
                 ready)
        self.drain()

    def _writer(self, conn: socket.socket, replies: "queue.Queue") -> None:
        try:
            while True:
                item = replies.get()
                if item is None:
                    return
                # an injected close drops the connection mid-response
                # stream: the failure the retrying client must survive
                if faultinject.fire("serve.sock.write") == "close":
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return
                kind, payload, t0 = item
                if kind == "raw":
                    conn.sendall(payload)
                    continue
                try:
                    scores = payload.result(timeout=60.0)
                except Exception as e:  # the batch failed: answer !err
                    conn.sendall(b"!err %s\n"
                                 % str(e).encode("utf-8", "replace")[:200])
                    continue
                out = sigmoid(scores) if self.pred_prob else scores
                self.stats.record_latency(time.monotonic() - t0)
                conn.sendall(("%g\n" % float(out[0])).encode())
        except OSError:  # client went away mid-reply
            pass
