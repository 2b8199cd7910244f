"""Dynamic micro-batcher (counterpart of difacto_tpu/serve/batcher.py).

A bounded admission queue feeds one batching thread that collects
requests until ``batch_size`` rows or ``max_delay_ms`` elapse, then
concatenates them into ONE RowBlock and runs the predict executor once.
A full queue SHEDS the request at admission (``submit`` returns None), so
queued work — and queueing latency — stays bounded by ``queue_cap`` rows.

``ServeStats`` keeps the counters behind the server's ``#stats`` line in
an obs registry of its own (one per server, so two servers in a process
never blur), which the ``#metrics`` line renders as Prometheus text; the
exact sliding-window percentiles stay for ``#stats``. The registry is
always on: ``#stats`` is a wire contract, not optional telemetry. A
``Reporter`` receives a throttled snapshot (``maybe_report``).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from ..data.rowblock import RowBlock
from ..utils import faultinject, shared
from ..utils.locktrace import mutex
from ..utils.reporter import Reporter

log = logging.getLogger("difacto_tpu_torch")


class ServeStats:
    """Serving counters + latency, backed by a per-server obs registry."""

    # RACETRACE opt-in (utils/shared.py): the fields guarded by _mu,
    # traced when DIFACTO_RACETRACE=1
    _lat = shared.attr()
    _last_report = shared.attr()

    def __init__(self, reporter: Optional[Reporter] = None,
                 report_every_s: float = 30.0, window: int = 8192,
                 registry=None):
        from ..obs import Registry
        self.obs = registry if registry is not None \
            else Registry(enabled=True)
        self._mu = mutex()     # latency window + report throttle
        self._lat = collections.deque(maxlen=window)  # seconds
        self._t0 = time.monotonic()
        self._last_report = self._t0
        self._report_every = report_every_s
        self.reporter = reporter
        self._req_c = self.obs.counter(
            "serve_requests_total",
            "rows admitted into the micro-batcher").labels()
        self._resp_c = self.obs.counter(
            "serve_responses_total", "rows scored and answered")
        self._shed_c = self.obs.counter(
            "serve_shed_total", "rows shed at admission (queue full or "
            "draining)")
        self._err_c = self.obs.counter(
            "serve_errors_total", "rows rejected or failed")
        self._batch_c = self.obs.counter(
            "serve_batches_total", "micro-batches dispatched")
        self._rows_c = self.obs.counter(
            "serve_rows_batched_total", "rows across dispatched "
            "micro-batches")
        self._lat_h = self.obs.histogram(
            "serve_latency_seconds",
            "admit-to-answer latency per scored row")
        self._occ_h = self.obs.histogram(
            "serve_batch_rows", "micro-batch occupancy (rows per batch)",
            bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                    4096))
        self._qd_g = self.obs.gauge(
            "serve_queue_depth", "admission queue depth at the last "
            "batch flush")
        self._qdm_g = self.obs.gauge(
            "serve_queue_depth_max", "high-water admission queue depth")

    def record_admit(self, rows: int = 1) -> None:
        self._req_c.inc(rows)

    def record_shed(self, rows: int = 1) -> None:
        self._shed_c.inc(rows)

    def record_error(self, rows: int = 1) -> None:
        self._err_c.inc(rows)

    def record_batch(self, rows: int, queue_depth: int) -> None:
        self._batch_c.inc()
        self._rows_c.inc(rows)
        self._occ_h.observe(rows)
        self._qd_g.set(queue_depth)
        s = self._qdm_g.labels()
        s.set(max(s.value(), queue_depth))

    def shed_rate(self) -> float:
        """Lifetime shed fraction, cheap enough for every ``#health``."""
        n_shed = self._shed_c.value()
        offered = self._req_c.value() + n_shed
        return round(n_shed / max(offered, 1), 4)

    def record_latency(self, seconds: float) -> None:
        self._resp_c.inc()
        self._lat_h.observe(seconds)
        with self._mu:
            self._lat.append(seconds)

    def snapshot(self) -> dict:
        with self._mu:
            lat = np.asarray(self._lat, dtype=np.float64)
        n_requests = int(self._req_c.value())
        n_responses = int(self._resp_c.value())
        n_shed = int(self._shed_c.value())
        n_batches = int(self._batch_c.value())
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        out = {
            "requests": n_requests,
            "responses": n_responses,
            "shed": n_shed,
            "errors": int(self._err_c.value()),
            "shed_rate": round(n_shed / max(n_requests + n_shed, 1), 4),
            "qps": round(n_responses / elapsed, 1),
            "batches": n_batches,
            "batch_occupancy": round(
                self._rows_c.value() / max(n_batches, 1), 2),
            "queue_depth": int(self._qd_g.value()),
            "queue_depth_max": int(self._qdm_g.value()),
        }
        if len(lat):
            p50, p95, p99 = np.percentile(lat, [50, 95, 99]) * 1e3
            out.update(p50_ms=round(float(p50), 3),
                       p95_ms=round(float(p95), 3),
                       p99_ms=round(float(p99), 3),
                       max_ms=round(float(lat.max() * 1e3), 3))
        return out

    def maybe_report(self) -> None:
        """Throttled publish through the Reporter channel."""
        if self.reporter is None:
            return
        now = time.monotonic()
        with self._mu:
            if now - self._last_report < self._report_every:
                return
            self._last_report = now
        self.reporter.report(self.snapshot())


class MicroBatcher:
    """Collect -> concat -> score, with explicit shed on overload.

    ``predict_fn(blk) -> scores[blk.size]`` runs on the batching thread
    and is read afresh at every flush: the blue/green swap
    (server.swap_executor) retargets the NEXT flush, and the batch in
    flight finishes on the function it started with."""

    # RACETRACE opt-in (utils/shared.py): `_rows_queued`/`_busy` are
    # guarded by _mu; the stop flag is a threading.Event
    _rows_queued = shared.attr()
    _busy = shared.attr()

    def __init__(self, predict_fn: Callable[[RowBlock], np.ndarray],
                 batch_size: int = 256, max_delay_ms: float = 2.0,
                 queue_cap: int = 1024,
                 stats: Optional[ServeStats] = None):
        self.predict_fn = predict_fn
        self.batch_size = batch_size
        self.max_delay_s = max_delay_ms / 1e3
        self.queue_cap = queue_cap
        self.stats = stats if stats is not None else ServeStats()
        self._q: "queue.Queue" = queue.Queue()
        self._mu = mutex()
        self._rows_queued = 0          # guarded by _mu
        self._busy = False             # a batch is being scored; _mu
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # fail what is still queued so connection writers never hang
        while True:
            try:
                _, fut, _rows = self._q.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("serve batcher shut down"))

    def submit(self, blk: RowBlock) -> Optional[Future]:
        """Admit a request; a Future resolving to scores[blk.size], or
        None when the queue is full (the caller answers ``!shed``).
        ``batcher.enqueue`` is a fault point: ``err`` surfaces through the
        server as an ``!err`` reply, ``delay_ms`` stalls admission."""
        faultinject.act_default(faultinject.fire("batcher.enqueue"))
        with self._mu:
            if self._rows_queued + blk.size > self.queue_cap:
                self.stats.record_shed(blk.size)
                return None
            self._rows_queued += blk.size
        fut: Future = Future()
        self.stats.record_admit(blk.size)
        self._q.put((blk, fut, blk.size))
        return fut

    @property
    def rows_queued(self) -> int:
        with self._mu:
            return self._rows_queued

    @property
    def idle(self) -> bool:
        """No queued rows and no batch mid-score: the drain's "every
        admitted row resolved" condition, read in one locked snapshot."""
        with self._mu:
            return self._rows_queued == 0 and not self._busy

    def _collect(self):
        """Block for the first request, then fill until batch_size rows or
        the delay budget expires."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        rows = first[2]
        deadline = time.monotonic() + self.max_delay_s
        while rows < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(item)
            rows += item[2]
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            # busy BEFORE the queued-row decrement, in one _mu region:
            # the drain must never see (0 queued, not busy) while this
            # batch is unscored
            rows = sum(r for _, _, r in batch)
            with self._mu:
                self._busy = True
                self._rows_queued -= rows
                depth = self._rows_queued
            try:
                self.stats.record_batch(rows, depth)
                try:
                    scores = self.predict_fn(
                        RowBlock.concat([b for b, _, _ in batch]))
                except Exception as e:  # boundary: answer, keep serving
                    log.exception("serve batch failed")
                    self.stats.record_error(rows)
                    for _, fut, _ in batch:
                        fut.set_exception(e)
                    continue
                o = 0
                for _, fut, r in batch:
                    fut.set_result(scores[o:o + r])
                    o += r
                self.stats.maybe_report()
            finally:
                with self._mu:
                    self._busy = False
