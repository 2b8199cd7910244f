"""Nestable trace spans emitting Chrome trace-event JSON (counterpart
of difacto_tpu/obs/trace.py).

``with span("consumer.dispatch", part=3):`` records one complete ("X")
event with microsecond timestamps, its span id, its parent span id and
the run's trace id. ``ts`` is the realtime clock in epoch microseconds
(``time.time_ns``), the clock ``torch.profiler`` stamps its events on,
and one clock for every process of the machine: events that producer
worker processes collect line up with the parent's, and a span file
lays over a device trace of the same run. A worker
(``DIFACTO_OBS_CHILD=1``) collects its events in memory and the pool
ships them through its result queue (obs/proc.py); only the owning
process writes the file. The pack span's id also rides the shared-memory
ring's slot header (data/shm_ring.py), so a consumer span can name the
producer span that built its batch.

The span file is off unless ``DIFACTO_TRACE=<path>`` is set or
:func:`start` is called. The event buffer is bounded (200k events);
overflow drops and counts new events.

Device time: whenever a ``torch.profiler`` session runs in the process,
whoever started it (``DIFACTO_TRACE_DEVICE``, a benchmark's tracer, a
user's own ``profile()``), every span body runs inside
``torch.profiler.record_function(name)``, so the device operations it
launches fall under the span's name. With ``DIFACTO_TRACE_DEVICE=<logdir>``
the module runs such a session itself (CPU activity, and CUDA activity on
a card) from its import to the process's exit, which exports a Chrome
trace into ``<logdir>`` (utils/profiling.py); under that session a span
also opens an NVTX range of its name on a card
(``torch.cuda.nvtx.range_push``/``range_pop``), so Nsight Systems shows
the kernels under it too, and a span with a ``step_num`` arg also marks
a profiler step (``ProfilerStep#<step_num>``, the counterpart of JAX's
``StepTraceAnnotation``). Without the knob the module never creates a
profiler. With neither the span file nor a profiler on, a span is a
plain check: it enters no range, allocates nothing and takes no lock.
"""

from __future__ import annotations

import atexit
import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import List, Optional

from ..utils.locktrace import mutex

_MAX_EVENTS = 200_000

_mu = mutex()
_events: List[dict] = []
_dropped = 0
_active = False
_path: Optional[str] = None
_prof = None              # torch.profiler session once device tracing is on
_prof_dir: Optional[str] = None
_nvtx = False             # NVTX ranges beside the record_function ranges
_trace_id = 0
_span_ids = itertools.count(1)
_tls = threading.local()  # per-thread span stack


def active() -> bool:
    return _active


def trace_id() -> int:
    return _trace_id


def set_trace_id(tid: int) -> None:
    """Adopt a parent process's trace id (it reaches producer workers
    through pack_stream.StreamSpec)."""
    global _trace_id
    # lint: ok(data-race) write-once setup before producer workers span
    _trace_id = int(tid)


def start(path: Optional[str] = None,
          trace_id_: Optional[int] = None) -> None:
    """Begin collecting span events; ``path`` is where :func:`save` (and
    the atexit hook) writes them."""
    global _active, _path, _trace_id
    # lint: ok(data-race) GIL-atomic on/off flip; spans tolerate either
    _active = True
    if path:
        _path = path
    _trace_id = (trace_id_ if trace_id_ is not None
                 else _trace_id or (os.getpid() << 16)
                 # lint: ok(wall-clock) id entropy, not a duration
                 | int(time.time()) % (1 << 16))


def stop() -> None:
    global _active
    _active = False


def start_device(logdir: str) -> bool:
    """Start a torch.profiler session that stop_device() exports into
    ``logdir``, and annotate every span from here on
    (``DIFACTO_TRACE_DEVICE``). Returns False when the profiler cannot
    start; host spans go on without it."""
    global _prof, _prof_dir, _nvtx
    try:
        import torch

        from ..utils.profiling import start_profiler
        cuda = torch.cuda.is_available()
        prof = start_profiler(cuda)
    except Exception as e:  # pragma: no cover - profiler/backend quirks
        logging.getLogger(__name__).warning(
            "device trace unavailable (%s); host spans continue", e)
        return False
    # lint: ok(data-race) write-once setup before any span thread
    _prof_dir, _nvtx = logdir, cuda
    # lint: ok(data-race) write-once setup before any span thread
    _prof = prof
    return True


def stop_device() -> Optional[str]:
    """Stop the device session and export its Chrome trace into the
    logdir; returns the trace's path (None when no session ran)."""
    global _prof
    prof, _prof = _prof, None
    if prof is None:
        return None
    try:
        from ..utils.profiling import stop_profiler
        return stop_profiler(prof, _prof_dir)
    except Exception as e:  # pragma: no cover - teardown shield
        logging.getLogger(__name__).warning(
            "device trace stop failed: %s", e)
        return None


def current_span_id() -> int:
    """The innermost open span's id on this thread (0 outside any)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else 0


def last_span_id() -> int:
    """The most recently closed span's id on this thread."""
    return getattr(_tls, "last", 0)


def add_event(ev: dict) -> None:
    global _dropped
    with _mu:
        if len(_events) >= _MAX_EVENTS:
            _dropped += 1
            return
        _events.append(ev)


def add_events(evs: List[dict]) -> None:
    """Merge events shipped from a child process (obs/proc.py)."""
    global _dropped
    if not evs:
        return
    with _mu:
        room = _MAX_EVENTS - len(_events)
        _events.extend(evs[:room])
        _dropped += max(0, len(evs) - room)


def drain_events() -> List[dict]:
    """Take (and clear) the collected events."""
    global _events
    with _mu:
        out, _events = _events, []
    return out


def profiling() -> bool:
    """Whether a torch.profiler session runs in this process, whoever
    started it (torch's own flag; a process that never loaded the
    profiler runs none)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _Off:
    """The span of a process that neither records nor profiles."""

    __slots__ = ()

    def __enter__(self) -> int:
        return 0

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    """An active span: a recorded event when the span file is on, a
    ``record_function`` range (and under this module's own session an
    NVTX range and the step mark) when a profiler runs."""

    __slots__ = ("name", "args", "record", "profiled", "sid", "parent",
                 "ts", "t0", "ranges", "nvtx")

    def __init__(self, name: str, args: dict, record: bool,
                 profiled: bool) -> None:
        self.name, self.args = name, args
        self.record, self.profiled = record, profiled
        self.sid = 0

    def __enter__(self) -> int:
        if self.record:
            stack = getattr(_tls, "stack", None)
            if stack is None:
                stack = _tls.stack = []
            self.sid = next(_span_ids)
            self.parent = stack[-1] if stack else 0
            stack.append(self.sid)
        self.ts = time.time_ns()
        self.t0 = time.perf_counter()
        if self.profiled:
            self._open_ranges()
        return self.sid

    def _open_ranges(self) -> None:
        import torch
        ranges = []
        if _prof is not None and "step_num" in self.args:
            ranges.append(torch.profiler.record_function(
                f"ProfilerStep#{self.args['step_num']}"))
        ranges.append(torch.profiler.record_function(self.name))
        for r in ranges:
            r.__enter__()
        self.ranges = ranges
        self.nvtx = _nvtx
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc) -> None:
        if self.profiled:
            if self.nvtx:
                import torch
                torch.cuda.nvtx.range_pop()
            for r in reversed(self.ranges):
                r.__exit__(*exc)
        if not self.record:
            return
        dur = (time.perf_counter() - self.t0) * 1e6
        _tls.stack.pop()
        _tls.last = self.sid
        add_event({"name": self.name, "ph": "X", "ts": self.ts / 1e3,
                   "dur": dur, "pid": os.getpid(),
                   "tid": threading.get_ident() & 0xFFFFFFFF,
                   "args": {"span_id": self.sid, "parent": self.parent,
                            "trace_id": _trace_id, **self.args}})


def span(name: str, **args):
    """A context manager recording a complete trace event around the
    body; keyword args (ints and strings) go into the event's ``args``,
    and entering it gives the span's id (0 with the span file off).
    Under a running profiler the body runs inside ranges of the span's
    name."""
    record, profiled = _active, profiling()
    if not record and not profiled:
        return _OFF
    return _Span(name, args, record, profiled)


def save(path: Optional[str] = None) -> Optional[str]:
    """Write the collected events as Chrome trace JSON (Perfetto or
    chrome://tracing); returns the path, or None with nowhere to write."""
    path = path or _path
    if not path:
        return None
    with _mu:
        events = list(_events)
        dropped = _dropped
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"trace_id": _trace_id, "dropped_events": dropped}}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _maybe_start_from_env() -> None:
    path = os.environ.get("DIFACTO_TRACE", "")
    dev = os.environ.get("DIFACTO_TRACE_DEVICE", "")
    if not path and not dev:
        return
    if os.environ.get("DIFACTO_OBS_CHILD"):
        # a producer worker: collect, the parent writes; the profiler is
        # the parent's too (workers own no device)
        start()
        return
    start(path or None)
    if path:
        atexit.register(save)
    if dev and start_device(dev):
        # one profiler session per process, exported at exit into the
        # logdir next to the span file
        atexit.register(stop_device)


_maybe_start_from_env()
