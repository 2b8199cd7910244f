"""Nestable host trace spans emitting Chrome trace-event JSON
(counterpart of difacto_tpu/obs/trace.py, host spans only).

``with span("consumer.dispatch", part=3):`` records one complete ("X")
event with microsecond timestamps, its span id, its parent span id and
the run's trace id. Timestamps come from ``time.perf_counter`` (one
monotonic clock for every process of the machine), so events that
producer worker processes collect line up with the parent's. A worker
(``DIFACTO_OBS_CHILD=1``) collects its events in memory and the pool
ships them through its result queue (obs/proc.py); only the owning
process writes the file. The pack span's id also rides the shared-memory
ring's slot header (data/shm_ring.py), so a consumer span can name the
producer span that built its batch.

Tracing is off unless ``DIFACTO_TRACE=<path>`` is set or :func:`start`
is called; an inactive span is one global read. The event buffer is
bounded (200k events); overflow drops and counts new events. The JAX
package's device annotations (``DIFACTO_TRACE_DEVICE``) are not ported:
their counterpart here would be NVTX ranges.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, List, Optional

from ..utils.locktrace import mutex

_MAX_EVENTS = 200_000

_mu = mutex()
_events: List[dict] = []
_dropped = 0
_active = False
_path: Optional[str] = None
_trace_id = 0
_span_ids = itertools.count(1)
_tls = threading.local()  # per-thread span stack


def _now_us() -> float:
    return time.perf_counter() * 1e6


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


@contextlib.contextmanager
def span(name: str, **args) -> Iterator[int]:
    """Record a complete trace event around the body; keyword args (ints
    and strings) go into the event's ``args``."""
    if not _active:
        yield 0
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    sid = next(_span_ids)
    parent = stack[-1] if stack else 0
    stack.append(sid)
    t0 = _now_us()
    try:
        yield sid
    finally:
        dur = _now_us() - t0
        stack.pop()
        _tls.last = sid
        add_event({"name": name, "ph": "X", "ts": t0, "dur": dur,
                   "pid": os.getpid(),
                   "tid": threading.get_ident() & 0xFFFFFFFF,
                   "args": {"span_id": sid, "parent": parent,
                            "trace_id": _trace_id, **args}})


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
    if not path:
        return
    if os.environ.get("DIFACTO_OBS_CHILD"):
        start()         # a producer worker: collect, the parent writes
        return
    start(path)
    atexit.register(save)


_maybe_start_from_env()
