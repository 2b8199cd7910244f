"""Nestable trace spans emitting Chrome trace-event JSON (counterpart
of difacto_tpu/obs/trace.py).

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
bounded (200k events); overflow drops and counts new events.

Device time: with ``DIFACTO_TRACE_DEVICE=<logdir>`` the module also runs
a ``torch.profiler`` session (CPU activity, and CUDA activity on a card)
from its import to the process's exit, which exports a Chrome trace into
``<logdir>`` (utils/profiling.py), and every span body runs inside
``torch.profiler.record_function(name)`` and, on a card, an NVTX range of
the same name (``torch.cuda.nvtx.range_push``/``range_pop``), so Perfetto
and Nsight Systems show the kernels under the host spans' names. A span
with a ``step_num`` arg also marks a profiler step
(``ProfilerStep#<step_num>``, the counterpart of JAX's
``StepTraceAnnotation``). Without the knob the module never creates a
profiler.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import logging
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
_prof = None              # torch.profiler session once device tracing is on
_prof_dir: Optional[str] = None
_nvtx = False             # NVTX ranges beside the record_function ranges
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


@contextlib.contextmanager
def _annotated(name: str, args: dict) -> Iterator[None]:
    """The span body inside a record_function range (under a
    ``ProfilerStep#<step_num>`` range for a step span) and an NVTX range
    of the span's name."""
    import torch
    with contextlib.ExitStack() as stack:
        if "step_num" in args:
            stack.enter_context(torch.profiler.record_function(
                f"ProfilerStep#{args['step_num']}"))
        stack.enter_context(torch.profiler.record_function(name))
        if _nvtx:
            torch.cuda.nvtx.range_push(name)
            stack.callback(torch.cuda.nvtx.range_pop)
        yield


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
    and strings) go into the event's ``args``. Under device tracing the
    body runs inside ranges of the span's name."""
    if not _active:
        yield 0
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    sid = next(_span_ids)
    parent = stack[-1] if stack else 0
    stack.append(sid)
    ann = _annotated(name, args) if _prof is not None \
        else contextlib.nullcontext()
    t0 = _now_us()
    try:
        with ann:
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
