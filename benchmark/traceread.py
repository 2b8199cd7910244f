"""Reads a torch.profiler trace of the traced window: the device's busy
intervals and their union, each device operation attributed to the
benchmark span that launched it (through the launch's correlation id),
and the idle gaps named by the span the host was in when each began."""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, NamedTuple, Optional, Tuple

from .program import SPAN_WINDOW

SPAN_PREFIX = "bench."


class Event(NamedTuple):
    name: str
    on_device: bool
    start: int          # ns, the trace's clock
    end: int
    corr: int


def read_events(prof) -> List[Event]:
    """The trace's events as plain tuples: device operations (kernels,
    copies, fills; not the profiler's annotation ranges), the benchmark's
    spans and the host's launch calls."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == DeviceType.CUDA
        name = e.name()
        if on_dev and e.is_user_annotation():
            continue
        if not on_dev and not (name.startswith(SPAN_PREFIX)
                               or name.startswith("cu")):
            continue
        start = e.start_ns()
        out.append(Event(name, on_dev, start, start + e.duration_ns(),
                         e.correlation_id()))
    return out


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted intervals."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Spans:
    """The benchmark's spans of one name, sorted, for point lookups."""

    def __init__(self, events: List[Event], name: str):
        iv = sorted((e.start, e.end) for e in events
                    if not e.on_device and e.name == name)
        self.starts = [a for a, _ in iv]
        self.iv = iv

    def contains(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.iv[i][0] <= t <= self.iv[i][1]


def analyze(events: List[Event], kernel_spans: Dict[str, str],
            host_spans: List[str]) -> Optional[dict]:
    """The traced window's readings, or None when the trace holds no
    device operation. ``kernel_spans`` maps a label to the span around a
    kernel entry: the device time of what each entry launched, found
    through the launch's correlation id, is summed under its label, and a
    label none is found for is left out. ``host_spans`` name the idle
    gaps, innermost first."""
    win = [e for e in events if not e.on_device and e.name == SPAN_WINDOW]
    dev = [e for e in events if e.on_device]
    if not win or not dev:
        return None
    w0, w1 = win[0].start, win[0].end
    dev = [e for e in dev if e.end > w0 and e.start < w1]
    if not dev:
        return None
    busy = union([(max(e.start, w0), min(e.end, w1)) for e in dev])
    busy_ns = sum(b - a for a, b in busy)
    # the launch call of each device operation, by correlation id
    launch = {e.corr: e.start for e in events
              if not e.on_device and e.name.startswith("cu")}
    entry = {label: Spans(events, span)
             for label, span in kernel_spans.items()}
    by_entry = collections.Counter()
    by_name = collections.Counter()
    for e in dev:
        d = e.end - e.start
        by_name[e.name] += d
        t = launch.get(e.corr)
        if t is None:
            continue
        for label, sp in entry.items():
            if sp.contains(t):
                by_entry[label] += d
                break
    host = [(n, Spans(events, n)) for n in host_spans]
    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        name = next((n for n, sp in host if sp.contains(a)),
                    "outside the benchmark's spans")
        gaps["host in " + name] += b - a
    top = by_name.most_common(10)
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "device_s": sum(by_name.values()) / 1e9,
            "entry_s": {k: v / 1e9 for k, v in by_entry.items()},
            "device_ops": [[n[:120], v / 1e9] for n, v in top],
            "idle_gaps": [[n, v / 1e9] for n, v in gaps.most_common(10)]}
