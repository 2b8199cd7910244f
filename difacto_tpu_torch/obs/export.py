"""Exporters (counterpart of difacto_tpu/obs/export.py): the Prometheus
text renderer and :class:`MetricsFlusher`, which appends one JSON
snapshot of the registries to a JSONL file every interval (the
``metrics_path`` / ``metrics_interval_s`` / ``metrics_max_mb`` training
knobs), flushes once more at ``close()``, and rolls the file to
``<path>.1`` before a write would pass ``max_mb``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional, Sequence

from .metrics import Registry, hist_quantiles, merge_into

_QS = (0.5, 0.95, 0.99)


def merged_snapshot(registries: Sequence[Registry]) -> dict:
    out: dict = {}
    for r in registries:
        merge_into(out, r.snapshot())
    return out


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_labels(key) -> str:
    if not key:
        return ""
    inner = ",".join(
        f'{_prom_name(k)}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in key)
    return "{" + inner + "}"


def _with_label(key, k: str, v) -> str:
    return _prom_labels(tuple(key) + ((k, str(v)),))


def render_prometheus(snap: dict, namespace: str = "difacto") -> str:
    """Prometheus text format for a (merged) snapshot. Histograms emit
    the standard ``_bucket``/``_sum``/``_count`` triple PLUS derived
    ``<name>_quantile{quantile="0.5|0.95|0.99"}`` gauge lines, so a
    human (or the ``#metrics`` caller) reads p50/p95/p99 directly."""
    lines: List[str] = []
    help_ = snap.get("help", {})
    ns = namespace + "_" if namespace else ""

    def head(name: str, kind: str) -> str:
        full = ns + _prom_name(name)
        if name in help_:
            lines.append(f"# HELP {full} {help_[name]}")
        lines.append(f"# TYPE {full} {kind}")
        return full

    for name in sorted(snap.get("counters", {})):
        full = head(name, "counter")
        for key, v in sorted(snap["counters"][name].items()):
            lines.append(f"{full}{_prom_labels(key)} {v:g}")
    for name in sorted(snap.get("gauges", {})):
        full = head(name, "gauge")
        for key, v in sorted(snap["gauges"][name].items()):
            lines.append(f"{full}{_prom_labels(key)} {v:g}")
    for name in sorted(snap.get("hists", {})):
        full = head(name, "histogram")
        series = snap["hists"][name]
        for key, d in sorted(series.items()):
            cum = 0
            for b, c in zip(d["bounds"], d["counts"]):
                cum += c
                lines.append(
                    f"{full}_bucket{_with_label(key, 'le', f'{b:g}')} {cum}")
            lines.append(
                f"{full}_bucket{_with_label(key, 'le', '+Inf')} {d['count']}")
            lines.append(f"{full}_sum{_prom_labels(key)} {d['sum']:g}")
            lines.append(f"{full}_count{_prom_labels(key)} {d['count']}")
        qfull = full + "_quantile"
        lines.append(f"# TYPE {qfull} gauge")
        for key, d in sorted(series.items()):
            for q, v in hist_quantiles(d, _QS).items():
                lines.append(
                    f"{qfull}{_with_label(key, 'quantile', f'{q:g}')} {v:g}")
    return "\n".join(lines) + "\n"


def jsonable_snapshot(snap: dict) -> dict:
    """Snapshot with label-tuple keys flattened to ``k=v,k2=v2`` strings
    (JSON objects cannot key on tuples); '' is the unlabeled series."""

    def flat(key) -> str:
        return ",".join(f"{k}={v}" for k, v in key)

    out: dict = {"help": dict(snap.get("help", {}))}
    for kind in ("counters", "gauges", "hists"):
        out[kind] = {name: {flat(k): v for k, v in series.items()}
                     for name, series in snap.get(kind, {}).items()}
    return out


class MetricsFlusher:
    """Background thread appending merged registry snapshots to a JSONL
    file every ``interval_s`` (plus a final flush on close). Each line is
    ``{"ts": <epoch seconds>, "metrics": <jsonable snapshot>}`` —
    append-only, crash-tolerant (a torn last line is skipped by readers),
    and diffable across flushes. ``trace_path`` additionally saves the
    collected span events as Chrome trace JSON on close.

    ``max_mb`` > 0 caps the file: when the next flush would push it past
    the cap, the current file rolls to ``<path>.1`` (replacing any
    previous roll) and a fresh file starts — a weeks-long serve process
    holds at most ~2x ``max_mb`` of metrics log instead of growing
    without bound. Readers (tools/obs_report.py) look at the rolled file
    too, so history survives one rotation."""

    def __init__(self, path: str, interval_s: float = 30.0,
                 registries: Optional[Sequence[Registry]] = None,
                 trace_path: str = "", max_mb: float = 0.0) -> None:
        from .metrics import REGISTRY
        self.path = path
        self.interval_s = max(interval_s, 0.1)
        self.registries = list(registries) if registries else [REGISTRY]
        self.trace_path = trace_path
        self.max_mb = max_mb
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsFlusher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="obs-flush", daemon=True)
            self._thread.start()
        return self

    def flush(self) -> None:
        # lint: ok(wall-clock) timestamp-of-record on each JSONL line
        line = json.dumps({"ts": time.time(),
                           "metrics": jsonable_snapshot(
                               merged_snapshot(self.registries))})
        import os
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        if self.max_mb > 0:
            try:
                # roll BEFORE the write that would breach the cap, so
                # the live file never exceeds max_mb; os.replace is
                # atomic — a reader sees the old or the new roll, never
                # a half file
                if (os.path.exists(self.path)
                        and os.path.getsize(self.path) + len(line) + 1
                        > self.max_mb * (1 << 20)):
                    os.replace(self.path, self.path + ".1")
            except OSError:  # pragma: no cover - rotation must not crash
                pass
        with open(self.path, "a") as f:
            f.write(line + "\n")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        try:
            self.flush()
        except OSError:  # pragma: no cover - flusher must never crash a run
            pass
        if self.trace_path:
            from . import trace
            trace.save(self.trace_path)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.flush()
            except OSError:  # pragma: no cover
                pass
