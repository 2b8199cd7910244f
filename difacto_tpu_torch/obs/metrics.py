"""Metric registry: Counters, Gauges, fixed-bucket Histograms
(counterpart of difacto_tpu/obs/metrics.py).

- :class:`Counter` — monotonically increasing, labeled
  (``counter("x_total").labels(stage="pack").inc(dt)``);
- :class:`Gauge` — last-written value;
- :class:`Histogram` — fixed log-spaced buckets with a mergeable
  (counts, sum) form; p50/p95/p99 come from the buckets
  (:func:`hist_quantiles`).

Each labeled series keeps per-thread cells (a thread writes only its own
cell; the series lock is taken once per thread, at cell creation), so
``inc``/``observe`` on the hot path are a ``threading.local`` read and a
float add. ``snapshot()`` sums the cells. Snapshots are picklable dicts
that merge exactly (counters add, histogram buckets add), which is how
producer worker processes report into the learner's registry
(obs/proc.py). ``DIFACTO_OBS=off`` (or 0/false) turns the default
registry into the no-op :data:`NOOP`. Locks come from
``utils/locktrace`` (raw unless ``DIFACTO_LOCKTRACE`` is set).
"""

from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.locktrace import mutex

# label set -> canonical picklable key: sorted ((k, v), ...) string pairs
LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: dict) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _env_enabled() -> bool:
    return os.environ.get("DIFACTO_OBS", "").lower() not in ("off", "0",
                                                             "false")


class _Noop:
    """Shared do-nothing metric handle (the DIFACTO_OBS=off fast path)."""

    __slots__ = ()

    def labels(self, **_kw) -> "_Noop":
        return self

    def inc(self, _v: float = 1.0) -> None:
        pass

    def dec(self, _v: float = 1.0) -> None:
        pass

    def set(self, _v: float) -> None:
        pass

    def observe(self, _v: float) -> None:
        pass

    def value(self, **_kw) -> float:
        return 0.0


NOOP = _Noop()

# default histogram bounds: log-ish spacing from 10us to 100s — wide
# enough for socket latencies, ring waits and device steps alike, small
# enough (26 buckets) that a snapshot stays cheap to merge and render
DEFAULT_BOUNDS: Tuple[float, ...] = tuple(
    b * m for m in (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)
    for b in (1.0, 2.0, 5.0)) + (100.0, 200.0, 500.0, 1000.0, 2000.0)


class _CounterSeries:
    """One labeled counter time series with per-thread cells."""

    __slots__ = ("_local", "_cells", "_mu", "_absorbed")

    def __init__(self) -> None:
        self._local = threading.local()
        self._cells: List[list] = []
        self._mu = mutex()
        self._absorbed = 0.0

    def inc(self, v: float = 1.0) -> None:
        try:
            cell = self._local.cell
        except AttributeError:
            cell = [0.0]
            with self._mu:
                self._cells.append(cell)
            self._local.cell = cell
        cell[0] += v

    def absorb(self, v: float) -> None:
        with self._mu:
            self._absorbed += v

    def value(self) -> float:
        with self._mu:
            return self._absorbed + sum(c[0] for c in self._cells)


class _GaugeSeries:
    """Last-written value; set/inc are locked (gauges are low-rate)."""

    __slots__ = ("_mu", "_v")

    def __init__(self) -> None:
        self._mu = mutex()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._mu:
            self._v = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._mu:
            self._v += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    def value(self) -> float:
        with self._mu:
            return self._v


class _HistSeries:
    """Fixed-bucket histogram series: per-thread cells of
    [bucket counts..., overflow count, value sum]."""

    __slots__ = ("bounds", "_local", "_cells", "_mu", "_absorbed")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self.bounds = bounds
        self._local = threading.local()
        self._cells: List[list] = []
        self._mu = mutex()
        # absorbed child/merged contributions: counts + [sum]
        self._absorbed = [0] * (len(bounds) + 1) + [0.0]

    def observe(self, v: float) -> None:
        try:
            cell = self._local.cell
        except AttributeError:
            cell = [0] * (len(self.bounds) + 1) + [0.0]
            with self._mu:
                self._cells.append(cell)
            self._local.cell = cell
        cell[bisect_left(self.bounds, v)] += 1
        cell[-1] += v

    def absorb(self, counts: Iterable[int], vsum: float) -> None:
        with self._mu:
            for i, c in enumerate(counts):
                self._absorbed[i] += c
            self._absorbed[-1] += vsum

    def data(self) -> dict:
        """{'bounds', 'counts', 'sum', 'count'} — the mergeable form."""
        with self._mu:
            agg = list(self._absorbed)
            for cell in self._cells:
                for i, c in enumerate(cell):
                    agg[i] += c
        counts = [int(c) for c in agg[:-1]]
        return {"bounds": list(self.bounds), "counts": counts,
                "sum": float(agg[-1]), "count": int(sum(counts))}


class _Metric:
    """Labeled metric family: ``labels(**kv)`` resolves (and caches) one
    series; the metric itself doubles as its own unlabeled series."""

    _series_cls: type = _CounterSeries
    kind = "counter"

    def __init__(self, name: str, help: str = "", **series_kw) -> None:
        self.name = name
        self.help = help
        self._series_kw = series_kw
        self._mu = mutex()
        self._series: Dict[LabelsKey, object] = {}

    def labels(self, **labels):
        key = _labels_key(labels)
        s = self._series.get(key)
        if s is None:
            with self._mu:
                s = self._series.setdefault(
                    key, self._series_cls(**self._series_kw))
        return s

    # unlabeled convenience: metric(...).inc(...) etc.
    def inc(self, v: float = 1.0) -> None:
        self.labels().inc(v)

    def value(self, **labels) -> float:
        key = _labels_key(labels)
        s = self._series.get(key)
        return s.value() if s is not None else 0.0

    def series(self) -> Dict[LabelsKey, object]:
        with self._mu:
            return dict(self._series)


class Counter(_Metric):
    pass


class Gauge(_Metric):
    _series_cls = _GaugeSeries
    kind = "gauge"

    def set(self, v: float) -> None:
        self.labels().set(v)

    def dec(self, v: float = 1.0) -> None:
        self.labels().dec(v)


class Histogram(_Metric):
    _series_cls = _HistSeries
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 bounds: Optional[Tuple[float, ...]] = None) -> None:
        super().__init__(name, help,
                         bounds=tuple(bounds or DEFAULT_BOUNDS))

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def data(self, **labels) -> Optional[dict]:
        key = _labels_key(labels)
        s = self._series.get(key)
        return s.data() if s is not None else None


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """A namespace of metrics plus attached child-process snapshots.

    ``snapshot()`` returns a picklable, mergeable dict; ``set_child``
    attaches a child process's LATEST full snapshot under a key (the
    child re-publishes cumulative totals, so storing the newest one —
    rather than summing deltas — keeps cross-process counters exact even
    when publishes are lost); ``fold_children`` retires finished
    children by absorbing their final snapshot into the base series.
    """

    def __init__(self, enabled: Optional[bool] = None) -> None:
        self.enabled = _env_enabled() if enabled is None else enabled
        self._mu = mutex()
        self._metrics: Dict[str, _Metric] = {}
        self._children: Dict[object, dict] = {}

    # -------------------------------------------------------- factories
    def _get(self, cls: type, name: str, help: str, **kw):
        if not self.enabled:
            return NOOP
        m = self._metrics.get(name)
        if m is None:
            with self._mu:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {type(m).__name__}, "
                            f"not a {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(Histogram, name, help, bounds=bounds)

    # --------------------------------------------------------- children
    def set_child(self, key, snap: dict) -> None:
        with self._mu:
            self._children[key] = snap

    def fold_children(self, prefix=None) -> None:
        """Absorb finished children's snapshots into the base series (so
        their totals survive the child record being dropped). ``prefix``
        limits the fold to keys that are tuples starting with it."""
        with self._mu:
            keys = [k for k in self._children
                    if prefix is None
                    or (isinstance(k, tuple) and k[:len(prefix)] == prefix)]
            snaps = [self._children.pop(k) for k in keys]
        for snap in snaps:
            self.merge(snap)

    # --------------------------------------------------------- snapshot
    def _base_snapshot(self) -> dict:
        out: dict = {"counters": {}, "gauges": {}, "hists": {},
                     "help": {}}
        with self._mu:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.help:
                out["help"][m.name] = m.help
            if isinstance(m, Histogram):
                out["hists"][m.name] = {
                    k: s.data() for k, s in m.series().items()}
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = {
                    k: s.value() for k, s in m.series().items()}
            else:
                out["counters"][m.name] = {
                    k: s.value() for k, s in m.series().items()}
        return out

    def snapshot(self) -> dict:
        """Mergeable picklable view: base series plus every attached
        child snapshot."""
        snap = self._base_snapshot()
        with self._mu:
            children = list(self._children.values())
        for c in children:
            merge_into(snap, c)
        return snap

    def merge(self, snap: dict) -> None:
        """Fold an external snapshot into the base series permanently
        (counters/histograms add; gauges keep the larger value)."""
        if not self.enabled or not snap:
            return
        for name, series in snap.get("counters", {}).items():
            c = self.counter(name, snap.get("help", {}).get(name, ""))
            for key, v in series.items():
                c.labels(**dict(key)).absorb(v)
        for name, series in snap.get("gauges", {}).items():
            g = self.gauge(name, snap.get("help", {}).get(name, ""))
            for key, v in series.items():
                s = g.labels(**dict(key))
                s.set(max(s.value(), v))
        for name, series in snap.get("hists", {}).items():
            for key, d in series.items():
                h = self._get(Histogram, name,
                              snap.get("help", {}).get(name, ""),
                              bounds=tuple(d["bounds"]))
                h.labels(**dict(key)).absorb(d["counts"], d["sum"])

    def value(self, name: str, **labels) -> float:
        m = self._metrics.get(name)
        return m.value(**labels) if m is not None else 0.0


def merge_into(dst: dict, src: dict) -> dict:
    """Merge snapshot ``src`` into ``dst`` in place (and return it).
    Counters add; gauges keep the max; histogram buckets add
    element-wise (bounds must agree — one definition per metric name)."""
    for name, series in src.get("counters", {}).items():
        d = dst.setdefault("counters", {}).setdefault(name, {})
        for key, v in series.items():
            d[key] = d.get(key, 0.0) + v
    for name, series in src.get("gauges", {}).items():
        d = dst.setdefault("gauges", {}).setdefault(name, {})
        for key, v in series.items():
            d[key] = max(d.get(key, v), v)
    for name, series in src.get("hists", {}).items():
        d = dst.setdefault("hists", {}).setdefault(name, {})
        for key, h in series.items():
            if key not in d:
                d[key] = {"bounds": list(h["bounds"]),
                          "counts": list(h["counts"]),
                          "sum": h["sum"], "count": h["count"]}
                continue
            cur = d[key]
            if list(cur["bounds"]) != list(h["bounds"]):
                raise ValueError(
                    f"histogram {name!r} bucket bounds diverge across "
                    "snapshots — one bounds definition per metric name")
            cur["counts"] = [a + b for a, b in zip(cur["counts"],
                                                   h["counts"])]
            cur["sum"] += h["sum"]
            cur["count"] += h["count"]
    for name, h in src.get("help", {}).items():
        dst.setdefault("help", {}).setdefault(name, h)
    return dst


def hist_quantiles(data: dict, qs=(0.5, 0.95, 0.99)) -> Dict[float, float]:
    """Quantiles from a histogram's (bounds, counts): find the bucket the
    rank lands in, interpolate linearly inside it. The overflow bucket
    reports its lower edge (the honest bound we have). Empty -> 0.0."""
    bounds, counts = data["bounds"], data["counts"]
    total = sum(counts)
    out = {}
    for q in qs:
        if total == 0:
            out[q] = 0.0
            continue
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = bounds[i - 1] if i > 0 else 0.0
                hi = bounds[i] if i < len(bounds) else bounds[-1]
                frac = (rank - cum) / c
                out[q] = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                break
            cum += c
        else:  # pragma: no cover - rank <= total always lands
            out[q] = bounds[-1]
    return out


# the process-wide default registry (DIFACTO_OBS=off makes it no-op)
REGISTRY = Registry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              bounds: Optional[Tuple[float, ...]] = None) -> Histogram:
    return REGISTRY.histogram(name, help, bounds)


def enabled() -> bool:
    return REGISTRY.enabled
