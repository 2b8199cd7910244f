"""Observability (counterpart of difacto_tpu/obs): the metric registry
(:mod:`.metrics`), host trace spans (:mod:`.trace`), the Prometheus
renderer and the JSONL flusher of ``metrics_path`` (:mod:`.export`), and
the producer workers' snapshot channel (:mod:`.proc`)."""

from . import trace  # noqa: F401
from .export import (MetricsFlusher, jsonable_snapshot,  # noqa: F401
                     merged_snapshot, render_prometheus)
from .metrics import (DEFAULT_BOUNDS, NOOP, REGISTRY,  # noqa: F401
                      Counter, Gauge, Histogram, Registry, counter,
                      enabled, gauge, hist_quantiles, histogram,
                      merge_into)

__all__ = [
    "REGISTRY", "Registry", "Counter", "Gauge", "Histogram", "NOOP",
    "DEFAULT_BOUNDS", "counter", "gauge", "histogram", "enabled",
    "hist_quantiles", "merge_into", "render_prometheus",
    "merged_snapshot", "jsonable_snapshot", "MetricsFlusher", "trace",
]
