"""Child-process metric aggregation (counterpart of
difacto_tpu/obs/proc.py): the snapshot channel through which producer
worker processes report into the learner's registry.

A spawned worker instruments against its own process-global registry,
which starts at zero, so its snapshot is its contribution.
:func:`publish_blob` packs that cumulative snapshot plus the trace spans
collected since the last publish; the pool puts it on the worker's
result queue after each part and at exit, and :func:`absorb_blob`
attaches it in the parent, keeping only the newest per child (a lost or
reordered publish leaves the view stale, never double-counted). At
shutdown the pool folds the children into the base series
(``Registry.fold_children``), so totals accumulate across epochs.
"""

from __future__ import annotations

from .metrics import REGISTRY, Registry

# env marker the pool sets for its workers: obs runs in collect-only mode
# (trace events ship via the queue; no atexit trace-file write)
CHILD_ENV = "DIFACTO_OBS_CHILD"


def publish_blob() -> dict:
    """The worker side: this process's cumulative registry snapshot plus
    the trace events collected since the last publish."""
    from . import trace
    return {"snap": REGISTRY.snapshot() if REGISTRY.enabled else {},
            "events": trace.drain_events()}


def absorb_blob(registry: Registry, key, blob: dict) -> None:
    """The parent side: replace the child's attached snapshot with the
    newer one and merge its trace events into the local sink."""
    snap = blob.get("snap")
    if snap:
        registry.set_child(key, snap)
    from . import trace
    trace.add_events(blob.get("events") or [])
