"""Render a human summary from the port's obs artifacts (counterpart of
the root ``tools/obs_report.py``, whose flags and text it keeps byte for
byte).

Inputs are what the observability subsystem writes during a run:

- a metrics JSONL event log (``metrics_path`` training knob, or any
  file of ``{"ts", "metrics"}`` lines from obs/export.MetricsFlusher) —
  the LAST line is the run's final cumulative snapshot;
- optionally a Chrome trace JSON (``DIFACTO_TRACE=<path>``).

Output: the streamed-stage table (where the run's seconds went), every
histogram's count/mean/p50/p95/p99 (the port's obs.hist_quantiles),
top counters, and the top span names by total duration — the first
thing to read when a streamed rate regresses or a serve replica's
latency moves.

    python -m difacto_tpu_torch.tools.obs_report \
        --metrics run.metrics.jsonl --trace run.trace.json
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

STAGE_ORDER = ("parse", "pack", "ring_wait", "transfer", "step")


def load_last_snapshot(path: str) -> dict:
    """Last parseable line of the JSONL log (a torn final line — crash
    mid-flush — is skipped, the previous flush wins). Reads the rolled
    file ``<path>.1`` first when present (MetricsFlusher ``max_mb``
    rotation): snapshots are cumulative, so the newest line across both
    files — the live file's, unless it is fresh-empty right after a
    roll — is the run's state."""
    import os
    last = None
    for p in (path + ".1", path):
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    last = json.loads(line)
                except ValueError:
                    continue
    if last is None:
        raise SystemExit(f"no parseable JSONL lines in {path}"
                         f" (or {path}.1)")
    return last.get("metrics", last)


def fmt_seconds(v: float) -> str:
    if v >= 1.0:
        return f"{v:8.2f}s"
    return f"{v * 1e3:7.2f}ms"


def report_stages(snap: dict) -> None:
    series = snap.get("counters", {}).get("stage_seconds_total", {})
    if not series:
        return
    vals = {}
    for key, v in series.items():
        # flattened label key: "stage=pack" (export.jsonable_snapshot)
        stage = dict(p.split("=", 1) for p in key.split(",")
                     if "=" in p).get("stage", key)
        vals[stage] = vals.get(stage, 0.0) + v
    total = sum(vals.values()) or 1.0
    print("== streamed stage table (seconds, % of accounted time) ==")
    for stage in STAGE_ORDER + tuple(sorted(set(vals) - set(STAGE_ORDER))):
        if stage in vals:
            v = vals[stage]
            print(f"  {stage:10s} {v:10.3f}s  {100 * v / total:5.1f}%")
    print()


def _quantiles(d: dict, qs=(0.5, 0.95, 0.99)) -> dict:
    from ..obs.metrics import hist_quantiles
    return hist_quantiles(d, qs)


def report_hists(snap: dict) -> None:
    hists = snap.get("hists", {})
    if not hists:
        return
    print("== histograms (count / mean / p50 / p95 / p99) ==")
    for name in sorted(hists):
        for key, d in sorted(hists[name].items()):
            label = f"{name}{{{key}}}" if key else name
            n = d.get("count", 0)
            if not n:
                continue
            q = _quantiles(d)
            mean = d.get("sum", 0.0) / n
            print(f"  {label:44s} n={n:<9d} mean={fmt_seconds(mean)} "
                  f"p50={fmt_seconds(q[0.5])} p95={fmt_seconds(q[0.95])} "
                  f"p99={fmt_seconds(q[0.99])}")
    print()


def report_gauges(snap: dict) -> None:
    """Instantaneous state at the final flush — in particular the
    online-loop freshness SLO trio (train_behind_serve_s,
    online_rows_behind, serve_generation_age_s; docs/serving.md
    "Continuous learning")."""
    rows = []
    for name, series in snap.get("gauges", {}).items():
        for key, v in series.items():
            rows.append((f"{name}{{{key}}}" if key else name, v))
    if not rows:
        return
    print("== gauges (at last flush) ==")
    for label, v in sorted(rows):
        print(f"  {label:54s} {v:g}")
    print()


def report_fleet(snap: dict) -> None:
    """Fleet-elasticity digest (docs/observability.md): the autoscaler's
    decisions (``autoscale_*``) and the router group's supervision
    (``router_group_*``) in one block, so a chaos/diurnal run's capacity
    story reads without hunting through the counter table."""
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})

    def _total(section, name):
        series = section.get(name)
        if not series:
            return None
        return sum(series.values())

    rows = []
    for name in ("autoscale_spawns_total", "autoscale_drains_total",
                 "autoscale_aborts_total",
                 "router_group_relaunches_total"):
        v = _total(counters, name)
        if v is not None:
            rows.append((name, v))
    for name in ("autoscale_replicas", "router_group_size",
                 "autoscale_queue_frac", "autoscale_shed_rate",
                 "router_affinity_hit_rate"):
        v = _total(gauges, name)
        if v is not None:
            rows.append((name, v))
    if not rows:
        return
    print("== fleet elasticity (autoscaler + router group) ==")
    for label, v in rows:
        print(f"  {label:54s} {v:g}")
    print()


def report_capacity(snap: dict) -> None:
    """Table-capacity digest (docs/observability.md): the cold tier's
    residency traffic (``store_tier_*``), admission drops, occupancy
    eviction and the per-shard occupancy gauges in one block, plus the
    derived tier hit-rate — the first read when judging whether
    ``cold_tier_rows`` / ``admit_min_count`` are sized right for the
    key skew (docs/perf_notes.md "Table capacity")."""
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})

    def _total(section, name):
        series = section.get(name)
        if not series:
            return None
        return sum(series.values())

    rows = []
    for name in ("store_tier_hits_total", "store_tier_misses_total",
                 "store_tier_promotes_total", "store_tier_demotes_total",
                 "store_evictions_total", "store_admit_drops_total"):
        v = _total(counters, name)
        if v is not None:
            rows.append((name, v))
    hits = _total(counters, "store_tier_hits_total")
    misses = _total(counters, "store_tier_misses_total")
    if hits is not None and misses is not None and hits + misses > 0:
        rows.append(("tier_hit_rate (derived)", hits / (hits + misses)))
    for name in ("store_shard_rows", "store_shard_occupancy"):
        series = gauges.get(name, {})
        for key, v in sorted(series.items()):
            rows.append((f"{name}{{{key}}}" if key else name, v))
    if not rows:
        return
    print("== table capacity (cold tier + admission + occupancy) ==")
    for label, v in rows:
        print(f"  {label:54s} {v:g}")
    print()


def report_durability(snap: dict) -> None:
    """Durability digest (docs/observability.md): the write-ahead
    delta log's volume and recovery yield (``wal_*``), replica push
    health and per-peer staleness (``replica_*``), and which recovery
    rungs resumes actually climbed (``recovery_rung_total{rung}``) —
    the first read after a chaos run or a real host loss
    (docs/serving.md "Durability & recovery")."""
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})

    def _total(section, name):
        series = section.get(name)
        if not series:
            return None
        return sum(series.values())

    rows = []
    for name in ("wal_bytes_total", "wal_append_failures_total",
                 "wal_replay_batches",
                 "replica_push_failures_total",
                 "replica_fetch_failures_total",
                 "replica_scrub_repairs_total"):
        v = _total(counters, name)
        if v is not None:
            rows.append((name, v))
    for name in ("wal_replay_dropped_total", "recovery_rung_total"):
        series = counters.get(name, {})
        for key, v in sorted(series.items()):
            rows.append((f"{name}{{{key}}}" if key else name, v))
    series = gauges.get("replica_lag_generations", {})
    for key, v in sorted(series.items()):
        rows.append((f"replica_lag_generations{{{key}}}" if key
                     else "replica_lag_generations", v))
    if not rows:
        return
    print("== durability (WAL + replicas + recovery ladder) ==")
    for label, v in rows:
        print(f"  {label:54s} {v:g}")
    print()


def report_counters(snap: dict, top: int = 20) -> None:
    rows = []
    for name, series in snap.get("counters", {}).items():
        if name == "stage_seconds_total":
            continue  # already in the stage table
        for key, v in series.items():
            rows.append((v, f"{name}{{{key}}}" if key else name))
    if not rows:
        return
    print(f"== top counters ==")
    for v, label in sorted(rows, reverse=True)[:top]:
        print(f"  {label:54s} {v:g}")
    print()


def report_trace(path: str, top: int = 15) -> None:
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    total = defaultdict(float)
    count = defaultdict(int)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        total[ev["name"]] += ev.get("dur", 0.0)
        count[ev["name"]] += 1
    if not total:
        return
    print(f"== top spans by total duration ({len(events)} events; "
          "open the file in ui.perfetto.dev for the timeline) ==")
    for name, us in sorted(total.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {name:34s} {us / 1e6:10.3f}s  x{count[name]:<8d} "
              f"avg {fmt_seconds(us / count[name] / 1e6)}")
    print()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--metrics", default="",
                    help="metrics JSONL event log (metrics_path knob)")
    ap.add_argument("--trace", default="",
                    help="Chrome trace JSON (DIFACTO_TRACE)")
    ap.add_argument("--top", type=int, default=20,
                    help="rows per top-N section")
    args = ap.parse_args(argv)
    if not args.metrics and not args.trace:
        ap.error("pass --metrics and/or --trace")
    if args.metrics:
        snap = load_last_snapshot(args.metrics)
        report_stages(snap)
        report_hists(snap)
        report_fleet(snap)
        report_capacity(snap)
        report_durability(snap)
        report_gauges(snap)
        report_counters(snap, args.top)
    if args.trace:
        report_trace(args.trace, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
