"""The replayed step by the port's own spans (``difacto_tpu_torch``'s
obs/trace.py, which enter ``record_function`` ranges under any running
profiler): each step phase's device time, the epoch-end evaluations,
the device operations launched per step, the host's wait in the metric
fetches, and the idle gaps by the port span the host was in.

    python3 benchmark/phases.py --workload <cell> --seed <n> \
        --seconds <s>

runs the cell as ``run.py --trace 1`` does, its traced epochs with the
port's span events kept beside the benchmark's and the benchmark's
counting calls inside a ``bench.count`` range, and prints run.py's
result line with a ``phases`` object added: the readings below, or null
for a program without the spans. The per-layer metrics read from the
benchmark's own events as in run.py; the readers here take the same
``traceread.Event`` tuples.

A device operation belongs to the innermost span its launch (the
runtime call of the same correlation id) lies in; the benchmark's
counting operations (``bench.count``) belong to no phase and are not
counted as launches.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

if __package__ in (None, ""):
    # run as a script: import the benchmark as a package from the root
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness, program, run, traceread  # noqa: E402
from benchmark.traceread import Event  # noqa: E402

SPAN_COUNT = "bench.count"
PHASES = ("step.pull", "step.forward", "step.backward", "step.push")
KERNELS = ("kernels.gather", "kernels.push")
EVALUATIONS = ("learner.evaluate", "learner.report")
# every port span of the replayed epoch, and the benchmark's counting
PORT_SPANS = (("learner.dispatch", "learner.fetch", "learner.epoch_end",
               "step.count", "epoch", "consumer.dispatch")
              + PHASES + KERNELS + EVALUATIONS)
OWNERS = PORT_SPANS + (SPAN_COUNT,)


def read_events(prof) -> List[Event]:
    """The trace's device operations, the host's launch calls, and the
    ranges of the port's spans and the benchmark's."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == DeviceType.CUDA
        name = e.name()
        if on_dev and e.is_user_annotation():
            continue
        if not on_dev and not (name in OWNERS or name.startswith("bench.")
                               or name.startswith("cu")):
            continue
        start = e.start_ns()
        out.append(Event(name, on_dev, start, start + e.duration_ns(),
                         e.correlation_id()))
    return out


class Owners:
    """The named spans of a trace, for the innermost one holding a
    point in time."""

    def __init__(self, events: List[Event], names=OWNERS):
        self.spans = {n: traceread.Spans(events, n) for n in names}

    def innermost(self, t: int) -> Optional[str]:
        best, since = None, None
        for name, sp in self.spans.items():
            i = bisect.bisect_right(sp.starts, t) - 1
            if i < 0:
                continue
            a, b = sp.iv[i]
            if t <= b and (since is None or a > since):
                best, since = name, a
        return best


def attribute(events: List[Event]) -> Optional[dict]:
    """Device time (ns) and operations by the innermost span of their
    launch, over the benchmark's window (``None`` without one); an
    operation no launch links to, or launched in no span, is under
    ``None``. ``dispatch_ops`` counts the operations launched inside
    ``learner.dispatch`` at any depth, the benchmark's counting ones
    left out."""
    win = [e for e in events
           if not e.on_device and e.name == program.SPAN_WINDOW]
    if not win:
        return None
    w0, w1 = win[0].start, win[0].end
    owners = Owners(events)
    dispatch = owners.spans["learner.dispatch"]
    launch = {e.corr: e.start for e in events
              if not e.on_device and e.name.startswith("cu")}
    ns: Dict[Optional[str], int] = collections.Counter()
    ops: Dict[Optional[str], int] = collections.Counter()
    dispatch_ops = 0
    for e in events:
        if not e.on_device or e.end <= w0 or e.start >= w1:
            continue
        t = launch.get(e.corr)
        owner = None if t is None else owners.innermost(t)
        ns[owner] += e.end - e.start
        ops[owner] += 1
        if owner != SPAN_COUNT and t is not None and dispatch.contains(t):
            dispatch_ops += 1
    gaps = _idle_gaps(events, owners, w0, w1)
    return {"ns": dict(ns), "ops": dict(ops), "dispatch_ops": dispatch_ops,
            "idle_gaps": gaps}


def _idle_gaps(events, owners: Owners, w0: int, w1: int) -> dict:
    """The window's idle gaps (ns) by the innermost span the host was in
    when each began (``None``: in none)."""
    busy = traceread.union([(max(e.start, w0), min(e.end, w1))
                            for e in events if e.on_device
                            and e.end > w0 and e.start < w1])
    gaps: Dict[Optional[str], int] = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps[owners.innermost(a)] += b - a
    return dict(gaps)


def readings(att: Optional[dict], steps: int, epochs: int,
             step_device_ms: Optional[float] = None,
             fetch: Optional[dict] = None) -> Optional[dict]:
    """The phase readings of one traced run: per step (ms) the device
    time of each phase, the kernel entries, the count push, the metric
    fetches and the benchmark's counting; per epoch (ms) the
    evaluations'; launches per step; with ``fetch`` (the
    ``train_fetch_seconds`` series over the traced epochs, seconds and
    count a site) the host's wait in them per step; with
    ``step_device_ms`` (the benchmark's reading of the same trace) the
    share of it the owned device time accounts for. ``None`` when the
    trace holds no port span."""
    if att is None or steps <= 0 or epochs <= 0:
        return None
    ns = att["ns"]
    if not any(ns.get(p) for p in PHASES):
        return None

    def per_step(*names):
        return sum(ns.get(n, 0) for n in names) / 1e6 / steps

    out = {f"{p.split('.')[1]}_device_ms": per_step(p) for p in PHASES}
    out.update({
        "kernels_device_ms": per_step(*KERNELS),
        "count_device_ms": per_step("step.count"),
        "dispatch_other_device_ms": per_step("learner.dispatch"),
        "fetch_device_ms": per_step("learner.fetch"),
        "bench_count_device_ms": per_step(SPAN_COUNT),
        "evaluate_device_ms_per_epoch":
            sum(ns.get(n, 0) for n in EVALUATIONS) / 1e6 / epochs,
        "unowned_device_ms": sum(v for k, v in ns.items()
                                 if k not in OWNERS) / 1e6 / steps,
        "launches_per_step": att["dispatch_ops"] / steps,
    })
    if step_device_ms:
        owned = (sum(out[f"{p.split('.')[1]}_device_ms"] for p in PHASES)
                 + out["count_device_ms"] + out["fetch_device_ms"]
                 + out["bench_count_device_ms"]
                 + out["evaluate_device_ms_per_epoch"] * epochs / steps)
        out["step_device_ms"] = step_device_ms
        out["accounted_share"] = 100.0 * owned / step_device_ms
    if fetch:
        for site, (s, _n) in fetch.items():
            out[f"fetch_ms.{site}"] = 1e3 * s / steps
    gaps = att["idle_gaps"]
    total = sum(gaps.values())
    out["idle_gaps_s"] = sorted(
        ([n or "outside the port's spans", v / 1e9]
         for n, v in gaps.items()), key=lambda x: -x[1])
    out["idle_unowned_share"] = (100.0 * gaps.get(None, 0) / total
                                 if total else 0.0)
    return out


def _fetch_series(learner) -> Dict[str, tuple]:
    """(seconds, count) of each site of ``train_fetch_seconds``; empty
    for a program without it."""
    series = learner.obs.snapshot().get("hists", {}).get(
        "train_fetch_seconds", {})
    return {dict(k).get("site", ""): (d["sum"], sum(d["counts"]))
            for k, d in series.items()}


def _counted(fn):
    """``fn`` inside the ``bench.count`` range: the benchmark's counting
    wrapper with what it wraps, whose own spans lie deeper."""
    from torch.profiler import record_function

    def inner(*a, **kw):
        with record_function(SPAN_COUNT):
            return fn(*a, **kw)
    return inner


class PortTracer(program.Tracer):
    """The benchmark's tracer, with the port's span events kept and the
    counting wrappers of the kernel entries inside ``bench.count``."""

    last: Optional["PortTracer"] = None

    def start(self) -> "PortTracer":
        super().start()
        from difacto_tpu_torch.ops import fused
        for name in ("gather_rows", "fm_update_rows"):
            fn = getattr(fused, name)
            self._stack.callback(setattr, fused, name, fn)
            setattr(fused, name, _counted(fn))
        self._fetch0 = _fetch_series(self.learner)
        PortTracer.last = self
        return self

    def stop(self, epochs: int, steps: int) -> None:
        fetch1 = _fetch_series(self.learner)
        super().stop(epochs, steps)
        self.port_events = read_events(self._prof)
        self.fetch = {k: (s - self._fetch0.get(k, (0.0, 0))[0],
                          n - self._fetch0.get(k, (0.0, 0))[1])
                      for k, (s, n) in fetch1.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    program.Tracer = PortTracer
    result = run.run_cell(cell, args.seed, args.seconds, True, "cuda")
    tr = PortTracer.last
    t = tr.result
    result["traced"] = {"epochs": t["epochs"], "steps": t["steps"],
                        "wall_s": t["wall_s"]}
    step_ms = result["metrics"].get("step_device_ms.replay", {})
    result["phases"] = readings(attribute(tr.port_events), t["steps"],
                                t["epochs"], step_ms.get("value"),
                                tr.fetch)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
