"""Merged static + dynamic lock-order graph of the port (counterpart of
the root ``tools/lockmap.py``).

The static half is the port analyzer's interprocedural concurrency model
(``difacto_tpu_torch/analysis/concurrency.py``, its race facts from
``analysis/races.py``) over the port's tree: every lock and every
acquisition-order edge the call graph can prove. The dynamic half is an
optional utils/locktrace.py dump (``DIFACTO_LOCKTRACE=1`` with
``DIFACTO_LOCKTRACE_OUT=<path>``, or ``locktrace.dump``): the edges real
executions took. Merging them answers which static edges a run CONFIRMED
(bold in DOT) and which stay predicted-only, and whether an observed edge
is MISSING from the static graph (``dynamic_only``: a call-graph blind
spot).

    python -m difacto_tpu_torch.tools.lockmap [--dynamic trace.json]
        [--dot lockmap.dot] [--json lockmap.json] [--check]
        [--root .] [--paths difacto_tpu_torch chip_smoke.py]

``--check`` exits 1 when the static graph has a cycle or a dynamic edge
escapes it; the default is informational (exit 0).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..analysis import core
from ..analysis.cli import DEFAULT_PATHS
from ..analysis.concurrency import get_model
from ..analysis.races import get_race_model
from ..utils import locktrace


def build(root=".", dynamic_path=None, paths=None):
    """{'locks', 'static_edges', 'dynamic_edges', 'confirmed',
    'dynamic_only', 'guarded_by', 'cycles'} — everything the DOT/JSON
    writers and the gates consume. ``paths`` (default the analyzer's:
    the port and chip_smoke.py) are the trees under ``root`` the static
    half reads."""
    root = Path(root).resolve()
    paths = [p for p in (paths or DEFAULT_PATHS) if (root / p).exists()]
    project = core.Project(root, paths)
    model = get_model(project)
    races = get_race_model(project)
    site2lock = {f"{li.path}:{li.line}": lid
                 for lid, li in model.locks.items()}
    dynamic_edges = {}
    unknown_sites = []
    if dynamic_path:
        data = locktrace.load(dynamic_path)
        for (a, b), n in sorted(data["edges"].items()):
            la, lb = site2lock.get(a), site2lock.get(b)
            if la is None or lb is None:
                unknown_sites.append([a, b])
                continue
            dynamic_edges[(la, lb)] = dynamic_edges.get((la, lb), 0) + n
    static = set(model.edges)
    dynamic = set(dynamic_edges)
    # invert the race pass's GuardedBy facts: lock -> fields it guards,
    # so the lock graph shows WHAT each lock protects, not just its
    # ordering constraints
    guards: dict = {}
    for fid, locks in sorted(races.guarded_by.items()):
        for lk in locks:
            guards.setdefault(lk, []).append(fid)
    return {
        "model": model,
        "locks": model.locks,
        "static_edges": model.edges,
        "dynamic_edges": dynamic_edges,
        "confirmed": sorted(static & dynamic),
        "dynamic_only": sorted(dynamic - static),
        "unknown_sites": unknown_sites,
        "guarded_by": {fid: list(locks)
                       for fid, locks in sorted(
                           races.guarded_by.items())},
        "guards": guards,
        "cycles": model.cycles,
    }


def to_dot(graph) -> str:
    out = ["digraph lockmap {",
           '  rankdir=LR; node [shape=box, fontsize=10];']
    confirmed = set(graph["confirmed"])
    dyn_only = set(graph["dynamic_only"])
    for lid, li in sorted(graph["locks"].items()):
        label = lid.replace("::", "\\n")
        guarded = graph["guards"].get(lid, [])
        if guarded:
            # what the lock protects (race-pass GuardedBy inference)
            shown = [f.rpartition("::")[2] for f in guarded[:6]]
            if len(guarded) > 6:
                shown.append(f"+{len(guarded) - 6} more")
            label += "\\nguards: " + ", ".join(shown)
        out.append(f'  "{lid}" [label="{label}\\n[{li.kind}]"];')
    for (a, b), e in sorted(graph["static_edges"].items()):
        style = ('color=black, penwidth=2.2, label="confirmed"'
                 if (a, b) in confirmed else "color=gray50")
        out.append(f'  "{a}" -> "{b}" [{style}];')
    for (a, b) in sorted(dyn_only):
        out.append(f'  "{a}" -> "{b}" [color=red, style=dashed, '
                   f'label="dynamic only"];')
    out.append("}")
    return "\n".join(out) + "\n"


def to_json(graph) -> dict:
    doc = graph["model"].to_json()
    doc["dynamic_edges"] = [{"src": a, "dst": b, "count": n}
                            for (a, b), n in
                            sorted(graph["dynamic_edges"].items())]
    doc["confirmed"] = [list(e) for e in graph["confirmed"]]
    doc["dynamic_only"] = [list(e) for e in graph["dynamic_only"]]
    doc["unknown_sites"] = graph["unknown_sites"]
    doc["guarded_by"] = graph["guarded_by"]
    doc["guards"] = graph["guards"]
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="lockmap", description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="trees under --root the static half reads "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--dynamic", default=None,
                    help="locktrace JSON dump (DIFACTO_LOCKTRACE_OUT)")
    ap.add_argument("--dot", default=None, help="write DOT here")
    ap.add_argument("--json", default=None, help="write JSON here")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on a static cycle or a dynamic edge "
                         "outside the static graph")
    args = ap.parse_args(argv)
    graph = build(args.root, args.dynamic, args.paths)
    if args.dot:
        Path(args.dot).write_text(to_dot(graph), encoding="utf-8")
        print(f"lockmap: wrote {args.dot}")
    if args.json:
        import json as _json
        Path(args.json).write_text(
            _json.dumps(to_json(graph), indent=1, sort_keys=True) + "\n",
            encoding="utf-8")
        print(f"lockmap: wrote {args.json}")
    n_static = len(graph["static_edges"])
    print(f"lockmap: {len(graph['locks'])} locks, {n_static} static "
          f"edges, {len(graph['dynamic_edges'])} dynamic edges "
          f"({len(graph['confirmed'])} confirmed, "
          f"{len(graph['dynamic_only'])} dynamic-only), "
          f"{len(graph['guarded_by'])} GuardedBy fields, "
          f"{len(graph['cycles'])} cycle(s)")
    for cyc in graph["cycles"]:
        print(f"lockmap: CYCLE {' -> '.join(cyc)} -> {cyc[0]}")
    for a, b in graph["dynamic_only"]:
        print(f"lockmap: DYNAMIC-ONLY {a} -> {b} (static model blind "
              f"spot — fix the callgraph heuristics)")
    if args.check and (graph["cycles"] or graph["dynamic_only"]):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
