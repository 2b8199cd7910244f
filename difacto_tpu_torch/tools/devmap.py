"""Merged static + dynamic map of the port's traced programs, kernels,
declared copies and CUDA syncs (counterpart of the root
``tools/jitmap.py``).

The static half is the port analyzer's traced-program model
(``difacto_tpu_torch/analysis/torchflow.py``): every ``devtrace.traced``
creation site (a call, or an ``@devtrace.traced`` method) with its call
sites and whether every static and shape reaching it is bounded, every
``devtrace.kernel`` site, every ``devtrace.fetch`` / ``devtrace.to_device``
call site with its ``point=`` name, and the hot set. The dynamic half is
a utils/devtrace.py dump (``DIFACTO_JAXTRACE=1`` with
``DIFACTO_JAXTRACE_OUT=<path>``, or ``devtrace.dump``). Both key sites by
the same ``relpath:lineno``, so merging answers which programs a run
exercised with how many signatures, whether a site or a copy happened
outside the model, and where the run synced undeclared.

    python -m difacto_tpu_torch.tools.devmap [--dynamic dump.json]
        [--warm warm.json] [--json devmap.json] [--check]

``--check`` exits 1 on a dynamic site unknown to the model, a copy at a
site or under a point the model does not declare, a signature first seen
after the ``--warm`` dump, a site whose signatures grew (more than one)
though the model could not prove its inputs bounded, an undeclared sync
under a serve dispatch, or an undeclared sync at a hot-set line the
model neither flags nor suppresses (``torch-host-sync``); the default is
informational (exit 0).
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path

from ..utils import devtrace

PORT = "difacto_tpu_torch"
_MODELS: dict = {}


def models(root="."):
    """(torchflow model, shardflow model) of the port under ``root``,
    built once per process for an unchanged tree."""
    from ..analysis import core
    from ..analysis.shardflow import get_shard_model
    from ..analysis.torchflow import get_torch_model
    root = Path(root).resolve()
    files = sorted((root / PORT).rglob("*.py"))
    stamp = tuple((str(p), p.stat().st_mtime_ns) for p in files)
    got = _MODELS.get(root)
    if got is None or got[0] != stamp:
        project = core.Project(root, [PORT])
        got = _MODELS[root] = (stamp, get_torch_model(project),
                               get_shard_model(project))
    return got[1], got[2]


def _label(site) -> str:
    """What a site wraps, as written: its argument, or the decorated
    function's name."""
    if isinstance(site.node, ast.Call) and site.node.args:
        return ast.unparse(site.node.args[0])
    return site.target_name


def inventory(root=".") -> dict:
    """{'sites': {site: {kind, label, warm_bounded}}, 'fetch_sites':
    {site: point}, 'put_sites': {site: point}, 'points': sorted point
    names, 'hot_funcs': n} of the port's model, sites keyed
    ``relpath:lineno``. A copy whose point is passed in a variable
    declares the point literals its module passes as ``point=`` or gives
    a ``point`` parameter as its default (a list)."""
    tm, _ = models(root)
    warm = tm.known_warm()
    sites = {sid: {"kind": s.kind, "label": _label(s),
                   "warm_bounded": sid in warm}
             for sid, s in sorted(tm.sites.items())}
    points = sorted(tm.points() | tm.points(puts=True))
    return {"sites": sites, "fetch_sites": dict(tm.fetch_sites),
            "put_sites": dict(tm.put_sites), "points": points,
            "hot_funcs": len(tm.hot_funcs)}


def _declared_point(static_point, point: str) -> bool:
    if isinstance(static_point, str):
        return static_point == point
    return point in static_point


def build(root=".", dynamic=None, warm=None) -> dict:
    """The inventory merged with a dump (``dynamic``, a devtrace.load
    dict) and its warm-up dump (``warm``): everything --check reads."""
    inv = inventory(root)
    out = dict(inv, dynamic_sites={}, dynamic_fetches={}, dynamic_puts={},
               syncs={}, declared_syncs=0, unknown_sites=[],
               unknown_fetches=[], new_signatures=[], serve_syncs=[],
               unbounded_growth=[], sync_verdicts={}, unknown_syncs=[])
    if not dynamic:
        return out
    out.update(dynamic_sites=dynamic["sites"],
               dynamic_fetches=dynamic["fetches"],
               dynamic_puts=dynamic.get("puts", {}),
               syncs=dynamic.get("syncs", {}),
               declared_syncs=dynamic.get("declared_syncs", 0))
    for site in sorted(dynamic["sites"]):
        if site not in inv["sites"]:
            out["unknown_sites"].append(site)
    for reg, static in ((dynamic["fetches"], inv["fetch_sites"]),
                        (dynamic.get("puts", {}), inv["put_sites"])):
        for site, rec in sorted(reg.items()):
            if site not in static or not _declared_point(static[site],
                                                         rec["point"]):
                out["unknown_fetches"].append(f"{site} ({rec['point']})")
    if warm is not None:
        for site, rec in sorted(dynamic["sites"].items()):
            before = set(warm["sites"].get(site, {}).get("keys", []))
            new = [k for k in rec.get("keys", []) if k not in before]
            if new:
                out["new_signatures"].append(
                    f"{site}: {len(new)} signature(s) after the warm-up")
    for site, rec in sorted(dynamic["sites"].items()):
        static = inv["sites"].get(site)
        if static is not None and rec.get("compiles", 0) > 1 \
                and not static["warm_bounded"]:
            out["unbounded_growth"].append(
                f"{site}: {rec['compiles']} signatures at a site whose "
                "inputs the model cannot prove bounded")
    tm, _ = models(root)
    for site, rec in sorted(out["syncs"].items()):
        if rec.get("serve", 0):
            out["serve_syncs"].append(
                f"{site}: {rec['serve']} undeclared sync(s) under a serve "
                "dispatch")
        verdict = tm.sync_verdict(site) if site.startswith(PORT) \
            else "cold"
        out["sync_verdicts"][site] = verdict
        if verdict == "unknown":
            out["unknown_syncs"].append(
                f"{site}: {rec['count']} undeclared sync(s) on the hot "
                "path that the model neither flags nor suppresses")
    return out


def to_text(graph: dict) -> str:
    lines = []
    dyn = graph["dynamic_sites"]
    for site, rec in sorted(graph["sites"].items()):
        d = dyn.get(site)
        run = ""
        if d:
            run = f"  [{d['compiles']} signatures / {d['calls']} calls"
            if "launches" in d:
                run += f" / {d['launches']} launches"
            run += "]"
        lines.append(f"{rec['kind']:7s} {site}  {rec['label']}{run}")
    for title, static, dyn_reg in (
            ("declared fetch points", graph["fetch_sites"],
             graph["dynamic_fetches"]),
            ("declared host-to-device copies", graph["put_sites"],
             graph["dynamic_puts"])):
        lines.append(f"{title}: {len(static)}")
        for site, point in sorted(static.items()):
            d = dyn_reg.get(site)
            run = f"  [{d['count']}x {d['point']}]" if d else ""
            if not isinstance(point, str):
                point = "|".join(point)
            lines.append(f"  {point:24s} {site}{run}")
    if graph["syncs"] or graph["declared_syncs"]:
        lines.append(f"CUDA syncs: {graph['declared_syncs']} declared; "
                     "undeclared by site:")
        for site, rec in sorted(graph["syncs"].items(),
                                key=lambda kv: -kv[1]["count"]):
            lines.append(f"  {rec['count']:8d}  {site}  (serve "
                         f"{rec.get('serve', 0)}, in a program "
                         f"{rec.get('in_program', 0)})")
    for key in ("unknown_sites", "unknown_fetches", "new_signatures",
                "serve_syncs", "unbounded_growth", "unknown_syncs"):
        for item in graph[key]:
            lines.append(f"{key.upper().replace('_', '-')}: {item}")
    return "\n".join(lines)


def failures(graph: dict) -> list:
    return (graph["unknown_sites"] + graph["unknown_fetches"]
            + graph["new_signatures"] + graph["serve_syncs"]
            + graph["unbounded_growth"] + graph["unknown_syncs"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merged static + dynamic map of the port's traced "
                    "programs, kernels, declared copies and CUDA syncs")
    ap.add_argument("--root", default=".")
    ap.add_argument("--dynamic", default=None,
                    help="devtrace dump (DIFACTO_JAXTRACE_OUT) to merge")
    ap.add_argument("--warm", default=None,
                    help="the same run's dump after its warm-up: any "
                         "signature the --dynamic dump adds fails --check")
    ap.add_argument("--json", default=None, help="write JSON here")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on an unknown site, an undeclared copy, a "
                         "signature new after the warm-up, a grown site "
                         "the model cannot bound, an undeclared sync under "
                         "a serve dispatch or one on the hot path the "
                         "model does not know")
    args = ap.parse_args(argv)
    dynamic = devtrace.load(args.dynamic) if args.dynamic else None
    warm = devtrace.load(args.warm) if args.warm else None
    graph = build(args.root, dynamic, warm)
    if args.json:
        Path(args.json).write_text(
            json.dumps(graph, indent=1, sort_keys=True) + "\n",
            encoding="utf-8")
        print(f"devmap: wrote {args.json}")
    print(to_text(graph))
    if args.check and failures(graph):
        print("devmap: CHECK FAILED: a site, copy, signature or sync "
              "outside the static model", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
