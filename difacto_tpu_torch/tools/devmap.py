"""Merged static + dynamic map of the port's traced programs, kernels,
declared copies and CUDA syncs (counterpart of the root
``tools/jitmap.py``).

The static half is an AST inventory of ``difacto_tpu_torch/``: every
``devtrace.traced`` creation site (a call, or an ``@devtrace.traced``
method), every ``devtrace.kernel`` site, and every ``devtrace.fetch`` /
``devtrace.to_device`` call site with its ``point=`` name. The dynamic
half is a utils/devtrace.py dump (``DIFACTO_JAXTRACE=1`` with
``DIFACTO_JAXTRACE_OUT=<path>``, or ``devtrace.dump``). Both key sites by
the same ``relpath:lineno``, so merging answers which programs a run
exercised with how many signatures, whether a site or a copy happened
outside the inventory, and where the run synced undeclared.

    python -m difacto_tpu_torch.tools.devmap [--dynamic dump.json]
        [--warm warm.json] [--json devmap.json] [--check]

``--check`` exits 1 on a dynamic site unknown to the inventory, a copy
at a site or under a point the inventory does not declare, a signature
first seen after the ``--warm`` dump, or an undeclared sync under a
serve dispatch; the default is informational (exit 0).
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path
from typing import Optional

from ..utils import devtrace

PORT = "difacto_tpu_torch"
_KINDS = {"traced": "program", "kernel": "kernel", "fetch": "fetch",
          "to_device": "put"}


def _devtrace_name(node) -> Optional[str]:
    """``traced``/``kernel``/``fetch``/``to_device`` when ``node`` is
    ``devtrace.<that name>``, the one spelling the port uses."""
    if isinstance(node, ast.Attribute) and node.attr in _KINDS \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "devtrace":
        return node.attr
    return None


def inventory(root=".") -> dict:
    """{'sites': {site: {kind, label}}, 'fetch_sites': {site: point},
    'put_sites': {site: point}, 'points': sorted point names} over the
    port's source, sites keyed ``relpath:lineno``. A copy whose point is
    passed in a variable declares the point literals its module passes
    as ``point=`` or gives a ``point`` parameter as its default (a
    list)."""
    root = Path(root).resolve()
    sites, fetch_sites, put_sites = {}, {}, {}
    for path in sorted((root / PORT).rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel == f"{PORT}/utils/devtrace.py":
            continue
        tree = ast.parse(path.read_text(encoding="utf-8"), filename=rel)
        literals = _point_literals(tree)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if _devtrace_name(dec) == "traced":
                        sites[f"{rel}:{dec.lineno}"] = {
                            "kind": "program", "label": node.name}
                continue
            if not isinstance(node, ast.Call):
                continue
            name = _devtrace_name(node.func)
            if name is None:
                continue
            site = f"{rel}:{node.lineno}"
            if name in ("fetch", "to_device"):
                point = ""
                for kw in node.keywords:
                    if kw.arg == "point" and isinstance(kw.value,
                                                        ast.Constant):
                        point = kw.value.value
                    elif kw.arg == "point":
                        point = literals
                (fetch_sites if name == "fetch" else put_sites)[site] = point
            else:
                label = ast.unparse(node.args[0]) if node.args else ""
                sites[site] = {"kind": _KINDS[name], "label": label}
    points = set()
    for v in list(fetch_sites.values()) + list(put_sites.values()):
        points.update([v] if isinstance(v, str) else v)
    points = sorted(points)
    return {"sites": sites, "fetch_sites": fetch_sites,
            "put_sites": put_sites, "points": points}


def _point_literals(tree) -> list:
    """The point names a module hands on: ``point="..."`` keywords of
    its calls to its own functions and the defaults of parameters named
    ``point``."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and not _devtrace_name(node.func):
            for kw in node.keywords:
                if kw.arg == "point" and isinstance(kw.value, ast.Constant):
                    out.add(kw.value.value)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            named = a.posonlyargs + a.args
            for arg, d in zip(named[len(named) - len(a.defaults):],
                              a.defaults):
                if arg.arg == "point" and isinstance(d, ast.Constant):
                    out.add(d.value)
            for arg, d in zip(a.kwonlyargs, a.kw_defaults):
                if arg.arg == "point" and isinstance(d, ast.Constant):
                    out.add(d.value)
    out.discard("")
    return sorted(out)


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
               unknown_fetches=[], new_signatures=[], serve_syncs=[])
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
    for site, rec in sorted(out["syncs"].items()):
        if rec.get("serve", 0):
            out["serve_syncs"].append(
                f"{site}: {rec['serve']} undeclared sync(s) under a serve "
                "dispatch")
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
                "serve_syncs"):
        for item in graph[key]:
            lines.append(f"{key.upper().replace('_', '-')}: {item}")
    return "\n".join(lines)


def failures(graph: dict) -> list:
    return (graph["unknown_sites"] + graph["unknown_fetches"]
            + graph["new_signatures"] + graph["serve_syncs"])


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
                         "signature new after the warm-up or an undeclared "
                         "sync under a serve dispatch")
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
              "outside the declared model", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
