"""Merged static + dynamic map of the port's collectives and memory
peaks (counterpart of the root ``tools/hlomap.py``).

The static half is the port analyzer's sharding-flow model
(``difacto_tpu_torch/analysis/shardflow.py``): the traced programs, and
every line from which a collective can be issued outside one (a call that
reaches a ``torch.distributed`` collective or the data plane). The
dynamic half
is a utils/collscan.py dump (``DIFACTO_HLOSCAN=1`` with
``DIFACTO_HLOSCAN_OUT=<path>``, or ``collscan.dump``): per program, the
``torch.distributed`` collectives it issued (kind, shape, dtype, bytes,
count, table-axis or not) and its peak device bytes above entry; apart
from them the control plane's store traffic. Merging answers:

- did any collective move the table whole across processes (an
  all-gather carrying ``DIFACTO_HLOSCAN_ROWS`` in its shape:
  ``table_hits``)?
- did any program's peak exceed ``DIFACTO_HLOSCAN_BUDGET``
  (``budget_hits``)?
- did a traced program run at a site the model does not know
  (``unknown_sites``)?
- was a collective recorded at a site the model does not know: a traced
  program outside the model, or a host line the model does not see
  reaching a collective (``unknown_collectives``)?

    python -m difacto_tpu_torch.tools.collmap --dynamic scan.json
        [--json collmap.json] [--check]

``--check`` exits 1 on any of the four; the default is informational.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..utils import collscan
from .devmap import inventory, models


def build(root=".", dynamic=None) -> dict:
    """{'sites', 'programs', 'store', 'table_hits', 'budget_hits',
    'unknown_sites', 'unknown_collectives'}: the model merged with a
    collscan.load dict."""
    inv = inventory(root)
    _, shard = models(root)
    out = {"sites": {s: r for s, r in inv["sites"].items()
                     if r["kind"] == "program"},
           "collective_sites": sorted(shard.collective_sites),
           "programs": {}, "store": {}, "table_hits": [],
           "budget_hits": [], "unknown_sites": [],
           "unknown_collectives": []}
    if not dynamic:
        return out
    progs = dynamic["programs"]
    out["programs"] = progs
    out["store"] = dynamic.get("store", {})
    for v in collscan.violations(progs):
        key = ("table_hits" if v["kind"] == "table-collective"
               else "budget_hits")
        out[key].append(v)
    for site, rec in sorted(progs.items()):
        # a collective outside any traced program is keyed by its caller
        # (traced false) and is not a program of the inventory
        if rec.get("traced") and site not in out["sites"]:
            out["unknown_sites"].append(site)
        if rec.get("collectives") and not shard.knows_collective_at(
                site, bool(rec.get("traced"))):
            out["unknown_collectives"].append(site)
    return out


def to_text(graph: dict) -> str:
    lines = []
    for site, rec in sorted(graph["programs"].items()):
        tot = collscan.totals({site: rec})
        lines.append(
            f"{'program' if rec.get('traced') else 'host   '} {site}  "
            f"{rec.get('label', '')}  calls={rec.get('calls', 0)} "
            f"collectives={tot['calls']} bytes={tot['bytes']} "
            f"table_collectives={rec.get('table_collectives', 0)} "
            f"peak_temp_bytes={rec.get('peak_temp_bytes', 0)}"
            f"{'  OVER-BUDGET' if rec.get('over_budget') else ''}")
        for c in rec.get("collectives", []):
            lines.append(f"    {c['kind']} {c['shape']} {c['dtype']} "
                         f"{c['bytes']} B x{c['count']}"
                         f"{'  TABLE-AXIS' if c['table_axis'] else ''}")
    for op, rec in sorted(graph["store"].items()):
        lines.append(f"store {op}: {rec['count']} ops, {rec['bytes']} B")
    for key in ("table_hits", "budget_hits"):
        for v in graph[key]:
            lines.append(f"{key.upper().replace('_', '-')}: "
                         f"{v['site']}  {v['detail']}")
    for key in ("unknown_sites", "unknown_collectives"):
        for site in graph[key]:
            lines.append(f"{key.upper().replace('_', '-')}: {site}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merged static + dynamic map of the port's "
                    "collectives and memory peaks")
    ap.add_argument("--root", default=".")
    ap.add_argument("--dynamic", default=None,
                    help="collscan dump (DIFACTO_HLOSCAN_OUT) to merge")
    ap.add_argument("--json", default=None, help="write JSON here")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on a table-axis collective, a budget "
                         "breach, or a program or a collective outside "
                         "the model")
    args = ap.parse_args(argv)
    dynamic = collscan.load(args.dynamic) if args.dynamic else None
    graph = build(args.root, dynamic)
    if args.json:
        Path(args.json).write_text(
            json.dumps(graph, indent=1, sort_keys=True) + "\n",
            encoding="utf-8")
        print(f"collmap: wrote {args.json}")
    print(to_text(graph))
    if args.check and (graph["table_hits"] or graph["budget_hits"]
                       or graph["unknown_sites"]
                       or graph["unknown_collectives"]):
        print("collmap: CHECK FAILED: table-axis collective, budget "
              "breach, or a program or collective outside the model",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
