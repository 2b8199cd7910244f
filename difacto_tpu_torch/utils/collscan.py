"""Collective and memory scan of the port's programs (counterpart of
difacto_tpu/utils/hloscan.py).

The JAX package compiles its sharded programs and scans the optimized
HLO for the collectives XLA's partitioner inserted. The port has no
partitioner: every cross-process collective is an explicit
``torch.distributed`` call of parallel/multihost.py (``allgather_np``
and ``DataPlane``'s gathers), so the scan records those calls as they
run. With ``DIFACTO_HLOSCAN=1`` (which also turns utils/devtrace.py on,
as in JAX) it records, per traced program (devtrace's ``relpath:lineno``
site; a collective outside any traced program is keyed by its caller's
site and marked ``traced: false``):

- every collective: its kind, the input's shape and dtype, the bytes
  this process sends per call, the call count, and whether it is
  **table-axis**: an all-gather or all-to-all whose input or gathered
  shape carries a dimension equal to ``DIFACTO_HLOSCAN_ROWS`` (the
  table's row count), i.e. the table moved whole across processes, as
  ``hloscan.scan_text`` classifies an HLO line;
- on a CUDA device, each traced call's peak allocated bytes above the
  call's entry (``torch.cuda.reset_peak_memory_stats`` and
  ``max_memory_allocated``), checked against ``DIFACTO_HLOSCAN_BUDGET``
  (bytes; 0 = no budget). The CPU records no memory;
- apart from the collectives, the control plane's store traffic (the
  TCPStore keys of the key exchange, the clocks and the cleanups): count
  and bytes per operation. Store keys are not collectives.

``DIFACTO_HLOSCAN_OUT=<path>`` dumps the scan as JSON at process exit;
``python -m difacto_tpu_torch.tools.collmap --check`` fails on any
table-axis collective, budget breach or program outside the port's
inventory. Off (the default), every entry point returns after one
environment read.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

from .locktrace import mutex

_mu = mutex()                       # guards the registries
_programs: Dict[str, dict] = {}     # site -> scan record
_store: Dict[str, dict] = {}        # store op -> {count, bytes}

# only these move an axis whole across processes; a sum combines values
_TABLE_AXIS_KINDS = ("all_gather", "all_gather_into_tensor", "all_to_all")
_HERE = (os.path.abspath(__file__),)


def enabled() -> bool:
    return os.environ.get("DIFACTO_HLOSCAN", "") not in ("", "0")


def table_rows() -> int:
    """The table's row count whose appearance in a gathered shape marks a
    table-axis collective; 0 (the default) disables the classification."""
    try:
        return int(os.environ.get("DIFACTO_HLOSCAN_ROWS", "0"))
    except ValueError:
        return 0


def temp_budget() -> int:
    """Per-call peak device-bytes budget; 0 = no budget."""
    try:
        return int(os.environ.get("DIFACTO_HLOSCAN_BUDGET", "0"))
    except ValueError:
        return 0


def _record_for(site: str, label: str, traced: bool) -> dict:
    rec = _programs.get(site)
    if rec is None:
        rec = _programs[site] = {
            "label": label, "traced": traced, "collectives": [],
            "table_collectives": 0, "calls": 0, "peak_temp_bytes": 0,
            "over_budget": False}
    return rec


def _caller_site(skip_files) -> str:
    from .devtrace import _rel
    f = sys._getframe(1)
    while f is not None and os.path.abspath(f.f_code.co_filename) \
            in skip_files:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{_rel(f.f_code.co_filename)}:{f.f_lineno}"


def record_collective(kind: str, shape, dtype, nbytes: int, nprocs: int,
                      skip_files=()) -> dict:
    """Record one collective this process issued: ``kind`` (the
    ``torch.distributed`` function's name), its input's ``shape`` and
    ``dtype``, the ``nbytes`` it sends, over ``nprocs`` processes.
    ``skip_files`` are the caller's own module files, left out when a
    collective outside any traced program is keyed by its caller.
    Returns the collective's entry."""
    from .devtrace import current_program
    shape = tuple(int(d) for d in shape)
    rows = table_rows()
    dims = sorted(set(shape) | ({nprocs * shape[0]} if shape else set()))
    table_axis = bool(rows) and kind in _TABLE_AXIS_KINDS and rows in dims
    site = current_program()
    traced = bool(site)
    if not traced:
        site = _caller_site(_HERE + tuple(os.path.abspath(s)
                                          for s in skip_files))
    with _mu:
        rec = _record_for(site, "", traced)
        for c in rec["collectives"]:
            if (c["kind"], c["shape"], c["dtype"]) == \
                    (kind, list(shape), str(dtype)):
                break
        else:
            c = {"kind": kind, "shape": list(shape), "dims": dims,
                 "dtype": str(dtype), "bytes": int(nbytes), "count": 0,
                 "table_axis": table_axis}
            rec["collectives"].append(c)
            rec["table_collectives"] += table_axis
        c["count"] += 1
        return dict(c)


def record_store(op: str, nbytes: int = 0) -> None:
    """Count one control-plane store operation (``set``, ``get``,
    ``wait``, ``delete``) and the value bytes it moved."""
    with _mu:
        rec = _store.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += int(nbytes)


def _cuda_device(args):
    for a in args:
        dev = getattr(a, "device", None)
        if getattr(dev, "type", "") == "cuda":
            return dev
        if isinstance(a, (tuple, list)):
            dev = _cuda_device(a)
            if dev is not None:
                return dev
    return None


def measure(site: str, label: str, fn, args: tuple, kwargs: dict):
    """Run one traced call, recording its peak allocated bytes above its
    entry when its tensors are on a card."""
    import torch
    dev = _cuda_device(args) or _cuda_device(tuple(kwargs.values()))
    if dev is None:
        out = fn(*args, **kwargs)
        peak = None
    else:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = fn(*args, **kwargs)
        peak = torch.cuda.max_memory_allocated(dev) - base
    budget = temp_budget()
    with _mu:
        rec = _record_for(site, label, True)
        rec["label"] = rec["label"] or label
        rec["traced"] = True
        rec["calls"] += 1
        if peak is not None:
            rec["peak_temp_bytes"] = max(rec["peak_temp_bytes"], int(peak))
            rec["over_budget"] = rec["over_budget"] or (
                bool(budget) and peak > budget)
    return out


# ----------------------------------------------------------------- data
def programs() -> Dict[str, dict]:
    """Snapshot: site -> scan record."""
    with _mu:
        return {s: json.loads(json.dumps(rec))
                for s, rec in _programs.items()}


def store_ops() -> Dict[str, dict]:
    """Snapshot: store op -> {count, bytes}."""
    with _mu:
        return {k: dict(v) for k, v in _store.items()}


def violations(progs: Optional[Dict[str, dict]] = None) -> List[dict]:
    """Gate view: one entry per table-axis collective or budget breach."""
    progs = programs() if progs is None else progs
    out = []
    for site, rec in sorted(progs.items()):
        for c in rec.get("collectives", []):
            if c.get("table_axis"):
                out.append({"site": site, "kind": "table-collective",
                            "detail": f"{c['kind']} {c['shape']} x"
                                      f"{c['count']}"})
        if rec.get("over_budget"):
            out.append({"site": site, "kind": "temp-budget",
                        "detail": f"peak_temp_bytes="
                                  f"{rec.get('peak_temp_bytes')}"})
    return out


def totals(progs: Optional[Dict[str, dict]] = None,
           site: Optional[str] = None) -> dict:
    """{'calls', 'bytes'} of the collectives recorded (under ``site``
    only, when given)."""
    progs = programs() if progs is None else progs
    calls = nbytes = 0
    for s, rec in progs.items():
        if site is not None and s != site:
            continue
        for c in rec.get("collectives", []):
            calls += c["count"]
            nbytes += c["count"] * c["bytes"]
    return {"calls": calls, "bytes": nbytes}


def reset() -> None:
    with _mu:
        _programs.clear()
        _store.clear()


def dump(path) -> str:
    """Write the scan as JSON, stamped with the knobs that shaped it;
    returns the path."""
    payload = {
        "version": 1,
        "rows": table_rows(),
        "budget": temp_budget(),
        "programs": dict(sorted(programs().items())),
        "store": dict(sorted(store_ops().items())),
    }
    p = Path(path)
    if p.parent and str(p.parent) not in (".", ""):
        p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=1) + "\n", encoding="utf-8")
    return str(p)


def load(path) -> dict:
    """Read a dump() back: {'rows', 'budget', 'programs', 'store'}."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    if data.get("version") != 1:
        raise ValueError(f"collscan dump {path}: unsupported version "
                         f"{data.get('version')!r}")
    return {"rows": int(data.get("rows", 0)),
            "budget": int(data.get("budget", 0)),
            "programs": dict(data.get("programs", {})),
            "store": dict(data.get("store", {}))}


def _atexit_dump() -> None:  # pragma: no cover - process teardown
    out = os.environ.get("DIFACTO_HLOSCAN_OUT", "")
    if out and enabled():
        try:
            dump(out)
        except OSError as e:
            print(f"collscan: dump to {out} failed: {e}", file=sys.stderr)


atexit.register(_atexit_dump)
