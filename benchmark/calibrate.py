"""The readings a cell's limits are set from, in one process: the
program's sound runs over many seeds, the lower-precision control and
the planted faults, each compared with the plain reference at the cell's
own size. Not run by the benchmark's runs.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 --fault-seeds 1 2 3 [--out FILE]

The control is the configuration's (``faults.control``): the program's
own bf16 fused rows where ``V_dim`` > 0, the planted bf16 rounding of
the flat table (``control_bf16_flat``) at ``V_dim`` 0. Each control seed
is also run sound, and a control whose table kept the sound run's dtype
and values is refused: its line says so and carries no readings, and
the exit code is 1.

Prints one JSON line per run: what ran, its seed and each number
compared.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import faults, harness, run  # noqa: E402


def table_print(rec, recorded: dict) -> tuple:
    """(dtype, digest) of the table rows the followed steps touched: the
    raw copies' dtype and a hash of their logical values before and after
    the steps."""
    h = hashlib.sha256()
    for part in ("before", "after"):
        for k in sorted(recorded[part]):
            h.update(recorded[part][k].tobytes())
    return str(rec.copies["last"][0][1].dtype), h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=sorted(faults.FAULTS))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    name, control_overrides, planted = faults.control(cell.conf)
    sound = list(args.seeds) + [s for s in args.control_seeds
                                if s not in args.seeds]
    plan = [("program", s, None, None) for s in sound]
    plan += [(name, s, control_overrides, planted)
             for s in args.control_seeds]
    plan += [(f, s, None, faults.FAULTS[f]) for f in args.faults
             for s in args.fault_seeds]
    prints: dict = {}
    refused = 0
    out = open(args.out, "a") if args.out else None
    try:
        for what, seed, overrides, fault in plan:
            t0 = time.monotonic()
            seen = {}
            r = run.run_cell(
                cell, seed, 0.0, False, "cuda",
                overrides=overrides, fault=fault, t_start=t0,
                on_recorded=lambda rec, got: seen.update(
                    print=table_print(rec, got)))
            line = {"workload": cell.name, "what": what, "seed": seed,
                    "correct": r["correct"],
                    "seconds": time.monotonic() - t0,
                    "check": {k: c["value"] for k, c in r["check"].items()},
                    "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
            if what == "program":
                prints[seed] = seen["print"]
            elif what == name and seen["print"] == prints[seed]:
                refused += 1
                line["correct"] = None
                line["check"] = {}
                line["refused"] = ("the control left the table's dtype and "
                                   "values as the sound run's")
            text = json.dumps(line)
            print(text, flush=True)
            if out is not None:
                out.write(text + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 1 if refused else 0


if __name__ == "__main__":
    sys.exit(main())
