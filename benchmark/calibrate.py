"""The readings a cell's limits are set from, in one process: the
program's sound runs over many seeds, the lower-precision control (the
program's own bf16 table) and the planted faults, each compared with the
plain reference at the cell's own size. Not run by the benchmark's runs.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 --fault-seeds 1 2 3 [--out FILE]

Prints one JSON line per run: what ran, its seed and each number
compared.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import faults, harness, run  # noqa: E402

CONTROL = {"slot_dtype": "bf16"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*",
                    default=["half_batch", "altered_loss"])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    plan = [("program", s, None, None) for s in args.seeds]
    plan += [("control_bf16", s, CONTROL, None) for s in args.control_seeds]
    plan += [(f, s, None, faults.FAULTS[f]) for f in args.faults
             for s in args.fault_seeds]
    out = open(args.out, "a") if args.out else None
    try:
        for what, seed, overrides, fault in plan:
            t0 = time.monotonic()
            r = run.run_cell(cell, seed, 0.0, False, "cuda",
                             overrides=overrides, fault=fault, t_start=t0)
            line = json.dumps({
                "workload": cell.name, "what": what, "seed": seed,
                "correct": r["correct"], "seconds": time.monotonic() - t0,
                "check": {k: c["value"] for k, c in r["check"].items()},
                "memory_peak_bytes": r["device"]["memory_peak_bytes"]})
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
