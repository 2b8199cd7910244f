"""The benchmark of ``difacto_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up generates the cell's rows from ``--seed`` into a temporary
directory, builds the learner of the cell's configuration on the card
(its table initialised there from the seed), streams epoch 0 and replays
epoch 1. The window replays epochs for ``--seconds``, the first steps of
its first epoch followed for the check; with ``--trace 1`` more epochs
follow under torch.profiler. Then the program's state is freed, the plain reference
follows the same steps, and the last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
end-to-end metrics, or with ``--trace 1`` the per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``check``, each number
compared beside its limit. Exits non-zero, printing no result, without
enough CUDA devices or when the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Optional  # noqa: E402

if __package__ in (None, ""):
    # run as a script: import the benchmark as a package from the root,
    # never its modules as top-level names
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import check, gen, harness, program, traceread  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "difacto_tpu")
HOST_SPANS = [program.SPAN_GATHER, program.SPAN_PUSH,
              program.SPAN_EVALUATE, program.SPAN_FETCH,
              program.SPAN_DISPATCH]
KERNEL_SPANS = {"gather": program.SPAN_GATHER, "push": program.SPAN_PUSH}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package's or JAX's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: harness.Cell, seed: int, seconds: float, traced: bool,
             device: str, overrides: Optional[dict] = None,
             fault: Optional[Callable] = None,
             t_start: float = T_PROCESS,
             on_recorded: Optional[Callable] = None) -> dict:
    """One run of ``cell``; returns the result line's object.
    ``overrides`` changes configuration keys (the lower-precision
    control); ``fault(learner)`` breaks the program underneath (the
    checks' tests); ``on_recorded(rec, recorded)`` sees the recorder and
    what it read before the program's state is freed (the calibration's
    look at the control's table)."""
    tr = cell.traffic
    conf = {**cell.conf, **(overrides or {})}
    n = int(cell.cfg["epoch_rows"])
    rows = gen.make_rows(tr, n, seed)
    followed = int(tr["followed_steps"])
    setup_epochs = int(tr["setup_epochs"])
    with tempfile.TemporaryDirectory(prefix="difacto-bench-") as tmp:
        data = os.path.join(tmp, "rows.criteo")
        with open(data, "wb") as f:
            f.write(gen.criteo_text(rows))
        learner = program.build_learner(
            program.learner_kwargs(cell.cfg, tr, data, seed, overrides),
            device)
        if fault is not None:
            fault(learner)
        # every epoch runs each of the staged batches once
        first = -(-n // int(conf["batch_size"])) * setup_epochs
        rec = program.Recorder(learner,
                               list(range(first, first + followed)))
        setup = {}

        def setup_done():
            rec.prepare()
            setup["s"] = time.monotonic() - t_start

        try:
            win = program.run(learner, device, setup_epochs, seconds,
                              int(tr["trace_epochs"]) if traced else 0,
                              on_setup_done=setup_done)
        finally:
            rec.close()
        recorded = rec.results()
        if on_recorded is not None:
            on_recorded(rec, recorded)
        prog = check.program(recorded)
        program.release(learner)
        del learner, rec
    ref = check.reference(rows, conf, seed, setup_epochs, followed, device)
    values = check.readings(prog, ref)
    correct, compared = check.judge(values, cell.cfg["check"]["limits"])
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": device_name(device), "count": 1,
           "memory_peak_bytes": win.peak_bytes}
    ctx = {"window": win, "conf": conf, "device": device,
           "epoch_tokens": gen.token_count(rows), "epoch_rows": n}
    result = {"correct": bool(correct), "attempted": win.steps,
              "failed": win.failed_steps}
    if traced:
        t = win.traced
        ctx["trace"] = traceread.analyze(t["events"], KERNEL_SPANS, HOST_SPANS)
        ctx["traced"] = t
        result["metrics"] = harness.read_metrics(cell.per_layer, ctx)
        if ctx["trace"] is not None:
            dev["busy_s"] = ctx["trace"]["busy_s"]
            dev["window_s"] = ctx["trace"]["window_s"]
            result["breakdown"] = {
                "device_ops": ctx["trace"]["device_ops"],
                "idle_gaps": ctx["trace"]["idle_gaps"]}
    else:
        ctx["setup_s"] = setup["s"]
        result["metrics"] = harness.read_metrics(cell.end_to_end, ctx)
    result["device"] = dev
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, v, lim in compared}
    return result


def device_name(device: str) -> str:
    import torch
    if device.startswith("cuda"):
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the port runs without "
              "JAX and the JAX package", file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
