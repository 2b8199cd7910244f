"""Finds what a cell names: its configuration file (as ``BENCHMARK.json``
lists it), its traffic file under ``traffic/`` and a reader file under
``metrics/`` for each per-layer metric, all by name. A later cell, traffic
mix or metric is a new file and a new entry, never an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def conf(self) -> dict:
        """The learner's configuration as run: the configuration's keys
        and the traffic's feed keys."""
        return {**self.cfg["conf"], **self.traffic["learner"]}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, spec_path: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    """The cell ``workload`` of the benchmark; an unknown name raises."""
    spec = load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    cfgs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in cfgs:
        raise KeyError(f"workload {workload!r} names an unknown "
                       f"configuration {w['config']!r}")
    cfg = load_json(ROOT / cfgs[w["config"]]["file"])
    traffic = load_traffic(w["traffic"])
    return Cell(workload, cfg, traffic,
                [m for m in spec["end_to_end"] if reports(m, workload)],
                [m for m in spec["per_layer"] if reports(m, workload)])


def load_traffic(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no traffic mix {name!r} under {path.parent}")
    return load_json(path)


def metric_reader(name: str) -> Callable[[dict], object]:
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no reader for metric {name!r} under {path.parent}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each metric its reader finds something for, with its unit."""
    out = {}
    for m in metrics:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
