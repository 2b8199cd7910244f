"""The port's collective and memory scan (difacto_tpu_torch/utils/
collscan.py) and ``python -m difacto_tpu_torch.tools.collmap``, the
counterparts of tests/test_hloscan.py.

- the table-axis classifier (an all-gather whose shape carries the
  table's row count; a sum never is), the violations view, totals, the
  store counters and the dump/load round trip, with the rows knob off;
- two gloo ranks through the repo's ``launch.py`` (this file is the
  worker, as tests/test_torch_multihost.py is its own) train 2 steps of
  the (dp=2, fs=4) mesh under ``DIFACTO_HLOSCAN=1`` with
  ``DIFACTO_HLOSCAN_ROWS`` at the table's capacity: no table-axis
  collective, and the scan's count and bytes of collectives under the
  train step equal the ``DataPlane``'s own counters; then a planted
  ``all_gather`` of the whole table through the data plane is flagged,
  as tests/test_hloscan.py:114 plants a replicated table;
- ``collmap --check`` passes on the clean scan and fails on the planted
  one; the JAX package's hloscan classifies the same shapes alike.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from difacto_tpu.utils import hloscan
from difacto_tpu_torch.tools import collmap
from difacto_tpu_torch.utils import collscan, devtrace

REPO = pathlib.Path(__file__).resolve().parent.parent
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")
CAPACITY = 16384

two_procs = pytest.mark.skipif(
    (os.cpu_count() or 1) < 2,
    reason="two gloo processes need >= 2 CPU cores")


@pytest.fixture
def scan_env(monkeypatch):
    monkeypatch.setenv("DIFACTO_HLOSCAN", "1")
    monkeypatch.setenv("DIFACTO_HLOSCAN_ROWS", "512")
    monkeypatch.delenv("DIFACTO_HLOSCAN_BUDGET", raising=False)
    collscan.reset()
    yield
    collscan.reset()


# ------------------------------------------------------------ the classifier
@pytest.mark.parametrize("kind,shape,table", [
    ("all_gather", (512, 4), True),           # the whole table, gathered
    ("all_gather", (256, 4), True),           # two halves make the table
    ("all_gather", (128, 4), False),
    ("all_gather_into_tensor", (512,), True),
    ("all_to_all", (4, 512), True),
    ("all_reduce", (512, 4), False),          # a sum moves values, not rows
    ("reduce_scatter", (512, 4), False),
])
def test_table_axis_classification(scan_env, kind, shape, table):
    c = collscan.record_collective(kind, shape, "torch.float32",
                                   int(np.prod(shape)) * 4, nprocs=2)
    assert c["table_axis"] is table
    assert c["bytes"] == int(np.prod(shape)) * 4 and c["count"] == 1
    assert (len(collscan.violations()) == 1) is table


def test_jax_hloscan_classifies_the_same_gather():
    # the same gathered shape as HLO text: table-axis at the row count
    line = ("%ag = f32[512,4]{1,0} all-gather(f32[256,4]{1,0} %p), "
            "dimensions={0}")
    (c,) = hloscan.scan_text(line, rows=512)
    assert c["table_axis"]
    (c,) = hloscan.scan_text(line, rows=4096)
    assert not c["table_axis"]


def test_rows_knob_off_classifies_nothing(monkeypatch):
    monkeypatch.setenv("DIFACTO_HLOSCAN", "1")
    monkeypatch.delenv("DIFACTO_HLOSCAN_ROWS", raising=False)
    collscan.reset()
    c = collscan.record_collective("all_gather", (512, 4), "f32", 8192, 2)
    assert not c["table_axis"] and collscan.violations() == []
    collscan.reset()


def test_repeats_count_into_one_entry_with_totals(scan_env):
    for shape, dtype, nbytes in [((3, 100), "torch.float32", 1200)] * 3 \
            + [((7,), "torch.int64", 56)]:
        collscan.record_collective("all_gather", shape, dtype, nbytes, 2)
    (site, rec), = collscan.programs().items()
    # outside any traced program the caller's site keys the record
    assert site.startswith("tests/test_torch_collscan.py:")
    assert rec["traced"] is False
    assert [c["count"] for c in rec["collectives"]] == [3, 1]
    assert collscan.totals() == {"calls": 4, "bytes": 3 * 1200 + 56}


def test_collectives_inside_a_traced_program_are_charged_to_it(
        scan_env, monkeypatch):
    import torch
    monkeypatch.setenv("DIFACTO_JAXTRACE", "1")

    def step(x):
        collscan.record_collective("all_gather", tuple(x.shape), x.dtype,
                                   x.numel() * 4, nprocs=2)
        return x + 1

    f = devtrace.traced(step)
    f(torch.ones(8))
    f(torch.ones(8))
    rec = collscan.programs()[f.site]
    assert rec["traced"] and rec["calls"] == 2 and rec["label"] == "step"
    assert collscan.totals(site=f.site) == {"calls": 2, "bytes": 64}
    # the CPU records no memory
    assert rec["peak_temp_bytes"] == 0 and not rec["over_budget"]


def test_store_ops_are_counted_apart(scan_env):
    collscan.record_store("set", 100)
    collscan.record_store("get", 100)
    collscan.record_store("get", 50)
    collscan.record_store("wait")
    assert collscan.store_ops() == {"set": {"count": 1, "bytes": 100},
                                    "get": {"count": 2, "bytes": 150},
                                    "wait": {"count": 1, "bytes": 0}}
    assert collscan.totals() == {"calls": 0, "bytes": 0}


def test_violations_view_over_program_records():
    progs = {
        "a.py:1": {"label": "x", "traced": True,
                   "collectives": [{"kind": "all_gather", "shape": [512, 4],
                                    "dims": [4, 512], "dtype": "f32",
                                    "bytes": 8192, "count": 2,
                                    "table_axis": True}],
                   "table_collectives": 1, "peak_temp_bytes": 10,
                   "over_budget": False, "calls": 1},
        "b.py:2": {"label": "y", "traced": True, "collectives": [],
                   "table_collectives": 0, "peak_temp_bytes": 1 << 30,
                   "over_budget": True, "calls": 1},
    }
    v = collscan.violations(progs)
    assert [(x["site"], x["kind"]) for x in v] == [
        ("a.py:1", "table-collective"), ("b.py:2", "temp-budget")]


def test_dump_load_round_trip(tmp_path, scan_env):
    collscan.record_collective("all_gather", (512, 4), "torch.float32",
                               8192, 2)
    collscan.record_store("set", 8)
    path = tmp_path / "scan.json"
    collscan.dump(path)
    doc = collscan.load(path)
    assert doc["rows"] == 512 and doc["budget"] == 0
    assert doc["programs"] == collscan.programs()
    assert doc["store"] == {"set": {"count": 1, "bytes": 8}}
    path.write_text(json.dumps({"version": 99, "programs": {}}))
    with pytest.raises(ValueError):
        collscan.load(path)


def test_off_records_nothing_and_the_hooks_return_early(monkeypatch):
    monkeypatch.delenv("DIFACTO_HLOSCAN", raising=False)
    collscan.reset()
    from difacto_tpu_torch.parallel.multihost import allgather_np
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    np.testing.assert_array_equal(allgather_np(a), a[None])
    assert collscan.programs() == {} and collscan.store_ops() == {}


# ----------------------------------------------------------- two gloo ranks
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out_dir) -> None:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(REPO), DIFACTO_TORCH_VIRTUAL_DEVICES="4",
               DIFACTO_HLOSCAN="1", DIFACTO_HLOSCAN_ROWS=str(CAPACITY))
    env.pop("DIFACTO_HLOSCAN_OUT", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "launch.py"), "-n", "2",
         "--port", str(free_port()), "--",
         sys.executable, __file__, str(out_dir)],
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"


@pytest.fixture(scope="module")
def two_rank_scan(tmp_path_factory):
    d = tmp_path_factory.mktemp("collscan")
    launch(d)
    return d


def _split(progs: dict) -> tuple:
    """(the cross-process collectives, the moves between a rank's logical
    devices) of a scan's programs: parallel/mesh.device_copy records its
    bytes as kind ``device_copy``."""
    def keep(pred):
        return {s: dict(rec, collectives=[c for c in rec["collectives"]
                                          if pred(c)])
                for s, rec in progs.items()}
    return (keep(lambda c: c["kind"] != "device_copy"),
            keep(lambda c: c["kind"] == "device_copy"))


@two_procs
def test_two_ranks_record_no_table_axis_collective(two_rank_scan):
    for r in (0, 1):
        doc = collscan.load(two_rank_scan / f"clean-{r}.json")
        assert doc["rows"] == CAPACITY
        assert collscan.violations(doc["programs"]) == []
        assert doc["programs"], "the data plane issued no collective"
        cross, moves = _split(doc["programs"])
        assert all(c["kind"] == "all_gather" and not c["table_axis"]
                   for rec in cross.values()
                   for c in rec["collectives"])
        # the fs = 4 shards' runs moved between the logical devices
        assert collscan.totals(moves)["calls"] > 0
        assert not any(c["table_axis"] for rec in moves.values()
                       for c in rec["collectives"])


@two_procs
def test_two_ranks_collectives_equal_the_data_plane_counters(
        two_rank_scan):
    stats = [json.loads((two_rank_scan / f"plane-{r}.json").read_text())
             for r in (0, 1)]
    assert stats[0] == stats[1]
    for r, st in enumerate(stats):
        doc = collscan.load(two_rank_scan / f"clean-{r}.json")
        train = st["train_site"]
        assert doc["programs"][train]["traced"]
        cross, _ = _split(doc["programs"])
        got = collscan.totals(cross, site=train)
        assert got == {"calls": st["calls"], "bytes": st["bytes_out"]}
        # nothing else crossed the processes: the train step is all
        assert collscan.totals(cross) == got
        # 2 steps, each its two gathers: the rows and the partials
        assert st["steps"] == 2 and st["calls"] == 2 * st["steps"]
        assert doc["store"]["set"]["count"] > 0      # the key exchange


@two_procs
def test_two_ranks_planted_table_gather_is_flagged(two_rank_scan):
    for r in (0, 1):
        doc = collscan.load(two_rank_scan / f"planted-{r}.json")
        v = collscan.violations(doc["programs"])
        assert [x["kind"] for x in v] == ["table-collective"], v
        assert str(CAPACITY) in v[0]["detail"]


@two_procs
def test_collmap_check_passes_clean_and_fails_planted(two_rank_scan,
                                                      capsys):
    clean = str(two_rank_scan / "clean-0.json")
    planted = str(two_rank_scan / "planted-0.json")
    assert collmap.main(["--root", str(REPO), "--dynamic", clean,
                         "--check"]) == 0
    assert collmap.main(["--root", str(REPO), "--dynamic", planted,
                         "--check"]) == 1
    assert "TABLE-HITS" in capsys.readouterr().out


def test_collmap_check_fails_on_unknown_program_and_budget(tmp_path):
    progs = {"difacto_tpu_torch/nowhere.py:1": {
        "label": "x", "traced": True, "collectives": [],
        "table_collectives": 0, "peak_temp_bytes": 0,
        "over_budget": False, "calls": 1}}
    path = tmp_path / "scan.json"
    path.write_text(json.dumps({"version": 1, "rows": 0, "budget": 0,
                                "programs": progs}))
    assert collmap.main(["--root", str(REPO), "--dynamic", str(path),
                         "--check"]) == 1
    progs = {"difacto_tpu_torch/learners/sgd.py:0": dict(
        progs["difacto_tpu_torch/nowhere.py:1"], traced=False,
        over_budget=True)}
    path.write_text(json.dumps({"version": 1, "rows": 0, "budget": 1,
                                "programs": progs}))
    graph = collmap.build(str(REPO), collscan.load(path))
    assert graph["unknown_sites"] == [] and len(graph["budget_hits"]) == 1


def _worker(out: pathlib.Path) -> None:
    import torch

    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.parallel.multihost import (DataPlane,
                                                      process_index)
    conf = {"data_in": RCV1, "V_dim": "2", "V_threshold": "2",
            "lr": "0.1", "l1": "0.1", "l2": "0", "batch_size": "100",
            "max_num_epochs": "2", "shuffle": "0", "report_interval": "0",
            "stop_rel_objv": "0", "stop_val_auc": "-2",
            "num_jobs_per_epoch": "1", "hash_capacity": str(CAPACITY),
            "mesh_dp": "2", "mesh_fs": "4"}
    ln = SGDLearner(device="cpu")
    ln.init(list(conf.items()))
    ln.run()
    rank = process_index()
    plane = ln.loss.plane
    train = ln._train_step.site
    steps = devtrace.sites()[train]["calls"]
    (out / f"plane-{rank}.json").write_text(json.dumps({
        "calls": plane.calls, "bytes_out": plane.bytes_out,
        "steps": steps, "train_site": train}))
    collscan.dump(out / f"clean-{rank}.json")
    # the planted fault: the whole table gathered across the processes
    DataPlane().gather(torch.zeros((CAPACITY, 4), dtype=torch.float32))
    collscan.dump(out / f"planted-{rank}.json")


if __name__ == "__main__":
    from difacto_tpu_torch.parallel.multihost import initialize
    initialize()
    _worker(pathlib.Path(sys.argv[1]))
