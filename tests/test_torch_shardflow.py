"""The port analyzer's sharding-flow model (difacto_tpu_torch/analysis/
shardflow.py) against the JAX package's shardflow, and its gate.

- ``torch-shard-replicate``, ``torch-shard-kernel`` and
  ``torch-shard-break`` have fixture twins (a true positive exactly once,
  a negative, a suppressed twin); ``jax-shard-replicate``,
  ``jax-shard-pallas`` and ``jax-shard-break`` fire on their JAX twins
  (tests/test_lint.py's).
- The model over the port: the three CUDA entries are called only under
  ops/fused.py's device dispatch, and every line the data plane's
  collectives can be recorded at outside a traced program is known.
- The CPU gate: two gloo ranks through the repo's ``launch.py`` (this
  file is the worker) train the (dp=2, fs=4) mesh for 2 epochs under
  ``DIFACTO_HLOSCAN=1``: ``collmap --check`` passes on each rank's scan
  merged with the model. Then each rank gathers its whole table through
  the data plane (:func:`planted_table_gather`): caught statically (one
  ``torch-shard-replicate`` finding at the planted line) and dynamically
  (a table-axis all-gather; ``collmap --check`` fails), and a collective
  at a line the model does not know fails the check too.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import test_lint as TL  # noqa: E402
from difacto_tpu.analysis import core as jcore  # noqa: E402
from difacto_tpu_torch.analysis import core as tcore  # noqa: E402
from difacto_tpu_torch.analysis.shardflow import \
    get_shard_model  # noqa: E402
from difacto_tpu_torch.tools import collmap  # noqa: E402
from difacto_tpu_torch.utils import collscan  # noqa: E402

RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")
CAPACITY = 16384
THIS = "tests/test_torch_shardflow.py"

two_procs = pytest.mark.skipif(
    (os.cpu_count() or 1) < 2,
    reason="two gloo processes need >= 2 CPU cores")


def lint_files(tmp_path, files: dict, rules):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return tcore.run_project(tcore.Project(tmp_path, sorted(files)), rules)


FUSED = """
    def gather_rows_cuda(table, slots):
        return table[slots]
    def gather_rows(table, slots):
        if table.device.type == "cuda":
            return gather_rows_cuda(table, slots)
        return table[slots]
"""

# (torch rule, true positive, negative, JAX rule, JAX twin): each a
# project of files; the finding is always in mod.py
TORCH_SHARD = [
    ("torch-shard-replicate", {"mod.py": """
        import torch.distributed as dist
        def publish(state, out):
            dist.all_gather(out, state.VVg)
     """}, {"mod.py": """
        import torch.distributed as dist
        def publish(state, out, partials, plane, gw):
            dist.all_gather(out, partials)
            return plane.gather(gw), state.VVg.shape
     """}, "jax-shard-replicate", TL.SHARD_REPLICATE_TP),
    ("torch-shard-kernel", {"ops/fused.py": FUSED, "mod.py": """
        from ops import fused
        def pull(table, slots):
            return fused.gather_rows_cuda(table, slots)
     """}, {"ops/fused.py": FUSED, "mod.py": """
        from ops import fused
        def pull(table, slots):
            return fused.gather_rows(table, slots)
     """}, "jax-shard-pallas", TL.SHARD_PALLAS_TP),
    ("torch-shard-break", {"mod.py": """
        import torch
        from parallel.mesh import state_sharding
        def relay(mesh, state):
            shards = state_sharding(mesh)
            views = shards(state.VVg)
            return torch.cat(views)
     """}, {"mod.py": """
        from parallel import sharded
        from parallel.mesh import state_sharding
        def push(mesh, state, ss, rows):
            shards = state_sharding(mesh)
            sharded.sharded_scatter(shards(state.VVg), ss, rows)
            snapshot = state.VVg.clone()
            return snapshot
     """}, "jax-shard-break", TL.AXIS_BREAK_TP),
]
IDS = [r for r, *_ in TORCH_SHARD]


@pytest.mark.parametrize("rule,bad,good,jrule,jbad", TORCH_SHARD, ids=IDS)
def test_shard_rule_fires_exactly_once(tmp_path, rule, bad, good, jrule,
                                       jbad):
    found = lint_files(tmp_path, bad, [rule]).active
    assert len(found) == 1, found
    assert found[0].rule == rule and found[0].path == "mod.py"


@pytest.mark.parametrize("rule,bad,good,jrule,jbad", TORCH_SHARD, ids=IDS)
def test_shard_rule_negative_is_clean(tmp_path, rule, bad, good, jrule,
                                      jbad):
    assert lint_files(tmp_path, good, [rule]).active == []


@pytest.mark.parametrize("rule,bad,good,jrule,jbad", TORCH_SHARD, ids=IDS)
def test_shard_rule_suppressed_twin(tmp_path, rule, bad, good, jrule, jbad):
    tagged = dict(bad)
    tagged["mod.py"] = "\n".join(
        line + f"  # lint: ok({rule})" if line.strip() else line
        for line in textwrap.dedent(bad["mod.py"]).splitlines())
    res = lint_files(tmp_path, tagged, [rule])
    assert res.active == []
    assert sum(f.suppressed for f in res.findings) == 1


@pytest.mark.parametrize("rule,bad,good,jrule,jbad", TORCH_SHARD, ids=IDS)
def test_the_jax_shard_rule_fires_on_the_jax_twin(tmp_path, rule, bad, good,
                                                  jrule, jbad):
    (tmp_path / "mod.py").write_text(textwrap.dedent(jbad))
    found = jcore.run_project(jcore.Project(tmp_path, ["mod.py"]),
                              [jrule]).active
    assert [f.rule for f in found] == [jrule]


def test_shard_kernel_flags_an_unguarded_call_in_the_dispatch_file(
        tmp_path):
    found = lint_files(tmp_path, {"ops/fused.py": FUSED + """
    def pull_any(table, slots):
        return gather_rows_cuda(table, slots)
    """}, ["torch-shard-kernel"]).active
    assert len(found) == 1 and "device-type guard" in found[0].message


def test_shard_break_flags_a_whole_table_op_written_back(tmp_path):
    found = lint_files(tmp_path, {"mod.py": """
        from parallel.mesh import state_sharding
        def regrow(mesh, state):
            shards = state_sharding(mesh)
            state = state._replace(VVg=state.VVg.contiguous())
            return state, shards
     """}, ["torch-shard-break"]).active
    assert len(found) == 1 and "contiguous" in found[0].message


@pytest.fixture(scope="module")
def shard_model():
    return get_shard_model(tcore.Project(REPO, ["difacto_tpu_torch"]))


def test_the_cuda_entries_run_only_behind_the_dispatch(shard_model):
    calls = shard_model.kernel_calls
    assert len(calls) == 3 and all(calls.values()), calls
    assert all(s.startswith("difacto_tpu_torch/ops/fused.py:")
               for s in calls)


def test_the_data_planes_collective_lines_are_known(shard_model):
    sites = shard_model.collective_sites
    ln = next(i for i, s in enumerate(
        (REPO / "difacto_tpu_torch/parallel/multihost.py").read_text()
        .splitlines(), 1) if "dist.all_gather(list(out.unbind(0)), src)"
        in s)
    assert f"difacto_tpu_torch/parallel/multihost.py:{ln}" in sites
    # allreduce_np's callers, and the fault monitor's guarded call
    assert any(s.startswith("difacto_tpu_torch/learners/bcd.py:")
               for s in sites)
    assert any(s.startswith("difacto_tpu_torch/parallel/fault.py:")
               for s in sites)


# ------------------------------------------------------------- the gate
def planted_table_gather(ln):
    """The planted fault: a rank's whole table through the data plane."""
    from difacto_tpu_torch.parallel import sharded
    plane = ln.loss.plane
    table = sharded.host_state(ln.store.state).VVg
    return plane.gather(table)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_rank_gate(tmp_path_factory):
    d = tmp_path_factory.mktemp("shardflow_gate")
    env = dict(os.environ)
    env.update(PYTHONPATH=str(REPO), DIFACTO_TORCH_VIRTUAL_DEVICES="4",
               DIFACTO_HLOSCAN="1", DIFACTO_HLOSCAN_ROWS=str(CAPACITY))
    env.pop("DIFACTO_HLOSCAN_OUT", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "launch.py"), "-n", "2",
         "--port", str(_free_port()), "--",
         sys.executable, __file__, str(d)],
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    return d


def _collmap(path) -> int:
    return collmap.main(["--root", str(REPO), "--dynamic", str(path),
                         "--check"])


@two_procs
def test_two_rank_train_passes_collmap_against_the_model(two_rank_gate):
    for r in (0, 1):
        path = two_rank_gate / f"clean-{r}.json"
        graph = collmap.build(str(REPO), collscan.load(path))
        assert graph["programs"] and graph["unknown_collectives"] == []
        assert graph["table_hits"] == [] and graph["unknown_sites"] == []
        assert _collmap(path) == 0


@two_procs
def test_planted_table_gather_is_caught_statically_and_dynamically(
        two_rank_gate, capsys):
    res = tcore.run_project(tcore.Project(REPO, [THIS]),
                            ["torch-shard-replicate"])
    src = (REPO / THIS).read_text().splitlines()
    line = next(i for i, s in enumerate(src, 1)
                if "return plane.gather(table)" in s)
    assert [(f.rule, f.line) for f in res.active] == [
        ("torch-shard-replicate", line)]
    for r in (0, 1):
        path = two_rank_gate / f"planted-{r}.json"
        doc = collscan.load(path)
        hits = collscan.violations(doc["programs"])
        assert [h["kind"] for h in hits] == ["table-collective"]
        assert hits[0]["site"] == f"{THIS}:{line}"
        # a line no model of the port knows, and a table-axis gather
        graph = collmap.build(str(REPO), doc)
        assert graph["unknown_collectives"] == [f"{THIS}:{line}"]
        assert _collmap(path) == 1
    assert "UNKNOWN-COLLECTIVES" in capsys.readouterr().out


def _worker(out: pathlib.Path) -> None:
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.parallel.multihost import process_index
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
    collscan.dump(out / f"clean-{rank}.json")
    planted_table_gather(ln)
    collscan.dump(out / f"planted-{rank}.json")
    (out / f"done-{rank}").write_text(json.dumps({"rank": rank}))


if __name__ == "__main__":
    from difacto_tpu_torch.parallel.multihost import initialize
    initialize()
    _worker(pathlib.Path(sys.argv[1]))
