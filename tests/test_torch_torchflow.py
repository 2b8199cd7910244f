"""The port analyzer's traced-program model (difacto_tpu_torch/analysis/
torchflow.py) against the JAX package's jaxflow, and its gates.

- ``torch-recompile``, ``torch-host-sync`` and ``torch-inplace-flow``
  have fixture twins (a true positive exactly once, a negative, a
  suppressed twin); ``jax-recompile``, ``jax-host-sync`` and
  ``jax-donate-flow`` fire on their JAX twins (tests/test_lint.py's).
- The model over the port: the declared fetch points are JAX's static
  model's, file for file, plus the two the port declares where JAX syncs
  undeclared (``bcd.progress``, ``lbfgs.gram``) and the differences
  listed below; the hot roots correspond one to one (two renamed, one on
  each side a structural difference); the syncs chip_smoke.py's phase 21
  found outside declared points get the verdict JAX's model gives their
  counterparts: cold where JAX's is cold, hot where JAX's is hot, and
  then a reasoned suppression.
- The CPU gates, each in a subprocess under ``DIFACTO_JAXTRACE=1``: a
  served steady state and a 2-epoch train pass ``devmap --check``
  merged with the model; a grown signature at a site the model cannot
  bound, and an undeclared sync at a hot line the model does not know,
  fail it.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

import test_lint as TL
from difacto_tpu.analysis import core as jcore
from difacto_tpu.analysis.jaxflow import get_jax_model
from difacto_tpu_torch.analysis import core as tcore
from difacto_tpu_torch.analysis.torchflow import get_torch_model
from difacto_tpu_torch.tools import devmap

REPO = pathlib.Path(__file__).resolve().parent.parent
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")


def lint(tmp_path, src, rules):
    (tmp_path / "mod.py").write_text(textwrap.dedent(src))
    return tcore.run_project(tcore.Project(tmp_path, ["mod.py"]),
                             rules).active


def jlint(tmp_path, src, rules):
    (tmp_path / "mod.py").write_text(textwrap.dedent(src))
    return jcore.run_project(jcore.Project(tmp_path, ["mod.py"]),
                             rules).active


RECOMPILE_TP = """
    from utils import devtrace
    def f(x, n):
        return x
    g = devtrace.traced(f, statics=(1,))
    def hot(xs):
        for x in xs:
            g(x, len(x))
"""
HOST_SYNC_TP = """
    from utils import devtrace
    def f(x):
        return x
    step = devtrace.traced(f)
    def run(xs):
        out = 0.0
        for x in xs:
            y = step(x)
            out += float(y)
        return out
"""
INPLACE_FLOW_TP = """
    def inner(buf, rows):
        buf.copy_(rows)
    def outer(b, rows):
        old = b[:2]
        inner(b, rows)
        return old
"""

# (torch rule, true positive, negative, JAX rule, JAX twin)
TORCH_FLOW = [
    ("torch-recompile", RECOMPILE_TP, """
        from utils import devtrace
        def f(x, n):
            return x
        g = devtrace.traced(f, statics=(1,))
        CAP = 64
        def hot(xs, shapes):
            for x in xs:
                g(x, shapes.cap("b", len(x)))
                g(x[:shapes.cap("n", len(x))], CAP)
     """, "jax-recompile", TL.RECOMPILE_TP),
    ("torch-host-sync", HOST_SYNC_TP, """
        from utils import devtrace
        def f(x):
            return x
        step = devtrace.traced(f)
        def run(xs):
            out = 0.0
            for x in xs:
                y = step(x)
                out += float(devtrace.fetch(y, point="p"))
                y = devtrace.fetch(step(x), point="p")
                out += y.item()
            return out
        def once(x):
            return float(step(x))
     """, "jax-host-sync", TL.HOST_SYNC_TP),
    ("torch-inplace-flow", INPLACE_FLOW_TP, """
        def inner(buf, rows):
            buf.copy_(rows)
        def outer(b, rows):
            old = b[:2].clone()
            inner(b, rows)
            return old, b
     """, "jax-donate-flow", TL.DONATE_FLOW_TP),
]
IDS = [r for r, *_ in TORCH_FLOW]


@pytest.mark.parametrize("rule,bad,good,jrule,jbad", TORCH_FLOW, ids=IDS)
def test_flow_rule_fires_exactly_once(tmp_path, rule, bad, good, jrule,
                                      jbad):
    found = lint(tmp_path, bad, [rule])
    assert len(found) == 1, found
    assert found[0].rule == rule and found[0].message


@pytest.mark.parametrize("rule,bad,good,jrule,jbad", TORCH_FLOW, ids=IDS)
def test_flow_rule_negative_is_clean(tmp_path, rule, bad, good, jrule,
                                     jbad):
    assert lint(tmp_path, good, [rule]) == []


@pytest.mark.parametrize("rule,bad,good,jrule,jbad", TORCH_FLOW, ids=IDS)
def test_flow_rule_suppressed_twin(tmp_path, rule, bad, good, jrule, jbad):
    tagged = "\n".join(line + f"  # lint: ok({rule})" if line.strip()
                       else line
                       for line in textwrap.dedent(bad).splitlines())
    (tmp_path / "mod.py").write_text(tagged)
    res = tcore.run_project(tcore.Project(tmp_path, ["mod.py"]), [rule])
    assert res.active == []
    assert sum(f.suppressed for f in res.findings) == 1


@pytest.mark.parametrize("rule,bad,good,jrule,jbad", TORCH_FLOW, ids=IDS)
def test_the_jax_flow_rule_fires_on_the_jax_twin(tmp_path, rule, bad, good,
                                                 jrule, jbad):
    assert [f.rule for f in jlint(tmp_path, jbad, [jrule])] == [jrule]
    assert jlint(tmp_path, bad, [jrule]) == []


def test_recompile_flags_a_data_shaped_slice_and_a_wrapper_in_a_loop(
        tmp_path):
    found = lint(tmp_path, """
        from utils import devtrace
        def f(x):
            return x
        g = devtrace.traced(f)
        def hot(xs):
            for x in xs:
                g(x[:len(x) - 1].to("cpu"))
                h = devtrace.traced(f)
                h(x)
     """, ["torch-recompile"])
    assert len(found) == 2, found
    shape = [f.message for f in found if "shape of argument 0" in f.message]
    loop = [f.message for f in found if "inside a loop" in f.message]
    assert len(shape) == len(loop) == 1 and "len(...)" in shape[0]


def test_host_sync_through_a_helper_that_returns_a_device_value(tmp_path):
    found = lint(tmp_path, """
        from utils import devtrace
        def f(x):
            return x
        step = devtrace.traced(f)
        def helper(x):
            return step(x)
        def run(xs):
            for x in xs:
                v = helper(x)
                print(v.tolist())
     """, ["torch-host-sync"])
    assert len(found) == 1 and "tolist" in found[0].message


def test_inplace_flow_follows_a_kernel_entry_through_a_helper(tmp_path):
    found = lint(tmp_path, """
        from ops import fused
        def push(table, slots, rows):
            fused.fm_update_rows(table, slots, rows, 0, 0, 0, 0, 0)
        def step(table, slots, rows):
            push(table, slots, rows)
        def train(table, slots, rows):
            first = table[0]
            step(table, slots, rows)
            return first
     """, ["torch-inplace-flow"])
    assert len(found) == 1 and "step" in found[0].message


# ---------------------------------------------------------- the models
@pytest.fixture(scope="module")
def models():
    port = get_torch_model(tcore.Project(REPO, ["difacto_tpu_torch"]))
    jax = get_jax_model(jcore.Project(REPO, ["difacto_tpu"]))
    return port, jax


def _jax_points(jm) -> dict:
    """file (package-relative) -> the point names of JAX's declared
    fetches (the ``point=`` literal of each ``jaxtrace.fetch`` site)."""
    import ast
    out = {}
    for site in jm.fetch_sites:
        rel, line = site.rsplit(":", 1)
        sf = next(s for s in jm.project.files if s.rel == rel)
        call = next(n for n in sf.call_nodes() if n.lineno == int(line)
                    and jcore.call_name(n).endswith("jaxtrace.fetch"))
        point = next((k.value.value for k in call.keywords
                      if k.arg == "point"
                      and isinstance(k.value, ast.Constant)), "")
        out.setdefault(rel.split("/", 1)[1], set()).add(point)
    return out


def _port_points(tm) -> dict:
    out = {}
    for site, p in tm.fetch_sites.items():
        rel = site.rsplit(":", 1)[0].split("/", 1)[1]
        out.setdefault(rel, set()).update([p] if isinstance(p, str) else p)
    return out


# The port's declared fetch points beyond JAX's, file by file: the two
# JAX syncs undeclared (ROADMAP Queue 3, "Found in the reference"), and
# copies the port makes where JAX needs none: its executor's warm-up
# fetch, L-BFGS's warm start and save (JAX reads its arrays with
# np.asarray on the host), and the data plane's host staging of what
# gloo moves (JAX's collectives stay inside XLA).
PORT_ONLY = {
    "learners/bcd.py": {"bcd.progress"},
    "learners/lbfgs.py": {"lbfgs.gram", "lbfgs.warm_start", "lbfgs.save"},
    "serve/executor.py": {"serve.warm"},
    "parallel/multihost.py": {"multihost.allgather",
                              "multihost.to_local_numpy",
                              "multihost.plane_stage"},
}
# JAX's declared points the port has no site for: task=pred runs through
# the executor's serve.scores in the port, not through the learner
JAX_ONLY = {"learners/sgd.py": {"sgd.pred"}}


def test_declared_fetch_points_are_jaxs_plus_the_listed(models):
    port, jax = models
    got, want = _port_points(port), _jax_points(jax)
    for rel in sorted(set(got) | set(want)):
        assert got.get(rel, set()) == (
            want.get(rel, set()) - JAX_ONLY.get(rel, set())
        ) | PORT_ONLY.get(rel, set()), rel
    assert {"bcd.progress", "lbfgs.gram"} <= port.points()
    assert not ({"bcd.progress", "lbfgs.gram"} & set().union(*want.values()))


# JAX's hot root -> the port's (package-relative quals)
RENAMED = {
    "learners/sgd.py::SGDLearner._iterate_data_spmd":
        "learners/sgd.py::SGDLearner._iterate_spmd",
    "learners/sgd.py::SGDLearner._run_epoch_body":
        "learners/sgd.py::SGDLearner._run_epoch_spmd",
}
# a root on one side only: JAX repads its staged batches with a jitted
# program per batch, the port with eager ops (no program in the loop);
# the port's BCD loops its dp row shards on the host where JAX's one
# jitted program spans them
JAX_ONLY_ROOTS = {"learners/sgd.py::SGDLearner._repad_cache"}
PORT_ONLY_ROOTS = {"learners/bcd.py::BCDLearner._slice_grad"}


def test_hot_roots_correspond_one_to_one(models):
    port, jax = models
    pr = {q.split("/", 1)[1] for q in port.hot_roots}
    jr = {q.split("/", 1)[1] for q in jax.hot_roots}
    mapped = {RENAMED.get(q, q) for q in jr - JAX_ONLY_ROOTS}
    assert len(mapped) == len(jr - JAX_ONLY_ROOTS)
    assert mapped == pr - PORT_ONLY_ROOTS
    assert JAX_ONLY_ROOTS <= jr and PORT_ONLY_ROOTS <= pr
    assert not (JAX_ONLY_ROOTS & pr)


def _hot_qual(model, rel: str, line: int):
    for qual in model.hot_funcs:
        fi = model.cg.funcs.get(qual)
        if fi is not None and fi.node is not None and fi.sf.rel == rel \
                and fi.node.lineno <= line <= fi.node.end_lineno:
            return qual
    return None


def _line_of(rel: str, needle: str) -> int:
    lines = (REPO / rel).read_text().splitlines()
    return next(i for i, s in enumerate(lines, 1) if needle in s)


def test_phase_21_syncs_get_jaxs_verdicts(models):
    """store/local.py's evaluate (cold in both), store/convert.py's
    column copy (JAX: SlotStore._state_np, hot in both) and task=pred's
    per-window metrics (JAX: the CLI's main, cold in both package
    models): the port's hot one carries a reasoned torch-host-sync
    suppression, and neither model has an active finding there."""
    port, jax = models
    cases = [
        ("difacto_tpu_torch/store/local.py",
         "return float(penalty), float(nnz)",
         "difacto_tpu/store/local.py", "return float(penalty), float(nnz)"),
        ("difacto_tpu_torch/store/convert.py",
         "out = {f: cols[f].cpu() for f in keys}",
         "difacto_tpu/store/local.py", "def _state_np("),
        ("difacto_tpu_torch/__main__.py", "objv += float(o)",
         "difacto_tpu/__main__.py", "def main("),
        ("difacto_tpu_torch/__main__.py", "auc += float(a)",
         "difacto_tpu/__main__.py", "def main("),
    ]
    verdicts = {}
    for prel, pneedle, jrel, jneedle in cases:
        pl, jl = _line_of(prel, pneedle), _line_of(jrel, jneedle)
        if jneedle.startswith("def "):
            jl += 1
        p_hot = port.hot_line(f"{prel}:{pl}") is not None
        j_hot = _hot_qual(jax, jrel, jl) is not None
        assert p_hot == j_hot, (prel, pl, jrel, jl)
        verdict = port.sync_verdict(f"{prel}:{pl}")
        assert verdict == ("suppressed" if p_hot else "cold"), (prel, pl)
        verdicts[pneedle] = verdict
    assert list(verdicts.values()) == ["cold", "suppressed", "cold",
                                       "cold"]


def test_every_traced_site_is_warm_and_indexed(models):
    port, _ = models
    warm = port.known_warm()
    progs = {s: r for s, r in port.sites.items() if r.kind == "program"}
    assert len(progs) >= 13 and set(progs) <= warm
    for sid, site in progs.items():
        assert site.call_sites, f"{sid}: no call site found"
    # the capacity report's steps come back from _synthetic_step
    cap = [s for s in progs if "parallel/capacity.py" in s][0]
    assert len(progs[cap].call_sites) >= 4


# ------------------------------------------------------------ the gates
GATES = """
import json, sys
import numpy as np
from difacto_tpu_torch.data.rowblock import RowBlock
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.serve.batcher import MicroBatcher
from difacto_tpu_torch.serve.executor import PredictExecutor
from difacto_tpu_torch.store.local import SlotStore
from difacto_tpu_torch.updaters.sgd_updater import SGDUpdaterParam
from difacto_tpu_torch.utils import devtrace

out, rcv1 = sys.argv[1], sys.argv[2]
# the serve steady state: 3 warm windows, then 10 more
store = SlotStore(SGDUpdaterParam(V_dim=4, hash_capacity=1024),
                  device="cpu")
ex = PredictExecutor(store)
bat = MicroBatcher(ex.predict_scores, batch_size=4, queue_cap=64)
bat.start()
idx = (np.arange(16, dtype=np.uint32) * 7) % 97
blk = lambda: RowBlock(offset=np.arange(0, 17, 4, dtype=np.int64),
                       label=np.zeros(4, np.float32), index=idx,
                       value=None, weight=None)
for _ in range(3):
    bat.submit(blk()).result(60)
devtrace.dump(out + "/serve-warm.json")
for _ in range(10):
    bat.submit(blk()).result(60)
bat.close()
devtrace.dump(out + "/serve.json")
# a 2-epoch train with the replay cache (epoch 1 replays)
devtrace.reset()
ln = SGDLearner(device="cpu")
ln.init([("data_in", rcv1), ("data_val", rcv1), ("V_dim", "2"),
         ("hash_capacity", "4096"), ("batch_size", "10"),
         ("num_jobs_per_epoch", "2"), ("max_num_epochs", "2"),
         ("stop_rel_objv", "0"), ("report_interval", "0")])
ln.run()
devtrace.dump(out + "/train.json")
"""


@pytest.fixture(scope="module")
def gate_dumps(tmp_path_factory):
    d = tmp_path_factory.mktemp("torchflow_gates")
    env = dict(os.environ, DIFACTO_JAXTRACE="1", PYTHONPATH=str(REPO))
    env.pop("DIFACTO_HLOSCAN", None)
    r = subprocess.run([sys.executable, "-c", GATES, str(d), RCV1],
                       cwd=str(REPO), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return d


def _check(*args) -> int:
    return devmap.main(["--root", str(REPO), "--check"] + list(args))


def test_serve_steady_state_gate(gate_dumps, capsys):
    warm, final = gate_dumps / "serve-warm.json", gate_dumps / "serve.json"
    assert _check("--dynamic", str(final), "--warm", str(warm)) == 0
    graph = devmap.build(str(REPO), json.loads(final.read_text()),
                         json.loads(warm.read_text()))
    called = {s: r for s, r in graph["dynamic_sites"].items()
              if r["calls"]}
    assert called and all(graph["sites"][s]["warm_bounded"]
                          for s in called)
    assert all(r["compiles"] == 1 for r in called.values())


def test_two_epoch_train_gate(gate_dumps):
    path = gate_dumps / "train.json"
    assert _check("--dynamic", str(path)) == 0
    graph = devmap.build(str(REPO), json.loads(path.read_text()))
    called = {s: r for s, r in graph["dynamic_sites"].items()
              if r["calls"]}
    # the train, eval and count-push programs ran, at sites the model
    # knows and proves bounded
    labels = {graph["sites"][s]["label"] for s in called}
    assert {"train_step", "eval_step"} <= labels, labels
    assert all(graph["sites"][s]["warm_bounded"] for s in called)
    assert graph["unbounded_growth"] == graph["unknown_syncs"] == []


def test_devmap_check_fails_on_unbounded_growth_and_unknown_syncs(
        gate_dumps, tmp_path, monkeypatch):
    """A grown site the model cannot bound, and an undeclared sync at a
    hot line it neither flags nor suppresses, fail the check; a sync at
    a suppressed hot line or a cold one passes."""
    doc = json.loads((gate_dumps / "train.json").read_text())
    site = next(s for s in doc["sites"] if "learners/sgd.py" in s)
    tm, _ = devmap.models(str(REPO))
    monkeypatch.setattr(tm, "known_warm", lambda: set())
    grown = dict(doc, sites={site: dict(doc["sites"][site], compiles=3)})
    p = tmp_path / "grown.json"
    p.write_text(json.dumps(grown))
    assert _check("--dynamic", str(p)) == 1
    monkeypatch.undo()
    hot = next(iter(sorted(
        f"{tm.cg.funcs[q].sf.rel}:{tm.cg.funcs[q].node.lineno + 1}"
        for q in tm.hot_funcs if "learners/sgd.py::SGDLearner._replay"
        in q)))
    assert tm.sync_verdict(hot) == "unknown"
    suppressed = f"difacto_tpu_torch/__main__.py:" \
        f"{_line_of('difacto_tpu_torch/__main__.py', 'objv += float(o)')}"
    cold = f"difacto_tpu_torch/store/local.py:" \
        f"{_line_of('difacto_tpu_torch/store/local.py', 'float(penalty)')}"
    for sites, rc in (([hot], 1), ([suppressed, cold], 0)):
        syncs = {s: {"count": 2, "serve": 0, "in_program": 0}
                 for s in sites}
        p.write_text(json.dumps(dict(doc, syncs=syncs)))
        assert _check("--dynamic", str(p)) == rc, sites
