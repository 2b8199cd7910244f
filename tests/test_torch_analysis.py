"""The port's analyzer (difacto_tpu_torch/analysis) against the JAX
package's (difacto_tpu/analysis), and its local torch rules.

- The jax-free rules (thread, lock, resource, clock, except, registry,
  lock-order, lock-blocking, cond-wait, data-race) are the JAX
  analyzer's: the same ids and summaries, and on tests/test_lint.py's
  own fixtures — every jax-free test there run with a ``core`` that
  lints each fixture project with both analyzers — the same findings:
  rule ids, lines, messages, fingerprints and suppressions. Over the
  port tree both give the same jax-free findings (0 active each).
- ``torch-inplace``, ``torch-traced-capture``, ``torch-host-call`` and
  ``torch-dtype64`` have fixture twins: a true positive exactly once, a
  negative, and a suppressed twin; the JAX rule each replaces fires on
  its JAX twin (tests/test_lint.py's fixture).
- The CLI: the JAX CLI's flags and formats over the port (0 findings,
  exit 0, every format), its default paths, a baseline round trip,
  ``--changed-only``, and ``--write-lockorder``.
"""

import inspect
import json
import pathlib
import textwrap

import pytest

import test_lint as TL
from difacto_tpu.analysis import core as jcore
from difacto_tpu_torch.analysis import cli as tcli
from difacto_tpu_torch.analysis import core as tcore

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = "difacto_tpu_torch"
# the JAX analyzer's project layout, for the port's twin of a fixture
JAX_LAYOUT = dict(
    docs_dir="docs", readme_section=None, doc_sources=(),
    handler_files=("difacto_tpu/serve/server.py",
                   "difacto_tpu/serve/router.py"),
    sender_files=("difacto_tpu/serve/client.py", "difacto_tpu/serve/fleet.py",
                  "tools/", "bench.py", "launch.py"),
    kinds_file="difacto_tpu/utils/faultinject.py",
    metrics_doc="docs/observability.md",
    metrics_impl_files=("difacto_tpu/obs/metrics.py",))


def _jax_free(rules) -> list:
    return sorted(r for r in rules if not r.startswith("jax-"))


def _key(findings) -> list:
    return sorted((f.rule, f.path, f.line, f.message, f.fingerprint(),
                   f.suppressed) for f in findings)


class DualCore:
    """tests/test_lint.py's ``core`` with every fixture project linted by
    both analyzers: ``run_project`` returns the JAX result after holding
    the port's jax-free findings equal to it."""

    def __init__(self):
        self.compared = 0

    def __getattr__(self, name):
        return getattr(jcore, name)

    def Project(self, root, lint_paths=None, **kw):
        project = jcore.Project(root, lint_paths, **kw)
        project.port_twin = tcore.Project(root, lint_paths,
                                          **dict(JAX_LAYOUT, **kw))
        return project

    def run_project(self, project, rule_ids=None, local_files=None):
        res = jcore.run_project(project, rule_ids, local_files)
        twin = getattr(project, "port_twin", None)
        free = _jax_free(rule_ids if rule_ids is not None
                         else jcore.all_rules())
        if twin is not None and free:
            port = tcore.run_project(twin, free, local_files)
            want = [f for f in res.findings if not f.rule.startswith("jax-")]
            assert _key(port.findings) == _key(want)
            self.compared += 1
        return res


def test_the_jax_free_rules_are_the_jax_analyzers():
    jr, tr = jcore.all_rules(), tcore.all_rules()
    free = _jax_free(jr)
    assert [r for r in sorted(tr) if not r.startswith("torch-")] == free
    for rid in free:
        assert (tr[rid].summary, tr[rid].cross) == \
            (jr[rid].summary, jr[rid].cross), rid
    torch_rules = sorted(r for r in tr if r.startswith("torch-"))
    assert torch_rules == [
        "torch-dtype64", "torch-host-call", "torch-host-sync",
        "torch-inplace", "torch-inplace-flow", "torch-recompile",
        "torch-shard-break", "torch-shard-kernel", "torch-shard-replicate",
        "torch-traced-capture"]


# tests/test_lint.py's tests that lint fixtures with jax-free rules only
# through its ``core`` (its parametrized ones run once per jax-free case)
PARITY_TESTS = sorted(
    name for name, fn in vars(TL).items()
    if name.startswith("test_") and callable(fn)
    and not name.startswith(("test_jax_", "test_locktrace",
                             "test_lockmap", "test_shared_",
                             "test_racetrace", "test_the_tree",
                             "test_json_", "test_github_", "test_sarif",
                             "test_baseline_", "test_unknown_rule",
                             "test_list_rules", "test_changed_only",
                             "test_jit_method")))


def _cases(name):
    """Argument sets for one test_lint test: its parametrized cases
    (jax-free only) or one plain call."""
    if name.startswith("test_local_rule_"):
        return [dict(rule=r, bad=b, good=g) for r, b, g in TL.LOCAL_FIXTURES
                if not r.startswith("jax-")]
    if name == "test_thread_target_forms_become_roots":
        return [dict(form=f, src=s) for f, s in TL.THREAD_FORMS]
    return [{}]


@pytest.mark.parametrize("name", PARITY_TESTS)
def test_jax_free_findings_equal_on_test_lints_fixtures(
        name, tmp_path, monkeypatch, capsys):
    dual = DualCore()
    monkeypatch.setattr(TL, "core", dual)
    fn = getattr(TL, name)
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
                "capsys": capsys}
    for i, case in enumerate(_cases(name)):
        d = tmp_path / f"case{i}"
        d.mkdir()
        fixtures["tmp_path"] = d
        kw = {p: fixtures[p] for p in inspect.signature(fn).parameters
              if p in fixtures}
        fn(**dict(kw, **case))
    if name != "test_thread_target_forms_become_roots":
        assert dual.compared, f"{name} linted nothing through core"


def test_port_tree_gives_both_analyzers_the_same_findings():
    """Over difacto_tpu_torch/, in the JAX analyzer's layout, both give
    the same jax-free findings (all of them suppressed); the port's own
    layout gives none active either."""
    rules = _jax_free(jcore.all_rules())
    jres = jcore.run_project(jcore.Project(REPO, [PORT]), rules)
    tres = tcore.run_project(tcore.Project(REPO, [PORT], **JAX_LAYOUT),
                             rules)
    assert _key(tres.findings) == _key(jres.findings)
    assert jres.active == [] and tres.findings
    own = tcore.run_project(tcore.Project(REPO, [PORT]))
    assert own.active == [] and own.counts()["files"] >= 100


def test_port_tree_lints_the_root_tool_counterparts():
    """The counterparts of the root obs_report, lockmap and
    collision_study, and the mesh's placement modules, are in the tree
    the port's analyzer lints, with 0 active findings."""
    project = tcore.Project(REPO, [PORT])
    rels = {sf.rel for sf in project.files}
    for mod in ("tools/obs_report.py", "tools/lockmap.py",
                "tools/collision_study.py", "parallel/mesh.py",
                "parallel/sharded.py"):
        assert f"{PORT}/{mod}" in rels, mod
    assert tcore.run_project(project).active == []


def test_default_paths_are_the_port_and_the_smoke(capsys):
    assert tcli.DEFAULT_PATHS == [PORT, "chip_smoke.py"]
    rc = tcli.main(["--root", str(REPO), "--baseline", "none"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert " 0 finding(s)" in out


@pytest.mark.parametrize("fmt", ["text", "json", "github", "sarif"])
def test_cli_formats_over_the_port(fmt, capsys):
    rc = tcli.main([PORT, "--root", str(REPO), "--baseline", "none",
                    "--format", fmt])
    out = capsys.readouterr().out
    assert rc == 0, out[-2000:]
    if fmt == "json":
        doc = json.loads(out)
        assert doc["counts"]["active"] == 0 and doc["rule_seconds"]
        assert set(doc["rule_seconds"]) == set(tcore.all_rules())
    elif fmt == "sarif":
        assert json.loads(out)["runs"][0]["results"] == []
    elif fmt == "github":
        assert "difacto-lint::clean" in out
    else:
        assert " 0 finding(s)" in out


def test_cli_baseline_round_trip_and_exit_codes(tmp_path, capsys):
    (tmp_path / "mod.py").write_text("import time\nT0 = time.time()\n")
    base = str(tmp_path / "base.json")
    args = ["mod.py", "--root", str(tmp_path)]
    assert tcli.main(args + ["--baseline", "none"]) == 1
    assert tcli.main(args + ["--baseline", base,
                             "--write-baseline"]) == 0
    assert tcli.main(args + ["--baseline", base]) == 0
    (tmp_path / "mod.py").write_text("T0 = 1\n")
    assert tcli.main(args + ["--baseline", base]) == 0
    assert "expired entry" in capsys.readouterr().out
    assert tcli.main(args + ["--rules", "no-such-rule"]) == 2


def test_cli_changed_only_limits_local_rules(tmp_path, monkeypatch,
                                             capsys):
    (tmp_path / "a.py").write_text("import time\nA = time.time()\n")
    (tmp_path / "b.py").write_text("import time\nB = time.time()\n")
    monkeypatch.setattr(tcli, "changed_files", lambda root, base: {"b.py"})
    rc = tcli.main(["a.py", "b.py", "--root", str(tmp_path),
                    "--baseline", "none", "--changed-only",
                    "--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert {f["path"] for f in doc["findings"]} == {"b.py"}


def test_cli_writes_the_committed_lock_graph(tmp_path, capsys):
    target = tmp_path / PORT / "utils"
    target.mkdir(parents=True)
    src = REPO / PORT
    for p in sorted(src.rglob("*.py")):
        q = tmp_path / p.relative_to(REPO)
        q.parent.mkdir(parents=True, exist_ok=True)
        q.write_text(p.read_text())
    assert tcli.main(["--root", str(tmp_path), "--write-lockorder"]) == 0
    wrote = json.loads((target / "lockorder.json").read_text())
    committed = json.loads((src / "utils" / "lockorder.json").read_text())
    assert wrote == committed


# ------------------------------------------------- the local torch rules
def lint(tmp_path, src, rules):
    (tmp_path / "mod.py").write_text(textwrap.dedent(src))
    return tcore.run_project(tcore.Project(tmp_path, ["mod.py"]),
                             rules).active


def _jax_fixture(rule):
    return next(b for r, b, _ in TL.LOCAL_FIXTURES if r == rule)


# (torch rule, true positive, negative, the JAX rule it replaces)
TORCH_LOCAL = [
    ("torch-inplace", """
        import torch
        def run(table, slots, rows):
            before = table[:4]
            table.index_copy_(0, slots, rows)
            return before.sum()
     """, """
        import torch
        def run(table, slots, rows):
            before = table[:4].clone()
            table.index_copy_(0, slots, rows)
            return before.sum() + table[:4].sum()
        def rebound(table, slots, rows):
            before = table[:4]
            table.index_copy_(0, slots, rows)
            before = table[4:8]
            return before.sum()
     """, "jax-donate"),
    ("torch-traced-capture", """
        from utils import devtrace
        class Model:
            def make(self):
                @devtrace.traced
                def inner(a):
                    return a * self.scale
                return inner
     """, """
        from utils import devtrace
        class Model:
            def init(self, c):
                self.reg_c = c
            def make(self):
                scale = self.scale
                @devtrace.traced
                def inner(a, s):
                    return a * s
                return inner, scale
            @devtrace.traced
            def objv(self, w):
                return self.reg_c * w
     """, "jax-jit-capture"),
    ("torch-host-call", """
        import numpy as np
        from utils import devtrace
        def f(a):
            return np.sum(a)
        step = devtrace.traced(f)
     """, """
        import numpy as np
        import torch
        from utils import devtrace
        def f(a):
            return torch.sum(a.to(torch.float32))
        step = devtrace.traced(f)
        def host(a):
            return np.sum(a)
     """, "jax-host-call"),
    ("torch-dtype64", """
        import torch
        from utils import devtrace
        def f(a):
            return a * torch.tensor(2.0, dtype=torch.float64)
        step = devtrace.traced(f)
     """, """
        import numpy as np
        import torch
        from utils import devtrace
        def f(a):
            return a * 2.0
        step = devtrace.traced(f)
        def host_exact(xs):
            # host-side float64 is deliberate (exact sums, the solvers)
            t = torch.zeros(3, dtype=torch.float64, device="cpu")
            return np.float64(2.0) * np.sum(xs) + t
     """, "jax-dtype64"),
]


@pytest.mark.parametrize("rule,bad,good,jrule", TORCH_LOCAL,
                         ids=[r for r, *_ in TORCH_LOCAL])
def test_torch_local_rule_fires_exactly_once(tmp_path, rule, bad, good,
                                             jrule):
    found = lint(tmp_path, bad, [rule])
    assert len(found) == 1, found
    assert found[0].rule == rule and found[0].line > 0


@pytest.mark.parametrize("rule,bad,good,jrule", TORCH_LOCAL,
                         ids=[r for r, *_ in TORCH_LOCAL])
def test_torch_local_rule_negative_is_clean(tmp_path, rule, bad, good,
                                            jrule):
    assert lint(tmp_path, good, [rule]) == []


@pytest.mark.parametrize("rule,bad,good,jrule", TORCH_LOCAL,
                         ids=[r for r, *_ in TORCH_LOCAL])
def test_torch_local_rule_suppressed_twin(tmp_path, rule, bad, good, jrule):
    tagged = "\n".join(line + f"  # lint: ok({rule})" if line.strip()
                       else line
                       for line in textwrap.dedent(bad).splitlines())
    (tmp_path / "mod.py").write_text(tagged)
    res = tcore.run_project(tcore.Project(tmp_path, ["mod.py"]), [rule])
    assert res.active == []
    assert sum(f.suppressed for f in res.findings) == 1


@pytest.mark.parametrize("rule,bad,good,jrule", TORCH_LOCAL,
                         ids=[r for r, *_ in TORCH_LOCAL])
def test_the_jax_rule_fires_on_the_jax_twin(tmp_path, rule, bad, good,
                                            jrule):
    (tmp_path / "mod.py").write_text(textwrap.dedent(_jax_fixture(jrule)))
    found = jcore.run_project(jcore.Project(tmp_path, ["mod.py"]),
                              [jrule]).active
    assert [f.rule for f in found] == [jrule]
    # the JAX rule sees nothing in the torch twin
    (tmp_path / "mod.py").write_text(textwrap.dedent(bad))
    assert jcore.run_project(jcore.Project(tmp_path, ["mod.py"]),
                             [jrule]).active == []


def test_traced_method_reading_loop_rebound_state_is_flagged(tmp_path):
    found = lint(tmp_path, """
        from utils import devtrace
        class Learner:
            def run(self, steps):
                for g in steps:
                    self.weights = self.weights + g
                    self.step(g)
            @devtrace.traced
            def step(self, g):
                return self.weights * g
     """, ["torch-traced-capture"])
    assert len(found) == 1 and "self.weights" in found[0].message


def test_host_call_catches_a_sync_inside_a_traced_program(tmp_path):
    found = lint(tmp_path, """
        from utils import devtrace
        def f(a):
            n = a.sum().item()
            return a / n
        step = devtrace.traced(f)
     """, ["torch-host-call"])
    assert len(found) == 1 and ".item()" in found[0].message


def test_the_inplace_kernel_entries_count_as_updates(tmp_path):
    found = lint(tmp_path, """
        from ops import fused
        def push(table, slots, rows):
            head = table[:8]
            fused.scatter_rows(table, slots, rows)
            return head
     """, ["torch-inplace"])
    assert len(found) == 1 and "scatter_rows" in found[0].message
