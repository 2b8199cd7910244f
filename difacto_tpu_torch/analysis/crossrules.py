"""Project-wide registry-drift rules (a copy of
difacto_tpu/analysis/crossrules.py).

Four registries in this tree are held together by free strings that
must stay in sync across files (and with the docs catalogs):

- **fault points** — every ``faultinject.fire("point")`` site must be
  armed by at least one chaos-test arm (with a kind from ``KINDS``)
  and listed in the docs, or the chaos harness silently stops covering
  that path.
- **metric names** — one name, one type, and a docs/observability.md
  catalog entry; a counter re-registered as a gauge elsewhere merges
  into garbage at snapshot-fold time.
- **#control lines** — a literal handled by the server/router with no
  sender (or vice versa) is dead wire protocol; both ends plus the
  docs must agree.
- **config knobs** — raw ``k == "name"`` kwargs reads must name a
  declared ``Param`` field, and every ``DIFACTO_*`` env knob read must
  be documented.

Cross rules see the :class:`core.Project` index (all linted files plus
the docs/tests reference corpora). When the relevant handler/sender
files are not part of the lint set (single-file runs), the two-way
control check degrades to the directions it can still prove.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import (Finding, Project, SourceFile, call_name, dotted,
                   rule, str_const)

# ---------------------------------------------------------------------------
# fault points

_ARM_RE = re.compile(r"([a-z0-9_]+(?:\.[a-z0-9_]+)+):([a-z_]+)[@=]")
_DEFAULT_KINDS = ("err", "truncate", "close", "delay_ms", "kill")


def _fire_sites(project: Project) -> List[Tuple[str, SourceFile, ast.Call]]:
    sites = []
    for sf in project.files:
        if sf.tree is None or sf.rel == project.kinds_file:
            continue
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            cn = call_name(node)
            if (cn == "fire" or cn.endswith(".fire")) and node.args:
                point = str_const(node.args[0])
                if point:
                    sites.append((point, sf, node))
            for kw in node.keywords:
                if kw.arg == "fault_point":
                    point = str_const(kw.value)
                    if point:
                        sites.append((point, sf, node))
    return sites


def _declared_kinds(project: Project) -> Tuple[str, ...]:
    p = project.root / project.kinds_file
    if not p.exists():
        return _DEFAULT_KINDS
    try:
        tree = ast.parse(p.read_text(encoding="utf-8"))
    except SyntaxError:
        return _DEFAULT_KINDS
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "KINDS"
                        for t in node.targets) \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            kinds = tuple(str_const(e) for e in node.value.elts)
            if all(kinds):
                return kinds
    return _DEFAULT_KINDS


@rule("fault-registry",
      "every fault point needs a KINDS-valid chaos-test arm and a "
      "docs entry", cross=True)
def check_fault_registry(project: Project) -> List[Finding]:
    out = []
    tests = project.tests_text()
    docs = project.docs_text()
    kinds = set(_declared_kinds(project))
    armed_kinds: Dict[str, Set[str]] = {}
    for point, kind in _ARM_RE.findall(tests):
        armed_kinds.setdefault(point, set()).add(kind)
    seen: Set[str] = set()
    for point, sf, node in _fire_sites(project):
        if point in seen:
            continue
        seen.add(point)
        if point not in tests:
            out.append(sf.finding(
                "fault-registry", node,
                f"fault point \"{point}\" is never armed by the test "
                f"suite — add a chaos-test arm (DIFACTO_FAULTS="
                f"\"{point}:<kind>@1\") so the failure path stays "
                f"covered"))
        else:
            bad = armed_kinds.get(point, set()) - kinds
            if bad:
                out.append(sf.finding(
                    "fault-registry", node,
                    f"tests arm fault point \"{point}\" with unknown "
                    f"kind(s) {sorted(bad)} — KINDS is "
                    f"{sorted(kinds)}; the arm silently never fires"))
        if point not in docs:
            out.append(sf.finding(
                "fault-registry", node,
                f"fault point \"{point}\" is undocumented — add it to "
                f"the docs fault-point catalog (docs/serving.md)"))
    return out


# ---------------------------------------------------------------------------
# metric names

_METRIC_FNS = ("counter", "gauge", "histogram")


@rule("metric-registry",
      "one metric name, one type, one docs catalog entry", cross=True)
def check_metric_registry(project: Project) -> List[Finding]:
    out = []
    doc_text = project.metrics_catalog()
    first: Dict[str, Tuple[str, SourceFile, ast.Call]] = {}
    for sf in project.files:
        if sf.tree is None or sf.rel in project.metrics_impl_files:
            continue
        for node in sf.walk():
            if not isinstance(node, ast.Call) or not node.args:
                continue
            cn = call_name(node)
            kind = cn.rsplit(".", 1)[-1]
            if kind not in _METRIC_FNS:
                continue
            name = str_const(node.args[0])
            if not name or not re.fullmatch(r"[a-z][a-z0-9_]+", name):
                continue
            if name in first:
                k0, sf0, n0 = first[name]
                if kind != k0:
                    out.append(sf.finding(
                        "metric-registry", node,
                        f"metric \"{name}\" registered as {kind} here "
                        f"but as {k0} at {sf0.rel}:{n0.lineno} — one "
                        f"name must keep one type or snapshot folds "
                        f"merge garbage"))
                continue
            first[name] = (kind, sf, node)
            if name not in doc_text:
                out.append(sf.finding(
                    "metric-registry", node,
                    f"metric \"{name}\" ({kind}) is missing from the "
                    f"{project.metrics_doc or 'docs'} catalog — "
                    f"document it or "
                    f"it drifts unnamed"))
    return out


# ---------------------------------------------------------------------------
# control lines

_CTRL_RE = re.compile(r"#[a-z][a-z_]*\Z")


def _control_literals(files: List[SourceFile]) \
        -> Dict[str, Tuple[SourceFile, ast.Constant]]:
    out: Dict[str, Tuple[SourceFile, ast.Constant]] = {}
    for sf in files:
        if sf.tree is None:
            continue
        for node in sf.walk():
            s = str_const(node)
            if s is None:
                continue
            s = s.strip()
            if _CTRL_RE.fullmatch(s) and s not in out:
                out[s] = (sf, node)
    return out


@rule("control-registry",
      "#control lines need both a handler and a sender (and a docs "
      "entry)", cross=True)
def check_control_registry(project: Project) -> List[Finding]:
    handlers = _control_literals(project.match_files(project.handler_files))
    senders = _control_literals(project.match_files(project.sender_files))
    docs = project.docs_text()
    out = []
    if senders:
        for line, (sf, node) in sorted(handlers.items()):
            if line not in senders:
                out.append(sf.finding(
                    "control-registry", node,
                    f"control line \"{line}\" is handled here but no "
                    f"client/fleet/tool ever sends it — dead protocol "
                    f"or a missing sender"))
    if handlers:
        for line, (sf, node) in sorted(senders.items()):
            if line not in handlers:
                out.append(sf.finding(
                    "control-registry", node,
                    f"control line \"{line}\" is sent here but the "
                    f"server/router never handles it — the peer will "
                    f"parse it as a data row"))
    for line, (sf, node) in sorted(handlers.items()):
        if line not in docs:
            out.append(sf.finding(
                "control-registry", node,
                f"control line \"{line}\" is undocumented — add it to "
                f"the docs wire-protocol catalog"))
    return out


# ---------------------------------------------------------------------------
# config knobs

_ENV_RE = re.compile(r"DIFACTO_[A-Z][A-Z0-9_]*\Z")


def _declared_params(project: Project) -> Set[str]:
    names: Set[str] = set()
    for sf in project.files:
        if sf.tree is None:
            continue
        for node in sf.walk():
            if not isinstance(node, ast.ClassDef):
                continue
            if not any(dotted(b).split(".")[-1].endswith("Param")
                       for b in node.bases):
                continue
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    names.add(stmt.target.id)
                elif isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            names.add(t.id)
    return names


def _kwargs_read_keys(sf: SourceFile) -> List[Tuple[str, ast.Compare]]:
    """Literal keys compared against the key half of a ``for k, v in
    <kwargs-ish>`` iteration — the raw config-read pattern."""
    reads = []
    loops = []
    for node in sf.walk():
        if isinstance(node, (ast.For, ast.comprehension)):
            tgt, it = node.target, node.iter
            if isinstance(tgt, ast.Tuple) and tgt.elts \
                    and isinstance(tgt.elts[0], ast.Name):
                names_in_iter = {n.id for n in ast.walk(it)
                                 if isinstance(n, ast.Name)}
                if names_in_iter & {"kwargs", "remain", "kv", "args_kv"}:
                    body = node.body if isinstance(node, ast.For) else \
                        list(node.ifs)
                    parent = node if isinstance(node, ast.For) else \
                        getattr(node, "parent", None)
                    loops.append((tgt.elts[0].id, parent or node, body))
    for keyname, scope_node, body in loops:
        stmts = body or [scope_node]
        for stmt in stmts:
            for n in ast.walk(stmt):
                if not isinstance(n, ast.Compare) or len(n.ops) != 1 \
                        or not isinstance(n.ops[0], (ast.Eq, ast.NotEq)):
                    continue
                left, right = n.left, n.comparators[0]
                if isinstance(left, ast.Name) and left.id == keyname:
                    lit = str_const(right)
                    if lit:
                        reads.append((lit, n))
    return reads


def _env_reads(sf: SourceFile) -> List[Tuple[str, ast.AST]]:
    out = []
    for node in sf.walk():
        name: Optional[str] = None
        if isinstance(node, ast.Call):
            cn = call_name(node)
            if cn in ("os.environ.get", "environ.get", "os.getenv",
                      "getenv") and node.args:
                name = str_const(node.args[0])
        elif isinstance(node, ast.Subscript):
            if dotted(node.value) in ("os.environ", "environ"):
                name = str_const(node.slice)
        if name and _ENV_RE.fullmatch(name):
            out.append((name, node))
    return out


@rule("config-registry",
      "raw config reads must name declared Param fields; DIFACTO_* env "
      "knobs must be documented", cross=True)
def check_config_registry(project: Project) -> List[Finding]:
    declared = _declared_params(project)
    docs = project.docs_text()
    out = []
    seen_env: Set[str] = set()
    for sf in project.files:
        if sf.tree is None:
            continue
        for key, node in _kwargs_read_keys(sf):
            if declared and key not in declared:
                out.append(sf.finding(
                    "config-registry", node,
                    f"raw kwargs read of \"{key}\" but no Param "
                    f"subclass declares that field — the knob is "
                    f"invisible to the config chain (and to "
                    f"warn_unknown)"))
        for name, node in _env_reads(sf):
            if name in seen_env:
                continue
            seen_env.add(name)
            if name not in docs:
                out.append(sf.finding(
                    "config-registry", node,
                    f"env knob {name} is read here but documented "
                    f"nowhere in docs/ or README — add it to the "
                    f"environment-knob catalog"))
    return out
