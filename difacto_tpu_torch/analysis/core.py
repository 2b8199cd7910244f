"""Rule framework of the port's difacto-lint (a copy of
difacto_tpu/analysis/core.py; the port imports nothing of that package).

Everything rule authors touch lives here: the :class:`Finding` record,
the rule registry (:func:`rule` decorator), per-line ``# lint:
ok(rule-id)`` suppressions, the checked-in baseline for grandfathered
findings, the project index cross-file rules read, and the three output
formats (``text`` for humans, ``json`` for tooling, ``github`` for PR
annotations).

Exit-code contract (stable — CI and the Makefile depend on it):

- ``0`` — clean: no unsuppressed, non-baselined findings.
- ``1`` — findings to fix (or to baseline intentionally).
- ``2`` — usage or internal error (bad flags, unreadable baseline).

Fingerprints are line-number free — ``sha1(rule | relpath | stripped
source line | occurrence#)`` — so a baseline survives unrelated edits
above a grandfathered finding; it expires only when the flagged line
itself changes (which is exactly when a human should re-look).
"""

from __future__ import annotations

import ast
import hashlib
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

BASELINE_VERSION = 1
JSON_VERSION = 1

# ---------------------------------------------------------------------------
# findings


@dataclass
class Finding:
    rule: str
    path: str            # repo-relative, forward slashes
    line: int            # 1-based; 0 for file-level findings
    message: str
    snippet: str = ""    # stripped source line (fingerprint input)
    suppressed: bool = False   # hit a `# lint: ok(...)` pragma
    baselined: bool = False    # matched the checked-in baseline
    occurrence: int = 0        # disambiguates identical (rule,path,snippet)

    def fingerprint(self) -> str:
        raw = f"{self.rule}|{self.path}|{self.snippet}|{self.occurrence}"
        return hashlib.sha1(raw.encode("utf-8")).hexdigest()[:16]

    @property
    def active(self) -> bool:
        return not (self.suppressed or self.baselined)

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "message": self.message, "fingerprint": self.fingerprint(),
            "suppressed": self.suppressed, "baselined": self.baselined,
        }


# ---------------------------------------------------------------------------
# rule registry


@dataclass
class Rule:
    rule_id: str
    summary: str
    check: Callable          # SourceFile -> findings  |  Project -> findings
    cross: bool = False


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, summary: str, cross: bool = False):
    """Register a rule. Local rules take a :class:`SourceFile`, cross
    rules take the whole :class:`Project`."""
    def deco(fn):
        RULES[rule_id] = Rule(rule_id, summary, fn, cross)
        return fn
    return deco


def all_rules() -> Dict[str, Rule]:
    # import for side effect: the @rule decorators populate RULES
    from . import (concurrency, crossrules, localrules,  # noqa: F401
                   races, shardflow, torchflow)
    return RULES


# ---------------------------------------------------------------------------
# source files and suppressions

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ok\(([a-zA-Z0-9_\-, ]+)\)")


class SourceFile:
    """One parsed lint target: text, AST with ``.parent`` links, and the
    per-line suppression map (a pragma covers its own line and, when it
    stands alone, the first code line after it).

    The node index is SHARED: :meth:`walk` / :meth:`call_nodes` cache
    the flat node list once, so the local, cross, concurrency, and race
    passes all read one traversal instead of each re-walking the tree
    (the whole-file ``ast.walk`` was the analyzer's hottest loop)."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.parse_error: Optional[str] = None
        self._nodes: Optional[List[ast.AST]] = None
        self._calls: Optional[List[ast.Call]] = None
        try:
            self.tree: Optional[ast.AST] = ast.parse(text)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = f"{e.msg} (line {e.lineno})"
        if self.tree is not None:
            nodes = list(ast.walk(self.tree))
            self._nodes = nodes
            for node in nodes:
                for child in ast.iter_child_nodes(node):
                    child.parent = node  # type: ignore[attr-defined]
        self.suppressions: Dict[int, set] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            self.suppressions.setdefault(i, set()).update(ids)
            if line.lstrip().startswith("#"):
                # standalone pragma: covers the next CODE line — blank
                # lines and the rationale's continuation comment lines
                # in between don't break the attachment
                j = i + 1
                while j <= len(self.lines) \
                        and (not self.lines[j - 1].strip()
                             or self.lines[j - 1].lstrip().startswith("#")):
                    j += 1
                self.suppressions.setdefault(j, set()).update(ids)

    def walk(self) -> List[ast.AST]:
        """Every node of the file's AST, computed once (same order as
        ``ast.walk(self.tree)``). Empty for unparsable files."""
        return self._nodes or []

    def call_nodes(self) -> List[ast.Call]:
        """Every ``ast.Call`` in the file, from the shared index."""
        if self._calls is None:
            self._calls = [n for n in self.walk()
                           if isinstance(n, ast.Call)]
        return self._calls

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule_id: str, node, message: str) -> Finding:
        lineno = getattr(node, "lineno", 0) if node is not None else 0
        return Finding(rule_id, self.rel, lineno, message,
                       snippet=self.line_text(lineno))

    def is_suppressed(self, f: Finding) -> bool:
        ids = self.suppressions.get(f.line, set())
        return f.rule in ids or "all" in ids


# ---------------------------------------------------------------------------
# the project index


class Project:
    """Everything the analyzer reads, resolved once.

    ``lint_paths`` are what local rules run over. Cross rules also read
    *reference corpora* that are not themselves linted: the docs and the
    test suite (registry-drift rules check call sites against both).
    The defaults are the port's layout: it has no ``docs/`` of its own,
    so its docs corpus is the README's ``## PyTorch port`` section plus
    the docstrings and comments of ``difacto_tpu_torch/``, and the
    metric catalog is that same corpus (``metrics_doc=None``). Every
    knob is a parameter, so the fixture suite can lint tiny synthetic
    projects with the JAX package's layout (``docs_dir="docs"``,
    ``readme_section=None``, ``doc_sources=()``, ``metrics_doc=
    "docs/observability.md"``).
    """

    def __init__(self, root, lint_paths: Optional[List[str]] = None, *,
                 docs_dir: str = "docs",
                 tests_dir: str = "tests",
                 readme: str = "README.md",
                 readme_section: Optional[str] = "## PyTorch port",
                 doc_sources: Tuple[str, ...] = ("difacto_tpu_torch",),
                 handler_files: Tuple[str, ...] = (
                     "difacto_tpu_torch/serve/server.py",
                     "difacto_tpu_torch/serve/router.py"),
                 sender_files: Tuple[str, ...] = (
                     "difacto_tpu_torch/serve/client.py",
                     "difacto_tpu_torch/serve/fleet.py",
                     "difacto_tpu_torch/tools/", "chip_smoke.py"),
                 kinds_file: str = "difacto_tpu_torch/utils/faultinject.py",
                 metrics_doc: Optional[str] = None,
                 metrics_impl_files: Tuple[str, ...] = (
                     "difacto_tpu_torch/obs/metrics.py",),
                 exclude: Tuple[str, ...] = ("__pycache__",)):
        self.root = Path(root).resolve()
        self.docs_dir = docs_dir
        self.tests_dir = tests_dir
        self.readme = readme
        self.readme_section = readme_section
        self.doc_sources = doc_sources
        self.handler_files = handler_files
        self.sender_files = sender_files
        self.kinds_file = kinds_file
        self.metrics_doc = metrics_doc
        self.metrics_impl_files = metrics_impl_files
        self.exclude = exclude
        self.files: List[SourceFile] = []
        for p in self._expand(lint_paths or ["."]):
            rel = p.relative_to(self.root).as_posix()
            try:
                text = p.read_text(encoding="utf-8")
            except OSError as e:
                sf = SourceFile(p, rel, "")
                sf.parse_error = f"unreadable: {e}"
                self.files.append(sf)
                continue
            self.files.append(SourceFile(p, rel, text))
        self._docs_cache: Optional[str] = None
        self._tests_cache: Optional[str] = None

    def _expand(self, paths: List[str]) -> List[Path]:
        out: List[Path] = []
        for raw in paths:
            p = (self.root / raw).resolve()
            if p.is_dir():
                for q in sorted(p.rglob("*.py")):
                    if any(part in self.exclude for part in q.parts):
                        continue
                    out.append(q)
            elif p.suffix == ".py" and p.exists():
                out.append(p)
        seen, uniq = set(), []
        for p in out:
            if p not in seen:
                seen.add(p)
                uniq.append(p)
        return uniq

    # -- reference corpora -------------------------------------------------

    def docs_text(self) -> str:
        """The docs corpus registry rules grep: the docs tree's
        Markdown, the README (its ``readme_section`` alone when set:
        from that heading to the next heading of its level) and the
        docstrings and comments of the ``doc_sources`` trees."""
        if self._docs_cache is None:
            parts = []
            d = self.root / self.docs_dir
            if d.is_dir():
                for p in sorted(d.rglob("*.md")):
                    parts.append(p.read_text(encoding="utf-8",
                                             errors="replace"))
            r = self.root / self.readme
            if r.exists():
                text = r.read_text(encoding="utf-8", errors="replace")
                if self.readme_section is not None:
                    text = _section(text, self.readme_section)
                parts.append(text)
            for src in self.doc_sources:
                d = self.root / src
                if d.is_dir():
                    for p in sorted(d.rglob("*.py")):
                        if not any(part in self.exclude
                                   for part in p.parts):
                            parts.append(_doc_text(p.read_text(
                                encoding="utf-8", errors="replace")))
            self._docs_cache = "\n".join(parts)
        return self._docs_cache

    def metrics_catalog(self) -> str:
        """The metric catalog: ``metrics_doc``, or the docs corpus when
        it is None."""
        if self.metrics_doc is None:
            return self.docs_text()
        p = self.root / self.metrics_doc
        return p.read_text(encoding="utf-8", errors="replace") \
            if p.exists() else ""

    def tests_text(self) -> str:
        if self._tests_cache is None:
            parts = []
            d = self.root / self.tests_dir
            if d.is_dir():
                for p in sorted(d.rglob("*.py")):
                    parts.append(p.read_text(encoding="utf-8",
                                             errors="replace"))
            self._tests_cache = "\n".join(parts)
        return self._tests_cache

    def match_files(self, specs: Iterable[str]) -> List[SourceFile]:
        """Lint files whose relpath equals a spec or lives under a
        ``dir/`` spec."""
        out = []
        for sf in self.files:
            for spec in specs:
                if sf.rel == spec or (spec.endswith("/")
                                      and sf.rel.startswith(spec)):
                    out.append(sf)
                    break
        return out


def _section(text: str, heading: str) -> str:
    """``text`` from the line ``heading`` to the next heading of the
    same level or higher (empty when the heading is absent)."""
    lines = text.splitlines()
    level = len(heading) - len(heading.lstrip("#"))
    out, inside = [], False
    for line in lines:
        if line.strip() == heading:
            inside = True
        elif inside and line.startswith("#"):
            hashes = len(line) - len(line.lstrip("#"))
            if hashes <= level and line[hashes:hashes + 1] == " ":
                break
        if inside:
            out.append(line)
    return "\n".join(out)


def _doc_text(src: str) -> str:
    """The docstrings and comments of one source file (its documentation;
    the code's own string literals are not)."""
    import io
    import tokenize
    parts = []
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return ""
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node, clean=False)
            if doc:
                parts.append(doc)
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                parts.append(tok.string)
    except (tokenize.TokenError, SyntaxError):
        pass
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# AST helpers shared by the rules


def call_name(node: ast.Call) -> str:
    """Best-effort dotted name of a call target: ``threading.Thread``,
    ``socket.socket``, ``open`` ... empty string when dynamic."""
    return dotted(node.func)


def dotted(node) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def node_key(node) -> str:
    """Matching key for an lvalue/receiver: ``x`` for Name x, ``.x`` for
    any ``<obj>.x`` attribute (so ``self._t.join()`` matches the
    ``self._t = Thread(...)`` binding regardless of the object half)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return "." + node.attr
    return ""


def str_const(node) -> Optional[str]:
    if isinstance(node, ast.Constant):
        if isinstance(node.value, str):
            return node.value
        if isinstance(node.value, bytes):
            try:
                return node.value.decode("ascii")
            except UnicodeDecodeError:
                return None
    return None


def enclosing_function(node):
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def statement_of(node):
    cur = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = getattr(cur, "parent", None)
    return cur


def import_aliases(tree: ast.AST, module: str) -> set:
    """Names under which ``module`` is visible in this file, including
    ``from module import f`` members mapped as ``name -> member`` via
    a ``name:member`` entry? No — returns just the module aliases; use
    :func:`from_imports` for members."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out.add(a.asname or a.name)
    return out


def from_imports(tree: ast.AST, module: str) -> Dict[str, str]:
    """``from module import x as y`` -> ``{y: x}``."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


# ---------------------------------------------------------------------------
# running


@dataclass
class RunResult:
    findings: List[Finding] = field(default_factory=list)
    expired: List[dict] = field(default_factory=list)  # baseline leftovers
    files: int = 0
    # per-pass wall time: rule id -> seconds (cross rules measured once,
    # local rules summed across files), plus the analyzer total — the CI
    # JSON report carries both so the 30s budget can be attributed when
    # it tightens
    rule_seconds: Dict[str, float] = field(default_factory=dict)
    lint_seconds: float = 0.0

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if f.active]

    def counts(self) -> dict:
        return {
            "files": self.files,
            "total": len(self.findings),
            "active": len(self.active),
            "suppressed": sum(f.suppressed for f in self.findings),
            "baselined": sum(f.baselined for f in self.findings),
            "expired_baseline": len(self.expired),
        }


def run_project(project: Project,
                rule_ids: Optional[Iterable[str]] = None,
                local_files: Optional[set] = None) -> RunResult:
    """Run rules over the project. ``local_files`` (a set of repo-
    relative paths) restricts LOCAL rules to those files — the
    ``--changed-only`` incremental mode; cross-file and concurrency
    rules always see the whole tree (their findings can live in files
    the change never touched)."""
    import time as _time

    rules = all_rules()
    if rule_ids is not None:
        unknown = set(rule_ids) - set(rules)
        if unknown:
            raise ValueError(f"unknown rule(s): {sorted(unknown)}")
        rules = {rid: rules[rid] for rid in rule_ids}
    res = RunResult(files=len(project.files))
    t_run0 = _time.monotonic()
    by_file = {sf.rel: sf for sf in project.files}
    for sf in project.files:
        if local_files is not None and sf.rel not in local_files:
            continue
        if sf.parse_error is not None:
            res.findings.append(Finding(
                "parse-error", sf.rel, 0,
                f"cannot analyze: {sf.parse_error}"))
            continue
        for r in rules.values():
            if not r.cross:
                t0 = _time.monotonic()
                res.findings.extend(r.check(sf))
                res.rule_seconds[r.rule_id] = \
                    res.rule_seconds.get(r.rule_id, 0.0) \
                    + (_time.monotonic() - t0)
    for r in rules.values():
        if r.cross:
            t0 = _time.monotonic()
            res.findings.extend(r.check(project))
            res.rule_seconds[r.rule_id] = \
                res.rule_seconds.get(r.rule_id, 0.0) \
                + (_time.monotonic() - t0)
    # stable order, then occurrence indices for identical snippets
    res.findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    seen: Dict[Tuple[str, str, str], int] = {}
    for f in res.findings:
        key = (f.rule, f.path, f.snippet)
        f.occurrence = seen.get(key, 0)
        seen[key] = f.occurrence + 1
        sf = by_file.get(f.path)
        if sf is not None and sf.is_suppressed(f):
            f.suppressed = True
    res.lint_seconds = _time.monotonic() - t_run0
    return res


# ---------------------------------------------------------------------------
# baseline


def load_baseline(path) -> Dict[str, dict]:
    p = Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text(encoding="utf-8"))
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{data.get('version')!r}")
    return dict(data.get("findings", {}))


def apply_baseline(res: RunResult, baseline: Dict[str, dict]) -> None:
    """Mark matching findings baselined; record expired entries (in the
    baseline but no longer produced — prune with ``--write-baseline``)."""
    matched = set()
    for f in res.findings:
        if f.suppressed:
            continue
        fp = f.fingerprint()
        if fp in baseline:
            f.baselined = True
            matched.add(fp)
    res.expired = [dict(entry, fingerprint=fp)
                   for fp, entry in sorted(baseline.items())
                   if fp not in matched]


def write_baseline(res: RunResult, path) -> int:
    """Grandfather every currently-active finding. Returns the count."""
    entries = {
        f.fingerprint(): {"rule": f.rule, "path": f.path,
                          "message": f.message, "snippet": f.snippet}
        for f in res.findings if not f.suppressed
    }
    payload = {"version": BASELINE_VERSION, "findings": entries}
    Path(path).write_text(json.dumps(payload, indent=1, sort_keys=True)
                          + "\n", encoding="utf-8")
    return len(entries)


# ---------------------------------------------------------------------------
# output formats


def format_text(res: RunResult, verbose: bool = False) -> str:
    out = []
    for f in res.findings:
        if not f.active and not verbose:
            continue
        tag = "" if f.active else (" (suppressed)" if f.suppressed
                                   else " (baselined)")
        out.append(f"{f.path}:{f.line}: [{f.rule}]{tag} {f.message}")
    for e in res.expired:
        out.append(f"baseline: expired entry {e['fingerprint']} "
                   f"[{e.get('rule', '?')}] {e.get('path', '?')} — "
                   f"regenerate with --write-baseline")
    c = res.counts()
    out.append(f"difacto-lint: {c['files']} files, {c['active']} finding(s) "
               f"({c['suppressed']} suppressed, {c['baselined']} baselined, "
               f"{c['expired_baseline']} expired baseline) "
               f"in {res.lint_seconds:.2f}s")
    if verbose and res.rule_seconds:
        slow = sorted(res.rule_seconds.items(), key=lambda kv: -kv[1])[:6]
        out.append("slowest passes: " + ", ".join(
            f"{rid} {s:.2f}s" for rid, s in slow))
    return "\n".join(out)


def format_json(res: RunResult) -> str:
    return json.dumps({
        "version": JSON_VERSION,
        "counts": res.counts(),
        "findings": [f.to_json() for f in res.findings],
        "expired_baseline": res.expired,
        "lint_seconds": round(res.lint_seconds, 3),
        "rule_seconds": {rid: round(s, 3)
                         for rid, s in sorted(res.rule_seconds.items())},
    }, indent=1, sort_keys=True)


def format_sarif(res: RunResult) -> str:
    """SARIF 2.1.0 — what GitHub code scanning ingests (the CI lint job
    uploads this next to the JSON report, so findings land as scanning
    alerts alongside the inline `github`-format annotations). Active
    findings only; the line-number-free fingerprint rides along as the
    partial fingerprint so alerts track across unrelated edits."""
    rules = all_rules()
    used = sorted({f.rule for f in res.active})
    results = []
    for f in res.active:
        results.append({
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(f.line, 1)},
                },
            }],
            "partialFingerprints": {
                "difactoLint/v1": f.fingerprint(),
            },
        })
    driver = {
        "name": "difacto-lint",
        "informationUri":
            "https://github.com/difacto-tpu/difacto-tpu"
            "/blob/main/docs/static_analysis.md",
        "rules": [{
            "id": rid,
            "shortDescription": {
                "text": rules[rid].summary if rid in rules
                else "analyzer-internal finding"},
        } for rid in used],
    }
    return json.dumps({
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": driver},
            "results": results,
            "columnKind": "utf16CodeUnits",
        }],
    }, indent=1, sort_keys=True)


def format_github(res: RunResult) -> str:
    """GitHub workflow-command annotations: active findings render
    inline on the PR diff; expired baseline entries surface as notices."""
    out = []
    for f in res.active:
        msg = f.message.replace("%", "%25").replace("\n", "%0A")
        out.append(f"::error file={f.path},line={max(f.line, 1)},"
                   f"title=difacto-lint {f.rule}::{msg}")
    for e in res.expired:
        out.append(f"::notice title=difacto-lint baseline::expired entry "
                   f"{e['fingerprint']} ({e.get('rule', '?')} "
                   f"{e.get('path', '?')}) — rerun with --write-baseline")
    if not out:
        out.append("::notice title=difacto-lint::clean")
    return "\n".join(out)
