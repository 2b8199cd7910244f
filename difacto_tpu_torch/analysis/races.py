"""Eraser-style static data-race detection (a copy of
difacto_tpu/analysis/races.py; difacto-lint v3).

The concurrency layer (v2) proves locks are taken in a consistent
*order*; this pass answers the other half: which shared fields each
lock actually *guards*, and which are touched by two threads with no
common lock at all. Three stages, all riding the call graph and the
single held-set walk the concurrency model already does:

1. **Thread-root discovery** — every concurrent entry point: the main
   thread (``<main>``: all module-level code and what it reaches), and
   every ``Thread``/``Process`` target, executor ``submit``/``map``
   callable, or producer/serve worker the callgraph resolves (including
   ``functools.partial``, ``lambda``, bound-method and local-alias
   forms). A root spawned from inside a loop, or from two different
   sites, is *multi-instance*: it can race with itself. Reachability
   over call edges (thread edges start a NEW root, they do not extend
   the spawner's) gives each function its set of reaching roots.

2. **Shared-state index** — every mutable location with an identity the
   lock model already uses: ``self.attr`` / ``cls.attr`` class
   attributes (``rel.py::Class.attr``, unified across a class and the
   base that first writes the attribute), module globals written under
   a ``global`` declaration (``rel.py::name``), and closure cells a
   nested function shares with its binder (``rel.py::func.var``). Each
   read/write site carries its reaching roots and its *effective
   lockset*: the locks held at the site plus the locks held at every
   call site leading there (the entry lockset — the intersection over
   all callers, so a helper only "inherits" a lock every caller takes).

3. **Lockset inference** — per field, Eraser's rule: intersect the
   effective locksets of all post-init accesses. A non-empty
   intersection is an inferred ``GuardedBy`` fact (folded into ``make
   lockmap``). An EMPTY intersection on a field reachable from >= 2
   roots with at least one write is a ``data-race`` finding, reported
   with a two-site witness: the conflicting write and read/write, each
   side's roots and held locks.

Escape hatches that keep false positives sane (docs/static_analysis.md
v3 lists the full catalog):

- **init-before-publish** — accesses inside ``__init__`` are
  construction, before the object can be visible to another thread;
  closure-cell accesses in the binder *above its first thread spawn*
  are likewise setup;
- **immutable-after-publish** — a field never written outside init
  (config, wired callbacks, lock objects themselves) cannot race;
- locks, ``Condition``/queue objects and dunders are excluded; deep
  mutation (``self.d[k] = v`` mutates the dict, not the binding) is a
  documented blind spot — the binding read still indexes the field.

The runtime complement is ``utils/shared.py`` (``DIFACTO_RACETRACE=1``)
whose observed (field, thread, locks-held) tuples the tier-1 gate
checks against this model: every dynamically multi-thread field must be
statically guarded or carry a reasoned ``# lint: ok(data-race)``.
"""

from __future__ import annotations

import ast
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import CallGraph
from .concurrency import ConcurrencyModel, _short, get_model
from .core import Finding, Project, rule

MAIN_ROOT = "<main>"

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclass
class Access:
    field_id: str
    path: str
    line: int
    func: str                  # owning function qual
    write: bool
    init: bool                 # construction access (escape hatch)
    locks: Tuple[str, ...]     # effective lockset at the site


@dataclass
class FieldInfo:
    field_id: str
    kind: str                  # "attr" | "global" | "cell"
    path: str
    accesses: List[Access] = field(default_factory=list)
    roots: Set[str] = field(default_factory=set)
    weight: int = 0            # multiplicity-weighted root count
    guard: Tuple[str, ...] = ()


def _root_name(root: str) -> str:
    return root if root == MAIN_ROOT else _short(root)


class RaceModel:
    """The whole-program shared-state model. Built once per Project
    (cached — the data-race rule, lockmap, and the tier-1 gate share
    it) on top of the cached ConcurrencyModel: no extra tree walk."""

    def __init__(self, project: Project):
        self.project = project
        self.cm: ConcurrencyModel = get_model(project)
        self.cg: CallGraph = self.cm.cg
        self.roots: Dict[str, int] = {}           # root -> multiplicity
        self.func_roots: Dict[str, Set[str]] = {}
        self.entry_locks: Dict[str, frozenset] = {}
        self.fields: Dict[str, FieldInfo] = {}
        self.guarded_by: Dict[str, Tuple[str, ...]] = {}
        self.readonly: Set[str] = set()
        self.suppressed_fields: Set[str] = set()
        self._findings: List[Finding] = []
        self._discover_roots()
        self._compute_entry_locks()
        self._index_accesses()
        self._infer()

    # ------------------------------------------------------ thread roots
    @staticmethod
    def _in_loop(node) -> bool:
        cur = getattr(node, "parent", None)
        while cur is not None and not isinstance(cur, _FUNC_DEFS):
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                return True
            cur = getattr(cur, "parent", None)
        return False

    def _discover_roots(self) -> None:
        spawns: Dict[str, List[ast.Call]] = {}
        for sites in self.cg.calls.values():
            for site in sites:
                if site.kind != "thread":
                    continue
                for t in site.targets:
                    spawns.setdefault(t, []).append(site.node)
        self.roots[MAIN_ROOT] = 1
        for t, nodes in sorted(spawns.items()):
            # spawned in a loop or from several sites: the root can run
            # as two concurrent instances and race with itself
            multi = len(nodes) > 1 or any(self._in_loop(n) for n in nodes)
            self.roots[t] = 2 if multi else 1

        # reachability over EXACT call edges only: the multi-candidate
        # attribute heuristic (CallSite.fuzzy) is a safe superset for
        # lock ordering, but here it would smear serve-thread roots
        # into every class with a same-named method (every learner's
        # `load` would look reload-thread-reachable)
        adj: Dict[str, List[str]] = {}
        for qual, sites in self.cg.calls.items():
            outs: Set[str] = set()
            for site in sites:
                if site.kind == "call" and not site.fuzzy:
                    outs.update(site.targets)
            adj[qual] = sorted(outs)
        self.func_roots = {q: set() for q in self.cg.funcs}
        for root in sorted(self.roots):
            seeds = [q for q in self.cg.funcs
                     if q.endswith("::<module>")] \
                if root == MAIN_ROOT else [root]
            seen = {s for s in seeds if s in self.cg.funcs}
            frontier = list(seen)
            while frontier:
                q = frontier.pop()
                self.func_roots.setdefault(q, set()).add(root)
                for t in adj.get(q, []):
                    if t not in seen and t in self.cg.funcs:
                        seen.add(t)
                        frontier.append(t)

    def root_weight(self, roots: Set[str]) -> int:
        return sum(self.roots.get(r, 1) for r in roots)

    # ----------------------------------------------------- entry locksets
    def _compute_entry_locks(self) -> None:
        """entry_locks[f]: locks held at EVERY resolved call into f
        (meet over callers; roots and module bodies start empty). The
        effective lockset at an access is entry ∪ locally-held."""
        facts = self.cm.facts
        site_held: Dict[int, Tuple[str, ...]] = {}
        for f in facts.values():
            for held, call in f.call_events:
                site_held[id(call)] = tuple(lk for lk, _ in held)
        entry: Dict[str, Optional[frozenset]] = {q: None for q in facts}
        forced = set()
        for q in facts:
            if q.endswith("::<module>") or q in self.roots:
                entry[q] = frozenset()
                forced.add(q)
        work = deque(sorted(forced))
        inwork = set(work)
        while work:
            q = work.popleft()
            inwork.discard(q)
            eq = entry[q]
            if eq is None:
                continue
            for site in self.cg.calls.get(q, []):
                if site.kind != "call" or site.fuzzy:
                    # fuzzy edges would let a spurious lock-free caller
                    # empty a helper's entry lockset — exact edges only,
                    # symmetric with root reachability
                    continue
                contrib = eq | frozenset(
                    site_held.get(id(site.node), ()))
                for t in site.targets:
                    if t not in entry or t in forced or t == q:
                        continue
                    cur = entry[t]
                    new = contrib if cur is None else (cur & contrib)
                    if new != cur:
                        entry[t] = new
                        if t not in inwork:
                            work.append(t)
                            inwork.add(t)
        self.entry_locks = {q: (e if e is not None else frozenset())
                            for q, e in entry.items()}

    # ------------------------------------------------------ access index
    def _attr_owner(self, ci, attr: str, depth: int = 0):
        """The class that owns an attribute: the deepest base that
        writes it (so one field unifies across a base and its
        subclasses), else the accessing class itself."""
        if depth > 4 or ci is None:
            return None
        for base in ci.bases:
            for bi in self.cg.classes.get(base, []):
                got = self._attr_owner(bi, attr, depth + 1)
                if got is not None:
                    return got
        if attr in self._attrs_written.get(ci.qual, set()):
            return ci
        return None

    def _index_accesses(self) -> None:
        facts = self.cm.facts
        # pass 1: which classes write which attrs (ownership unification)
        self._attrs_written: Dict[str, Set[str]] = {}
        for qual, f in facts.items():
            fi = self.cg.funcs.get(qual)
            if fi is None or fi.cls is None:
                continue
            for _held, node in f.access_events:
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, (ast.Store, ast.Del)):
                    self._attrs_written.setdefault(
                        fi.cls.qual, set()).add(node.attr)
        # per-file name classification corpora
        mod_locals: Dict[str, Set[str]] = {}
        file_global_decls: Dict[str, Set[str]] = {}
        for qual, f in facts.items():
            rel = f.sf.rel
            if qual.endswith("::<module>"):
                mod_locals[rel] = f.local_names
            file_global_decls.setdefault(rel, set()).update(
                f.global_names)
        # first thread-spawn / last join line per function (the cell
        # happens-before hatches: binder accesses BEFORE the spawn are
        # construction, binder accesses AFTER the last `t.join()` are
        # sequenced after every thread the frame owns)
        spawn_line: Dict[str, int] = {}
        join_line: Dict[str, int] = {}
        for qual, sites in self.cg.calls.items():
            lines = [s.node.lineno for s in sites if s.kind == "thread"]
            if lines:
                spawn_line[qual] = min(lines)
            joins = [s.node.lineno for s in sites
                     if isinstance(s.node.func, ast.Attribute)
                     and s.node.func.attr == "join"
                     # 0-arg join() is Thread/Process; str.join and a
                     # timeout-bounded join (may return early) are not
                     # a happens-before edge
                     and not s.node.args and not s.node.keywords]
            if joins:
                join_line[qual] = max(joins)

        lock_ids = set(self.cm.locks)
        for qual in sorted(facts):
            f = facts[qual]
            fi = self.cg.funcs.get(qual)
            entry = self.entry_locks.get(qual, frozenset())
            for held, node in f.access_events:
                rec: Optional[Tuple[str, str, bool, bool]] = None
                if isinstance(node, ast.Attribute):
                    if fi is None or fi.cls is None:
                        continue
                    owner = self._attr_owner(fi.cls, node.attr) or fi.cls
                    fid = f"{owner.sf.rel}::{owner.name}.{node.attr}"
                    write = isinstance(node.ctx, (ast.Store, ast.Del))
                    rec = (fid, "attr", write, fi.name == "__init__")
                elif isinstance(node, ast.Name):
                    rec = self._classify_name(
                        qual, f, node, mod_locals, file_global_decls,
                        spawn_line, join_line)
                if rec is None:
                    continue
                fid, kind, write, init = rec
                if fid in lock_ids:
                    continue
                info = self.fields.get(fid)
                if info is None:
                    info = self.fields[fid] = FieldInfo(
                        fid, kind, fid.partition("::")[0])
                info.accesses.append(Access(
                    fid, f.sf.rel, getattr(node, "lineno", 0), qual,
                    write, init,
                    tuple(sorted(entry | set(held)))))

    def _classify_name(self, qual, f, node, mod_locals,
                       file_global_decls, spawn_line, join_line):
        nid = node.id
        rel = f.sf.rel
        write = isinstance(node.ctx, (ast.Store, ast.Del))
        if qual.endswith("::<module>"):
            # module body: every binding there is a global, and the
            # body runs at import, before any thread exists — writes
            # are init-before-publish by construction
            if nid in f.local_names or nid in f.cell_names:
                return (f"{rel}::{nid}", "global", write, True)
            return None
        if nid in f.cell_names:
            # the binder's own access to a cell var: construction until
            # the first thread spawn in this function publishes it, and
            # sequenced again after the frame's last `t.join()` (the
            # loadgen pattern — workers write counters, the binder reads
            # them only after joining every worker)
            init = node.lineno < spawn_line.get(qual, 0) \
                or (qual in join_line
                    and node.lineno > join_line[qual])
            return (f"{qual}.{nid}", "cell", write, init)
        if nid in f.global_names:
            return (f"{rel}::{nid}", "global", write, False)
        # nonlocal / free variable: find the binding enclosing function
        prefix, _, _name = qual.rpartition(".")
        while "::" in prefix:
            outer = self.cm.facts.get(prefix)
            if outer is not None and nid in outer.cell_names:
                return (f"{prefix}.{nid}", "cell", write, False)
            prefix = prefix.rpartition(".")[0]
        if nid in mod_locals.get(rel, set()) \
                or nid in file_global_decls.get(rel, set()):
            if not write:
                # module-global read; writes only count under a
                # `global` declaration (handled above) — a Store here
                # is a local the scanner classified, not this field
                return (f"{rel}::{nid}", "global", False, False)
        return None

    # ---------------------------------------------------------- inference
    def _access_roots(self, a: Access) -> Set[str]:
        """Roots reaching an access. A function NO root reaches (dead
        to the static graph — e.g. a ``close()`` only tests call, or a
        callback behind ``getattr`` dispatch) is attributed to the main
        root: its accesses still conflict with worker-thread accesses,
        and dropping them would silently shrink the race surface."""
        return self.func_roots.get(a.func) or {MAIN_ROOT}

    def _cell_is_shared(self, info: FieldInfo) -> bool:
        """A closure cell lives per CALL FRAME of its binder: it is
        shared between threads only when the binder hands a nested
        function to another thread (``Thread(target=inner)`` /
        ``submit(inner)``). Without a spawned nested accessor the cell
        is thread-confined however many roots reach the binder."""
        binder = info.field_id.rsplit(".", 1)[0]
        spawned = {
            t
            for site in self.cg.calls.get(binder, [])
            if site.kind == "thread"
            for t in site.targets
            if t.startswith(binder + ".")
        }
        if not spawned:
            return False
        return any(a.func in spawned
                   or any(a.func.startswith(t + ".") for t in spawned)
                   for a in info.accesses)

    def _infer(self) -> None:
        for fid in sorted(self.fields):
            info = self.fields[fid]
            if info.kind == "cell" and not self._cell_is_shared(info):
                continue                    # per-call frame, not shared
            non_init = [a for a in info.accesses if not a.init]
            writes = [a for a in non_init if a.write]
            guard: Optional[Set[str]] = None
            for a in non_init:
                s = set(a.locks)
                guard = s if guard is None else guard & s
            if guard:
                # consistently locked on every post-init access —
                # recorded whatever the root weight, so the RACETRACE
                # gate recognizes the field even when the static root
                # count underestimates (e.g. a single-root helper)
                info.guard = tuple(sorted(guard))
            if not writes:
                self.readonly.add(fid)      # immutable-after-publish
                continue
            roots: Set[str] = set()
            for a in non_init:
                roots |= self._access_roots(a)
            info.roots = roots
            info.weight = self.root_weight(roots)
            if info.weight < 2:
                continue                    # single-threaded
            if info.guard:
                self.guarded_by[fid] = info.guard
                continue
            self._findings.append(
                self._race_finding(info, writes, non_init))

    def _race_finding(self, info: FieldInfo, writes: List[Access],
                      non_init: List[Access]) -> Finding:
        by_site = sorted(non_init, key=lambda a: (a.path, a.line))
        # the best witness pair EXPLAINS the empty lockset: a write and
        # another access holding no lock in common, from different
        # roots when one exists
        best: Optional[Tuple[Access, Access]] = None
        best_score = (-1, -1)
        for w in sorted(writes, key=lambda a: (a.path, a.line)):
            w_roots = self._access_roots(w)
            w_locks = set(w.locks)
            for cand in by_site:
                if cand is w:
                    continue
                score = (1 if not (w_locks & set(cand.locks)) else 0,
                         1 if self._access_roots(cand) - w_roots else 0)
                if score > best_score:
                    best_score = score
                    best = (w, cand)
        if best is None:
            w = writes[0]
            other = w                   # one-site field (e.g. `x += 1`)
        else:
            w, other = best

        def side(a: Access) -> str:
            kind = "write" if a.write else "read"
            roots = ", ".join(sorted(
                _root_name(r) for r in self._access_roots(a)))
            locks = ", ".join(_short(lk) for lk in a.locks) or "none"
            fn = a.func.split("::", 1)[1]
            return (f"{kind} at {a.path}:{a.line} in {fn} "
                    f"[roots: {roots}; locks: {locks}]")

        witness = side(w) if other is w \
            else f"{side(w)} vs {side(other)}"
        msg = (f"data-race on {_short(info.field_id)}: {witness} — no "
               f"common lock guards this multi-root field (Eraser "
               f"lockset is empty); guard every access with one lock, "
               f"or annotate a witness line with "
               f"`# lint: ok(data-race) <why this is safe>`")
        # anchor at a pragma-carrying access site when one exists, so
        # one reasoned annotation anywhere on the field silences it
        anchor = w
        by_rel = {sf.rel: sf for sf in self.project.files}
        for a in sorted(info.accesses, key=lambda a: (a.path, a.line)):
            sf = by_rel.get(a.path)
            if sf is not None and "data-race" in sf.suppressions.get(
                    a.line, set()):
                anchor = a
                self.suppressed_fields.add(info.field_id)
                break
        sf = by_rel.get(anchor.path)
        snippet = sf.line_text(anchor.line) if sf is not None else ""
        return Finding("data-race", anchor.path, anchor.line, msg,
                       snippet=snippet)

    # ------------------------------------------------------------ outputs
    def race_findings(self) -> List[Finding]:
        return list(self._findings)

    def known_safe(self) -> Set[str]:
        """Fields the tier-1 RACETRACE gate accepts as multi-thread:
        consistently locked on every post-init access (the multi-root
        subset of these are the GuardedBy facts), read-only after
        publish, or suppressed with a reasoned pragma."""
        locked = {fid for fid, info in self.fields.items() if info.guard}
        return locked | self.readonly | self.suppressed_fields

    def to_json(self) -> dict:
        return {
            "thread_roots": {r: m for r, m in sorted(self.roots.items())},
            "guarded_by": {fid: list(locks)
                           for fid, locks in sorted(
                               self.guarded_by.items())},
            "fields": {
                fid: {
                    "kind": info.kind,
                    "accesses": len(info.accesses),
                    "writes": sum(a.write for a in info.accesses
                                  if not a.init),
                    "roots": sorted(info.roots),
                    "weight": info.weight,
                    "guard": list(info.guard),
                }
                for fid, info in sorted(self.fields.items())
                if info.weight >= 2
            },
        }


def get_race_model(project: Project) -> RaceModel:
    m = getattr(project, "_race_model", None)
    if m is None or m.project is not project:
        m = RaceModel(project)
        project._race_model = m  # type: ignore[attr-defined]
    return m


@rule("data-race",
      "multi-thread shared state must keep a non-empty common lockset",
      cross=True)
def check_data_race(project: Project) -> List[Finding]:
    return get_race_model(project).race_findings()
