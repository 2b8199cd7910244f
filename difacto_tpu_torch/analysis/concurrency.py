"""Interprocedural concurrency rules: lock-order cycles, blocking calls
under locks, and Condition-wait discipline (a copy of
difacto_tpu/analysis/concurrency.py).

Built on :mod:`callgraph`. The model identifies every lock object in the
tree — ``threading.Lock/RLock/Condition`` (and the traced
``utils.locktrace.mutex/rmutex/condition`` factories) bound to a module
global, a ``self.attr`` class attribute, or a function local — then
propagates *held-lock sets* along the call graph:

- every ``with lock:`` / ``lock.acquire()`` region is a held region;
- a call made inside a held region orders the held locks BEFORE every
  lock the callee (transitively) acquires — thread hand-off edges
  (``Thread(target=...)``, ``submit``, ``pool.map``) do NOT propagate,
  the target runs on another thread with an empty held set;
- the resulting global lock-acquisition-order graph must be acyclic: a
  cycle means two threads can interleave into a deadlock, and the
  finding carries one witness path per direction so the report shows
  BOTH call chains that disagree on the order.

Lock identity is the *declaration site* (``rel.py::Class.attr`` /
``rel.py::global`` / ``rel.py::func.local``): all instances of one class
attribute collapse onto one node. That abstraction makes the analysis
tractable and matches the runtime tracer (utils/locktrace.py keys edges
by creation site), at the cost of two documented blind spots — self
edges (two *instances* of the same attribute lock) are skipped, and
locks reached only through unresolvable dynamic calls are invisible.

Two flow rules ride the same model:

- **lock-blocking** — a blocking operation (socket accept/recv/send*,
  ``queue.put/get`` without timeout, bare ``join()``, ``time.sleep``,
  ``subprocess.*``, ``SharedMemory`` create/unlink, untimed
  ``Event.wait``) executed — directly or through the call graph — while
  a lock is held turns every waiter on that lock into a hang. Blocking
  ops inside the fault-injection module itself (the ``delay_ms`` chaos
  kind IS a sleep) are exempt.
- **cond-wait-while** (local) — ``Condition.wait()`` outside a
  ``while``-predicate loop misses spurious wakeups and notify races;
  ``wait_for`` carries its own predicate and is always fine.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import CallGraph, FuncInfo, get_callgraph
from .core import (Finding, Project, SourceFile, call_name, node_key,
                   rule)

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_SCOPES = (_FUNC_DEFS[0], _FUNC_DEFS[1], ast.Lambda, ast.ClassDef)

# ctor member -> lock kind (threading.* and utils/locktrace.* factories)
_LOCK_CTORS = {"Lock": "Lock", "RLock": "RLock", "Condition": "Condition",
               "mutex": "Lock", "rmutex": "RLock", "condition": "Condition"}
_LOCK_MODULES = ("threading", "locktrace")
# distinctive socket methods (receiver-agnostic); send/connect only fire
# on receivers assigned from a socket constructor
_SOCKET_METHODS = {"accept", "recv", "recvfrom", "recv_into", "sendall",
                   "sendto"}
_SOCKET_METHODS_TYPED = {"send", "connect"}


# ---------------------------------------------------------------------------
# lock discovery


@dataclass
class LockInfo:
    lock_id: str        # "rel.py::Class.attr" | "rel.py::name" | "...::f.x"
    kind: str           # Lock | RLock | Condition
    path: str
    line: int           # ctor call line == locktrace creation-site line
    scope: str          # module | class | local
    key: str            # node_key of the binding target ("x" or ".attr")


def _lock_ctor_kind(sf: SourceFile, call: ast.Call,
                    bare: Dict[str, str]) -> Optional[str]:
    cn = call_name(call)
    if not cn:
        return None
    if "." in cn:
        head, _, last = cn.rpartition(".")
        if last in _LOCK_CTORS and head.split(".")[-1] in _LOCK_MODULES:
            return _LOCK_CTORS[last]
        return None
    return bare.get(cn)


def _bare_lock_names(sf: SourceFile) -> Dict[str, str]:
    """Names bound by a from-import of ``threading``'s Lock (and kin) or
    of ``utils.locktrace``'s ``mutex`` (and kin) — local name -> kind."""
    out: Dict[str, str] = {}
    for node in sf.walk():
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[-1] in _LOCK_MODULES:
                for a in node.names:
                    if a.name in _LOCK_CTORS:
                        out[a.asname or a.name] = _LOCK_CTORS[a.name]
    return out


def _enclosing(node, kinds):
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, kinds):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def discover_locks(sf: SourceFile, cg: Optional[CallGraph] = None) \
        -> List[LockInfo]:
    """Every lock bound in this file, with its declaration identity."""
    if sf.tree is None:
        return []
    bare = _bare_lock_names(sf)
    out: List[LockInfo] = []
    for node in sf.walk():
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if value is None:
            continue
        # unwrap collections of locks: self._locks = [Lock() for ...]
        ctor: Optional[ast.Call] = None
        cands = [value]
        if isinstance(value, (ast.ListComp, ast.SetComp)):
            cands = [value.elt]
        elif isinstance(value, (ast.List, ast.Tuple)):
            cands = list(value.elts)
        for c in cands:
            if isinstance(c, ast.Call) \
                    and _lock_ctor_kind(sf, c, bare) is not None:
                ctor = c
                break
        if ctor is None:
            continue
        kind = _lock_ctor_kind(sf, ctor, bare)
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        if len(targets) != 1:
            continue
        tgt = targets[0]
        key = node_key(tgt)
        if not key:
            continue
        if isinstance(tgt, ast.Attribute):
            cls = _enclosing(tgt, ast.ClassDef)
            if cls is None:
                continue
            lock_id = f"{sf.rel}::{cls.name}{key}"
            scope = "class"
        elif _enclosing(tgt, _FUNC_DEFS) is None \
                and _enclosing(tgt, ast.ClassDef) is not None:
            # class-body declaration (`class C: _mu = Lock()`): acquired
            # through `self._mu`, so index it like an attribute lock
            cls = _enclosing(tgt, ast.ClassDef)
            key = "." + key
            lock_id = f"{sf.rel}::{cls.name}{key}"
            scope = "class"
        else:
            fn = _enclosing(tgt, _FUNC_DEFS)
            if fn is None:
                lock_id = f"{sf.rel}::{key}"
                scope = "module"
            else:
                chain = [fn.name]
                outer = _enclosing(fn, _FUNC_DEFS)
                while outer is not None:
                    chain.append(outer.name)
                    outer = _enclosing(outer, _FUNC_DEFS)
                lock_id = f"{sf.rel}::{'.'.join(reversed(chain))}.{key}"
                scope = "local"
        out.append(LockInfo(lock_id, kind, sf.rel, ctor.lineno, scope,
                            key))
    return out


# ---------------------------------------------------------------------------
# per-file auxiliary typing (queues, events, sockets, threads, shm)

_TYPE_CTORS = {"Queue": "queue", "SimpleQueue": "queue",
               "LifoQueue": "queue", "PriorityQueue": "queue",
               "JoinableQueue": "queue",
               "Event": "event", "SharedMemory": "shm",
               "Thread": "thread", "Process": "thread",
               "socket": "socket", "create_connection": "socket",
               "create_server": "socket"}


def _typed_keys(sf: SourceFile) -> Dict[str, str]:
    types: Dict[str, str] = {}
    for node in sf.walk():
        if not isinstance(node, ast.Call):
            continue
        last = call_name(node).split(".")[-1]
        t = _TYPE_CTORS.get(last)
        if t is None:
            continue
        stmt = node
        while stmt is not None and not isinstance(stmt, ast.stmt):
            stmt = getattr(stmt, "parent", None)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and stmt.value is node:
            key = node_key(stmt.targets[0])
            if key:
                types[key] = t
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is node:
            key = node_key(stmt.target)
            if key:
                types[key] = t
    return types


def _has_timeout(call: ast.Call, is_put: bool = False) -> bool:
    for kw in call.keywords:
        if kw.arg == "timeout":
            return True
        if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    n = len(call.args)
    base = 1 if is_put else 0   # put's first positional is the item
    if n >= base + 2:
        return True             # (block, timeout) positionals
    if n == base + 1 and isinstance(call.args[base], ast.Constant) \
            and call.args[base].value is False:
        return True             # block=False positionally
    return False


def _blocking_desc(sf: SourceFile, call: ast.Call, types: Dict[str, str],
                   time_names: Set[str], subprocess_names: Set[str],
                   cond_keys: Set[str]) -> Optional[str]:
    cn = call_name(call)
    head = cn.split(".")[0] if cn else ""
    last = cn.split(".")[-1] if cn else ""
    if head in time_names and last == "sleep":
        return "time.sleep()"
    if head in subprocess_names and "." in cn:
        return f"subprocess.{last}()"
    if last == "create_connection" and head in ("socket", "sock"):
        return "socket.create_connection()"
    if last == "SharedMemory" or cn.endswith(".SharedMemory"):
        for kw in call.keywords:
            if kw.arg == "create" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is True:
                return "SharedMemory(create=True)"
        return None
    if not isinstance(call.func, ast.Attribute):
        return None
    m = call.func.attr
    key = node_key(call.func.value)
    if m in _SOCKET_METHODS:
        return f"socket {m}()"
    if m in _SOCKET_METHODS_TYPED and types.get(key) == "socket":
        return f"socket {m}()"
    if m == "join":
        if not call.args and not call.keywords:
            # bare join(): Thread/Process/pool — str.join always takes
            # an iterable argument, so a 0-arg join is never the string
            # method
            return "join()"
        if types.get(key) == "thread":
            return "join()"
        return None
    if m in ("get", "put") and types.get(key) == "queue":
        if not _has_timeout(call, is_put=(m == "put")):
            return f"queue.{m}() without timeout"
        return None
    if m == "wait" and (types.get(key) == "event" or key in cond_keys):
        if not call.args and not any(kw.arg == "timeout"
                                     for kw in call.keywords):
            return "wait() without timeout"
    return None


# ---------------------------------------------------------------------------
# per-function scan


@dataclass
class _FuncFacts:
    qual: str
    sf: SourceFile
    direct_acq: Dict[str, str] = field(default_factory=dict)  # lock->site
    direct_block: Dict[str, int] = field(default_factory=dict)  # desc->line
    # (held ((lock, site)...), call node) — for interprocedural edges
    call_events: List[Tuple[Tuple[Tuple[str, str], ...], ast.Call]] = \
        field(default_factory=list)
    # (src, dst, holder_site, acquire_site) — direct syntactic nesting
    direct_edges: List[Tuple[str, str, str, str]] = field(
        default_factory=list)
    # (held, desc, node) — blocking op with a lock held, in THIS body
    block_events: List[Tuple[Tuple[Tuple[str, str], ...], str,
                             ast.Call]] = field(default_factory=list)
    # shared-state accesses for the race pass (analysis/races.py):
    # (held lock ids, node) where node is a `self.attr`/`cls.attr`
    # Attribute, or a Name that is free / global / nonlocal / a closure
    # cell in this scope — recorded in the SAME walk that tracks held
    # sets, so the race pass never re-walks a function body
    access_events: List[Tuple[Tuple[str, ...], ast.AST]] = \
        field(default_factory=list)
    local_names: Set[str] = field(default_factory=set)
    global_names: Set[str] = field(default_factory=set)
    cell_names: Set[str] = field(default_factory=set)


class _Scanner:
    """Walks one function body tracking the held-lock set."""

    def __init__(self, model: "ConcurrencyModel", fi: FuncInfo):
        self.model = model
        self.fi = fi
        self.sf = fi.sf
        self.facts = _FuncFacts(fi.qual, fi.sf)
        self.types = model.file_types[fi.sf.rel]
        self.time_names = model.file_time_names[fi.sf.rel]
        self.subprocess_names = model.file_subprocess_names[fi.sf.rel]
        self.cond_keys = model.file_cond_keys[fi.sf.rel]
        self._scope_names()

    def _scope_names(self) -> None:
        """Name classification for the race pass: names bound in THIS
        scope (locals), ``global``/``nonlocal`` declarations, and
        closure cells (locals a nested def also references)."""
        node = self.fi.node
        body = node.body if node is not None else self.sf.tree.body
        locs: Set[str] = set()
        gl: Set[str] = set()
        nl: Set[str] = set()
        nested: List[ast.AST] = []
        if node is not None and isinstance(node, _FUNC_DEFS):
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                locs.add(arg.arg)
        stack = list(body)
        while stack:
            n = stack.pop()
            if isinstance(n, _SCOPES):
                if isinstance(n, (*_FUNC_DEFS, ast.ClassDef)):
                    locs.add(n.name)
                nested.append(n)
                continue
            if isinstance(n, ast.Global):
                gl.update(n.names)
                continue
            if isinstance(n, ast.Nonlocal):
                nl.update(n.names)
                continue
            if isinstance(n, ast.Name) \
                    and isinstance(n.ctx, (ast.Store, ast.Del)):
                locs.add(n.id)
            elif isinstance(n, (ast.Import, ast.ImportFrom)):
                for al in n.names:
                    locs.add((al.asname or al.name).split(".")[0])
            elif isinstance(n, ast.ExceptHandler) and n.name:
                locs.add(n.name)
            stack.extend(ast.iter_child_nodes(n))
        locs -= gl | nl
        used_below: Set[str] = set()
        for sub in nested:
            for n in ast.walk(sub):
                if isinstance(n, ast.Name):
                    used_below.add(n.id)
                elif isinstance(n, ast.Nonlocal):
                    used_below.update(n.names)
        self._locals = locs
        self._globals = gl
        self._nonlocals = nl
        self._cells = locs & used_below
        self.facts.local_names = locs
        self.facts.global_names = gl
        self.facts.cell_names = self._cells

    def _site(self, node) -> str:
        return f"{self.sf.rel}:{getattr(node, 'lineno', 0)}"

    def resolve_lock(self, expr) -> Optional[str]:
        """Lock id for an acquisition expression, or None."""
        while isinstance(expr, ast.Subscript):
            expr = expr.value
        model = self.model
        if isinstance(expr, ast.Name):
            # lexical chain: locals of enclosing functions, then module
            prefix = self.fi.qual.split("::", 1)[1]
            parts = [] if prefix == "<module>" else prefix.split(".")
            while True:
                cand = f"{self.sf.rel}::{'.'.join(parts + [expr.id])}" \
                    if parts else f"{self.sf.rel}::{expr.id}"
                if cand in model.locks:
                    return cand
                if not parts:
                    return None
                parts.pop()
        if isinstance(expr, ast.Attribute):
            attr = "." + expr.attr
            cls = self.fi.cls
            if cls is not None:
                cand = f"{cls.sf.rel}::{cls.name}{attr}"
                if cand in model.locks:
                    return cand
                for base in cls.bases:
                    for bi in model.cg.classes.get(base, []):
                        cand = f"{bi.sf.rel}::{bi.name}{attr}"
                        if cand in model.locks:
                            return cand
            matches = model.attr_locks.get(attr, [])
            if len(matches) == 1:
                return matches[0]
        return None

    # ----------------------------------------------------------- events
    def _note_acquire(self, lock: str, node,
                      held: List[Tuple[str, str]]) -> None:
        site = self._site(node)
        self.facts.direct_acq.setdefault(lock, site)
        for h, hsite in held:
            if h != lock:
                self.facts.direct_edges.append((h, lock, hsite, site))

    def handle_call(self, call: ast.Call,
                    held: List[Tuple[str, str]]) -> None:
        fn = call.func
        if isinstance(fn, ast.Attribute) \
                and fn.attr in ("acquire", "release", "locked"):
            return  # lock operations are handled by the region tracker
        desc = _blocking_desc(self.sf, call, self.types, self.time_names,
                              self.subprocess_names, self.cond_keys)
        if desc is not None and self.sf.rel != self.model.kinds_rel:
            self.facts.direct_block.setdefault(desc, call.lineno)
            eff = list(held)
            if desc.startswith("wait()"):
                # Condition.wait releases its own lock while waiting
                own = self.resolve_lock(fn.value) \
                    if isinstance(fn, ast.Attribute) else None
                eff = [(h, s) for h, s in eff if h != own]
            if eff:
                self.facts.block_events.append((tuple(eff), desc, call))
        if held:
            site = self.model.cg.by_node.get(id(call))
            if site is not None and site.kind == "call" and site.targets:
                self.facts.call_events.append((tuple(held), call))

    # ------------------------------------------------------------- walk
    def run(self) -> _FuncFacts:
        node = self.fi.node
        body = node.body if node is not None else self.sf.tree.body
        self.visit_stmts(body, [])
        return self.facts

    def visit_stmts(self, stmts, held: List[Tuple[str, str]]) -> None:
        held = list(held)
        for stmt in stmts:
            self.visit_node(stmt, held)
            # bare acquire()/release() sequencing: effective from the
            # statement AFTER the acquire, gone after the release
            for lock, node, op in self._lock_ops(stmt):
                if op == "acquire":
                    self._note_acquire(lock, node, held)
                    held.append((lock, self._site(node)))
                else:
                    for i in range(len(held) - 1, -1, -1):
                        if held[i][0] == lock:
                            del held[i]
                            break

    def _lock_ops(self, stmt):
        """acquire()/release() calls at THIS statement's level only —
        simple statements entirely, compound statements just their test
        / iterable expression (ops inside nested suites sequence inside
        those suites)."""
        if isinstance(stmt, (ast.Expr, ast.Assign, ast.AnnAssign,
                             ast.AugAssign, ast.Return, ast.Assert)):
            exprs = [stmt]
        elif isinstance(stmt, (ast.If, ast.While)):
            exprs = [stmt.test]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            exprs = [stmt.iter]
        else:
            return []
        out = []
        for e in exprs:
            for node in ast.walk(e):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("acquire", "release"):
                    lock = self.resolve_lock(node.func.value)
                    if lock is not None:
                        out.append((lock, node, node.func.attr))
        return out

    def visit_node(self, node, held: List[Tuple[str, str]]) -> None:
        if isinstance(node, _SCOPES):
            return  # separate scope: scanned with its own empty held set
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in ("self", "cls") \
                and not (node.attr.startswith("__")
                         and node.attr.endswith("__")):
            self.facts.access_events.append(
                (tuple(h for h, _ in held), node))
        elif isinstance(node, ast.Name):
            nid = node.id
            if nid in self._globals or nid in self._nonlocals \
                    or nid in self._cells \
                    or (nid not in self._locals
                        and isinstance(node.ctx, ast.Load)):
                self.facts.access_events.append(
                    (tuple(h for h, _ in held), node))
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = list(held)
            for item in node.items:
                self.visit_node(item.context_expr, inner)
                lock = self.resolve_lock(item.context_expr)
                if lock is not None:
                    self._note_acquire(lock, item.context_expr, inner)
                    inner.append((lock, self._site(item.context_expr)))
            self.visit_stmts(node.body, inner)
            return
        if isinstance(node, ast.Call):
            self.handle_call(node, held)
        for _fname, value in ast.iter_fields(node):
            if isinstance(value, list):
                if value and isinstance(value[0], ast.stmt):
                    self.visit_stmts(value, held)
                else:
                    for v in value:
                        if isinstance(v, ast.AST):
                            self.visit_node(v, held)
            elif isinstance(value, ast.AST):
                self.visit_node(value, held)


# ---------------------------------------------------------------------------
# the whole-program model


@dataclass
class OrderEdge:
    src: str
    dst: str
    holder_site: str
    acquire_site: str
    chain: Tuple[str, ...]   # function quals, caller first


class ConcurrencyModel:
    def __init__(self, project: Project):
        self.project = project
        self.cg = get_callgraph(project)
        self.kinds_rel = project.kinds_file
        self.locks: Dict[str, LockInfo] = {}
        self.attr_locks: Dict[str, List[str]] = {}
        self.file_types: Dict[str, Dict[str, str]] = {}
        self.file_time_names: Dict[str, Set[str]] = {}
        self.file_subprocess_names: Dict[str, Set[str]] = {}
        self.file_cond_keys: Dict[str, Set[str]] = {}
        for sf in project.files:
            if sf.tree is None:
                self.file_types[sf.rel] = {}
                self.file_time_names[sf.rel] = set()
                self.file_subprocess_names[sf.rel] = set()
                self.file_cond_keys[sf.rel] = set()
                continue
            for li in discover_locks(sf, self.cg):
                self.locks.setdefault(li.lock_id, li)
            self.file_types[sf.rel] = _typed_keys(sf)
            self.file_time_names[sf.rel] = _module_names(sf, "time")
            self.file_subprocess_names[sf.rel] = _module_names(
                sf, "subprocess")
        for lid, li in self.locks.items():
            if li.scope == "class":
                self.attr_locks.setdefault(li.key, []).append(lid)
        for sf in project.files:
            self.file_cond_keys[sf.rel] = {
                li.key for li in self.locks.values()
                if li.path == sf.rel and li.kind == "Condition"}
        self.facts: Dict[str, _FuncFacts] = {}
        for qual in sorted(self.cg.funcs):
            fi = self.cg.funcs[qual]
            if fi.sf.tree is None:
                continue
            self.facts[qual] = _Scanner(self, fi).run()
        self._propagate()
        self.edges: Dict[Tuple[str, str], OrderEdge] = {}
        self._build_edges()
        self.cycles: List[List[str]] = _find_cycles(
            {e for e in self.edges})

    # ------------------------------------------------------ propagation
    def _propagate(self) -> None:
        """acq_closure[f]: lock -> (via callee | None, site); similarly
        block_closure[f]: desc -> (via, line). Fixpoint over call edges
        (thread edges excluded — held sets do not cross threads)."""
        callees: Dict[str, List[str]] = {}
        callers: Dict[str, Set[str]] = {}
        for qual in self.facts:
            outs: List[str] = []
            for site in self.cg.calls.get(qual, []):
                if site.kind != "call":
                    continue
                for t in site.targets:
                    if t in self.facts and t != qual:
                        outs.append(t)
                        callers.setdefault(t, set()).add(qual)
            callees[qual] = sorted(set(outs))
        self.acq_closure: Dict[str, Dict[str, Tuple[Optional[str], str]]]\
            = {q: {lk: (None, site)
                   for lk, site in f.direct_acq.items()}
               for q, f in self.facts.items()}
        self.block_closure: Dict[str, Dict[str,
                                           Tuple[Optional[str], int]]] = \
            {q: {d: (None, ln) for d, ln in f.direct_block.items()}
             for q, f in self.facts.items()}
        work = sorted(self.facts)
        pending = set(work)
        while work:
            q = work.pop()
            pending.discard(q)
            grew = False
            acq = self.acq_closure[q]
            blk = self.block_closure[q]
            for t in callees.get(q, []):
                for lk, (_via, site) in self.acq_closure[t].items():
                    if lk not in acq:
                        acq[lk] = (t, site)
                        grew = True
                for d, (_via, ln) in self.block_closure[t].items():
                    if d not in blk:
                        blk[d] = (t, ln)
                        grew = True
            if grew:
                for c in callers.get(q, ()):
                    if c not in pending:
                        pending.add(c)
                        work.append(c)

    def chain_for(self, start: str, lock: str) -> Tuple[str, ...]:
        """Witness call chain from ``start`` to the function that
        directly acquires ``lock``."""
        chain = [start]
        seen = {start}
        cur = start
        while True:
            via, _site = self.acq_closure[cur].get(lock, (None, ""))
            if via is None or via in seen:
                return tuple(chain)
            chain.append(via)
            seen.add(via)
            cur = via

    def block_chain_for(self, start: str, desc: str) -> Tuple[str, ...]:
        chain = [start]
        seen = {start}
        cur = start
        while True:
            via, _ln = self.block_closure[cur].get(desc, (None, 0))
            if via is None or via in seen:
                return tuple(chain)
            chain.append(via)
            seen.add(via)
            cur = via

    # ------------------------------------------------------------ edges
    def _build_edges(self) -> None:
        for qual in sorted(self.facts):
            f = self.facts[qual]
            for src, dst, hsite, asite in f.direct_edges:
                self.edges.setdefault(
                    (src, dst),
                    OrderEdge(src, dst, hsite, asite, (qual,)))
            for held, call in f.call_events:
                site = self.cg.by_node[id(call)]
                for t in sorted(site.targets):
                    closure = self.acq_closure.get(t)
                    if not closure:
                        continue
                    for lk in sorted(closure):
                        asite = closure[lk][1]
                        chain = (qual,) + self.chain_for(t, lk)
                        for h, hsite in held:
                            if h == lk:
                                continue
                            self.edges.setdefault(
                                (h, lk),
                                OrderEdge(h, lk, hsite, asite, chain))

    # --------------------------------------------------------- findings
    def _mk_finding(self, rule_id: str, path: str, line: int,
                    msg: str) -> Finding:
        sf = next((s for s in self.project.files if s.rel == path), None)
        snippet = sf.line_text(line) if sf is not None else ""
        return Finding(rule_id, path, line, msg, snippet=snippet)

    def order_findings(self) -> List[Finding]:
        out = []
        for cycle in self.cycles:
            # rotate deterministically to the smallest lock id
            k = cycle.index(min(cycle))
            cyc = cycle[k:] + cycle[:k]
            legs = []
            for i, src in enumerate(cyc):
                dst = cyc[(i + 1) % len(cyc)]
                e = self.edges[(src, dst)]
                legs.append(
                    f"[{_short(src)} then {_short(dst)}] via "
                    f"{_fmt_chain(e.chain)}: acquires {_short(dst)} at "
                    f"{e.acquire_site} while holding {_short(src)} "
                    f"(from {e.holder_site})")
            first = self.edges[(cyc[0], cyc[1 % len(cyc)])]
            path, _, line = first.holder_site.rpartition(":")
            msg = (f"potential deadlock: lock-order cycle "
                   f"{' -> '.join(_short(c) for c in cyc)} -> "
                   f"{_short(cyc[0])}; " + "; ".join(legs)
                   + " — pick one global acquisition order and make "
                     "every path follow it")
            out.append(self._mk_finding("lock-order", path, int(line),
                                        msg))
        return out

    def blocking_findings(self) -> List[Finding]:
        out = []
        seen: Set[Tuple[str, int, str]] = set()
        for qual in sorted(self.facts):
            f = self.facts[qual]
            for held, desc, node in f.block_events:
                key = (f.sf.rel, node.lineno, desc)
                if key in seen:
                    continue
                seen.add(key)
                locks = ", ".join(_short(h) for h, _ in held)
                out.append(self._mk_finding(
                    "lock-blocking", f.sf.rel, node.lineno,
                    f"blocking {desc} while holding {locks} — every "
                    f"other thread waiting on the lock stalls behind "
                    f"this call; move it outside the critical section "
                    f"or bound it with a timeout"))
            for held, call in f.call_events:
                site = self.cg.by_node[id(call)]
                for t in sorted(site.targets):
                    blk = self.block_closure.get(t)
                    if not blk:
                        continue
                    for desc in sorted(blk):
                        # only flag ops the callee itself introduces —
                        # direct ops at this site were reported above
                        key = (f.sf.rel, call.lineno, desc)
                        if key in seen:
                            continue
                        seen.add(key)
                        locks = ", ".join(_short(h) for h, _ in held)
                        chain = (qual,) + self.block_chain_for(t, desc)
                        out.append(self._mk_finding(
                            "lock-blocking", f.sf.rel, call.lineno,
                            f"call can block ({desc} reachable via "
                            f"{_fmt_chain(chain)}) while holding "
                            f"{locks} — a stall there wedges every "
                            f"waiter on the lock; restructure or bound "
                            f"the wait"))
        return out

    # ------------------------------------------------------------- json
    def to_json(self) -> dict:
        return {
            "locks": {lid: {"kind": li.kind, "path": li.path,
                            "line": li.line, "scope": li.scope}
                      for lid, li in sorted(self.locks.items())},
            "edges": [{"src": e.src, "dst": e.dst,
                       "holder_site": e.holder_site,
                       "acquire_site": e.acquire_site,
                       "chain": list(e.chain)}
                      for (_s, _d), e in sorted(self.edges.items())],
            "cycles": [list(c) for c in self.cycles],
            "ambiguous_methods": dict(sorted(
                self.cg.ambiguous.items())),
        }


def _module_names(sf: SourceFile, module: str) -> Set[str]:
    out = set()
    for node in sf.walk():
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out.add(a.asname or a.name)
    return out


def _short(lock_id: str) -> str:
    path, _, name = lock_id.partition("::")
    return f"{path.rsplit('/', 1)[-1]}::{name}"


def _fmt_chain(chain: Tuple[str, ...], limit: int = 6) -> str:
    names = [q.split("::", 1)[1] for q in chain[:limit]]
    if len(chain) > limit:
        names.append("...")
    return " -> ".join(names)


def _find_cycles(edges: Set[Tuple[str, str]]) -> List[List[str]]:
    """Cycles in the lock-order graph: one representative cycle per
    strongly connected component with >= 2 nodes (self edges are
    excluded upstream). Deterministic."""
    adj: Dict[str, List[str]] = {}
    nodes: Set[str] = set()
    for a, b in edges:
        adj.setdefault(a, []).append(b)
        nodes.add(a)
        nodes.add(b)
    for k in adj:
        adj[k].sort()
    # Tarjan SCC, iterative
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []

    for root in sorted(nodes):
        if root in index:
            continue
        work = [(root, iter(adj.get(root, [])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj.get(w, []))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))
    # extract one concrete cycle per SCC: BFS from the smallest node
    # back to itself inside the component (an SCC guarantees the path)
    cycles = []
    for comp in sccs:
        comp_set = set(comp)
        start = comp[0]
        parent: Dict[str, str] = {}
        seen = {start}
        frontier = [start]
        closer: Optional[str] = None
        while frontier and closer is None:
            nxt_frontier = []
            for v in frontier:
                for w in adj.get(v, []):
                    if w not in comp_set:
                        continue
                    if w == start:
                        closer = v
                        break
                    if w not in seen:
                        seen.add(w)
                        parent[w] = v
                        nxt_frontier.append(w)
                if closer is not None:
                    break
            frontier = nxt_frontier
        path = []
        cur = closer if closer is not None else start
        while cur != start:
            path.append(cur)
            cur = parent[cur]
        path.append(start)
        path.reverse()
        cycles.append(path)
    return cycles


def get_model(project: Project) -> ConcurrencyModel:
    m = getattr(project, "_concurrency_model", None)
    if m is None or m.project is not project:
        m = ConcurrencyModel(project)
        project._concurrency_model = m  # type: ignore[attr-defined]
    return m


# ---------------------------------------------------------------------------
# rules


@rule("lock-order",
      "the global lock-acquisition order must be acyclic (deadlock)",
      cross=True)
def check_lock_order(project: Project) -> List[Finding]:
    return get_model(project).order_findings()


@rule("lock-blocking",
      "no blocking calls (socket/queue/join/sleep/subprocess/shm) "
      "while holding a lock", cross=True)
def check_lock_blocking(project: Project) -> List[Finding]:
    return get_model(project).blocking_findings()


@rule("cond-wait-while",
      "Condition.wait() must sit inside a while-predicate loop")
def check_cond_wait(sf: SourceFile) -> List[Finding]:
    bare = _bare_lock_names(sf)
    cond_keys = set()
    for node in sf.walk():
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value
            if isinstance(value, ast.Call) \
                    and _lock_ctor_kind(sf, value, bare) == "Condition":
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if len(targets) == 1:
                    key = node_key(targets[0])
                    if key:
                        cond_keys.add(key)
    out = []
    for node in sf.walk():
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "wait"
                and node_key(node.func.value) in cond_keys):
            continue
        cur = getattr(node, "parent", None)
        in_while = False
        while cur is not None and not isinstance(cur, _FUNC_DEFS):
            if isinstance(cur, ast.While):
                in_while = True
                break
            cur = getattr(cur, "parent", None)
        if not in_while:
            out.append(sf.finding(
                "cond-wait-while", node,
                "Condition.wait() outside a while-predicate loop — "
                "spurious wakeups and missed notifies are part of the "
                "contract; re-check the predicate: `while not pred: "
                "cond.wait()` (or use wait_for)"))
    return out
