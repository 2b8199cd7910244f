"""Project-wide call graph for the interprocedural concurrency pass (a
copy of difacto_tpu/analysis/callgraph.py).

Built once per :class:`core.Project` from the same parsed ASTs the local
rules use. Nodes are functions (module functions, methods, nested
functions, plus one ``<module>`` pseudo-function per file for top-level
code); edges are call sites with a best-effort resolution to their
possible targets:

- **plain names** resolve through lexical scope: nested functions of the
  enclosing function, module-level functions of the same file, then
  ``from m import f`` object imports (including classes, which resolve
  to their ``__init__``);
- **module attributes** (``alias.f(...)``) resolve through the file's
  import table, including relative imports (``from ..utils import
  faultinject`` -> ``faultinject.fire`` lands in utils/faultinject.py);
- **``self.m(...)``** resolves in the enclosing class, then its bases
  (by name, within the project), then falls back to the attribute
  heuristic;
- **attribute calls** (``obj.m(...)``) use the attribute heuristic:
  every project method named ``m`` is a candidate, capped at
  :data:`MAX_METHOD_FANOUT` definitions — past the cap the call is left
  unresolved (recorded in ``ambiguous``) rather than fanning out to
  half the tree. This is deliberate over-approximation: for lock-order
  analysis a superset of real targets is safe, an unbounded superset is
  noise.
- **thread hand-offs** — ``Thread(target=f)`` / ``Process(target=f)``
  constructors, ``pool.submit(f, ...)`` and ``pool.map(f, it)`` — are
  separate ``thread``-kind edges: the target runs on another thread, so
  callers must NOT propagate held locks across them (the concurrency
  pass treats them as reachability-only). The target REFERENCE resolves
  through every form the tree actually uses: a plain name, ``self.m`` /
  ``mod.f`` dotted refs, ``functools.partial(f, ...)`` (the first
  positional is the callee), ``lambda: f(...)`` (every call inside the
  lambda body is a target), and a local alias (``run = self._loop;
  Thread(target=run)`` — single-assignment locals are chased one level
  at a time up to a small depth cap).

Known blind spots (documented in docs/static_analysis.md): calls through
variables holding functions (other than the single-assignment thread-
target aliases above), ``super()`` chains, ``getattr`` dispatch, and
decorator indirection all resolve to nothing.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .core import Project, SourceFile, dotted

# attribute-call resolution gives up past this many same-named methods
MAX_METHOD_FANOUT = 8

# method names shadowed by builtin collection/str methods: an unqualified
# `obj.get(...)` is a dict read a thousand times for every WorkloadPool
# dispatch, so the attribute heuristic skips them (self.m / Class.m and
# module-qualified calls still resolve precisely)
BUILTIN_SHADOWED = frozenset({
    "get", "add", "clear", "pop", "popleft", "update", "keys", "values",
    "items", "append", "appendleft", "extend", "remove", "discard",
    "copy", "sort", "insert", "index", "count", "setdefault",
    "split", "rsplit", "strip", "lstrip", "rstrip", "partition",
    "startswith", "endswith", "encode", "decode", "format", "lower",
    "upper", "replace", "find", "rfind", "search", "match", "group",
    "resolve",  # pathlib.Path.resolve on every checkpoint/config path
})

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclass
class ClassInfo:
    qual: str                       # "rel.py::Class"
    name: str
    sf: SourceFile
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)   # simple base names
    methods: Dict[str, str] = field(default_factory=dict)  # name -> qual


@dataclass
class FuncInfo:
    qual: str                       # "rel.py::Class.method" / "rel.py::f"
    name: str
    sf: SourceFile
    node: Optional[ast.AST]         # None for the <module> pseudo-func
    cls: Optional[ClassInfo] = None


@dataclass
class CallSite:
    node: ast.Call
    kind: str                       # "call" | "thread"
    targets: Tuple[str, ...]        # resolved FuncInfo quals
    # True when the targets came from the MULTI-candidate attribute
    # heuristic: a safe over-approximation for lock-order analysis, but
    # the race pass must not smear thread-root reachability through it
    fuzzy: bool = False


def _module_name(rel: str) -> str:
    parts = rel[:-3].split("/") if rel.endswith(".py") else rel.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class CallGraph:
    """Index + resolver. ``calls[qual]`` lists every call site inside a
    function in source order; ``by_node[id(call)]`` finds the same
    record from an AST node (the concurrency walker's entry)."""

    def __init__(self, project: Project):
        self.project = project
        self.funcs: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, List[ClassInfo]] = {}       # by name
        self.module_funcs: Dict[str, Dict[str, str]] = {}   # rel -> name->qual
        self.module_classes: Dict[str, Dict[str, ClassInfo]] = {}
        self.methods_by_name: Dict[str, List[str]] = {}
        self.modname_to_rel: Dict[str, str] = {}
        self.calls: Dict[str, List[CallSite]] = {}
        self.by_node: Dict[int, CallSite] = {}
        self.owner_of: Dict[int, str] = {}   # id(ast node) -> func qual
        self.ambiguous: Dict[str, int] = {}  # method name -> defs (over cap)
        self._def_qual: Dict[int, str] = {}  # id(def node) -> qual
        self._fuzzy = False   # sticky per-call-site heuristic marker
        self._imports: Dict[str, Tuple[Dict[str, str],
                                       Dict[str, Tuple[str, str]]]] = {}
        for sf in project.files:
            if sf.tree is not None:
                self.modname_to_rel[_module_name(sf.rel)] = sf.rel
        for sf in project.files:
            if sf.tree is not None:
                self._collect_defs(sf)
        for sf in project.files:
            if sf.tree is not None:
                self._imports[sf.rel] = self._collect_imports(sf)
        for sf in project.files:
            if sf.tree is not None:
                self._collect_calls(sf)

    # ------------------------------------------------------- definitions
    def _collect_defs(self, sf: SourceFile) -> None:
        mod_q = sf.rel + "::<module>"
        self.funcs[mod_q] = FuncInfo(mod_q, "<module>", sf, None)
        self.module_funcs.setdefault(sf.rel, {})
        self.module_classes.setdefault(sf.rel, {})

        def walk(body, prefix: str, cls: Optional[ClassInfo],
                 top: bool) -> None:
            for stmt in body:
                if isinstance(stmt, _FUNC_DEFS):
                    qual = f"{sf.rel}::{prefix}{stmt.name}"
                    self.funcs[qual] = FuncInfo(qual, stmt.name, sf,
                                                stmt, cls)
                    self._def_qual[id(stmt)] = qual
                    if cls is not None and prefix == cls.qual.split(
                            "::", 1)[1] + ".":
                        cls.methods[stmt.name] = qual
                        self.methods_by_name.setdefault(
                            stmt.name, []).append(qual)
                    elif top:
                        self.module_funcs[sf.rel][stmt.name] = qual
                    # nested defs keep the class context for `self`
                    walk(stmt.body, prefix + stmt.name + ".", cls, False)
                elif isinstance(stmt, ast.ClassDef):
                    ci = ClassInfo(f"{sf.rel}::{prefix}{stmt.name}",
                                   stmt.name, sf, stmt,
                                   bases=[dotted(b).split(".")[-1]
                                          for b in stmt.bases if dotted(b)])
                    self.classes.setdefault(stmt.name, []).append(ci)
                    if top:
                        self.module_classes[sf.rel][stmt.name] = ci
                    walk(stmt.body, prefix + stmt.name + ".", ci, False)
                else:
                    # defs inside if/try blocks at the same level
                    for sub in ast.iter_child_nodes(stmt):
                        if isinstance(sub, (ast.ClassDef, *_FUNC_DEFS)):
                            walk([sub], prefix, cls, top)

        walk(sf.tree.body, "", None, True)

    # ----------------------------------------------------------- imports
    def _collect_imports(self, sf: SourceFile):
        """(module aliases: name -> dotted module,
        object imports: name -> (module dotted, member))."""
        aliases: Dict[str, str] = {}
        objs: Dict[str, Tuple[str, str]] = {}
        my_mod = _module_name(sf.rel)
        my_pkg_parts = my_mod.split(".")
        if not sf.rel.endswith("__init__.py"):
            my_pkg_parts = my_pkg_parts[:-1]
        for node in sf.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        aliases[a.asname] = a.name
                    else:
                        aliases[a.name.split(".")[0]] = a.name.split(".")[0]
                        aliases.setdefault(a.name, a.name)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base_parts = my_pkg_parts[:len(my_pkg_parts)
                                              - (node.level - 1)]
                    base = ".".join(base_parts)
                    if node.module:
                        base = f"{base}.{node.module}" if base \
                            else node.module
                else:
                    base = node.module or ""
                for a in node.names:
                    name = a.asname or a.name
                    if f"{base}.{a.name}" in self.modname_to_rel:
                        aliases[name] = f"{base}.{a.name}"
                    elif base in self.modname_to_rel:
                        objs[name] = (base, a.name)
        return aliases, objs

    # --------------------------------------------------------- resolvers
    def _class_init(self, ci: ClassInfo) -> Tuple[str, ...]:
        q = ci.methods.get("__init__")
        return (q,) if q else ()

    def _resolve_in_class(self, ci: Optional[ClassInfo], method: str,
                          depth: int = 0) -> Tuple[str, ...]:
        if ci is None or depth > 4:
            return ()
        q = ci.methods.get(method)
        if q:
            return (q,)
        for base in ci.bases:
            for bi in self.classes.get(base, []):
                got = self._resolve_in_class(bi, method, depth + 1)
                if got:
                    return got
        return ()

    def _method_heuristic(self, method: str) -> Tuple[str, ...]:
        if method.startswith("__") and method.endswith("__"):
            return ()
        if method in BUILTIN_SHADOWED:
            return ()
        quals = self.methods_by_name.get(method, [])
        if not quals:
            return ()
        if len(quals) > MAX_METHOD_FANOUT:
            self.ambiguous[method] = len(quals)
            return ()
        out = tuple(sorted(set(quals)))
        if len(out) > 1:
            # several same-named candidates: over-approximation, marked
            # so CallSite.fuzzy reaches the race pass
            self._fuzzy = True
        return out

    def _resolve_name(self, sf: SourceFile, owner_qual: str,
                      name: str) -> Tuple[str, ...]:
        # nested functions of the lexically enclosing chain
        prefix = owner_qual.split("::", 1)[1] if "::" in owner_qual else ""
        parts = prefix.split(".") if prefix and prefix != "<module>" else []
        while True:
            cand = f"{sf.rel}::{'.'.join(parts + [name])}" if parts \
                else f"{sf.rel}::{name}"
            if cand in self.funcs and cand != owner_qual:
                return (cand,)
            if not parts:
                break
            parts.pop()
        q = self.module_funcs.get(sf.rel, {}).get(name)
        if q:
            return (q,)
        ci = self.module_classes.get(sf.rel, {}).get(name)
        if ci is not None:
            return self._class_init(ci)
        aliases, objs = self._imports.get(sf.rel, ({}, {}))
        if name in objs:
            mod, member = objs[name]
            rel = self.modname_to_rel.get(mod)
            if rel:
                q = self.module_funcs.get(rel, {}).get(member)
                if q:
                    return (q,)
                ci = self.module_classes.get(rel, {}).get(member)
                if ci is not None:
                    return self._class_init(ci)
        return ()

    def _resolve_dotted(self, sf: SourceFile, owner: FuncInfo,
                        cn: str) -> Tuple[str, ...]:
        parts = cn.split(".")
        if parts[0] in ("self", "cls") and len(parts) == 2:
            got = self._resolve_in_class(owner.cls, parts[1])
            return got or self._method_heuristic(parts[1])
        aliases, _objs = self._imports.get(sf.rel, ({}, {}))
        if parts[0] in aliases:
            # longest module prefix match: `import a.b` binds `a`, and
            # `a.b.f` must land in module a.b
            mod = aliases[parts[0]]
            rest = parts[1:]
            while rest and f"{mod}.{rest[0]}" in self.modname_to_rel:
                mod = f"{mod}.{rest[0]}"
                rest = rest[1:]
            rel = self.modname_to_rel.get(mod)
            if rel and len(rest) == 1:
                q = self.module_funcs.get(rel, {}).get(rest[0])
                if q:
                    return (q,)
                ci = self.module_classes.get(rel, {}).get(rest[0])
                if ci is not None:
                    return self._class_init(ci)
            if rel and len(rest) == 2:
                ci = self.module_classes.get(rel, {}).get(rest[0])
                if ci is not None:
                    got = self._resolve_in_class(ci, rest[1])
                    if got:
                        return got
            # the head names a MODULE (project or stdlib): whatever the
            # attribute is, it is not some project class's method — do
            # not fall through to the attribute heuristic (that is how
            # `subprocess.run` would smear into SGDLearner.run)
            return ()
        return self._method_heuristic(parts[-1])

    def resolve(self, sf: SourceFile, owner: FuncInfo,
                call: ast.Call) -> Tuple[str, Tuple[str, ...]]:
        """(kind, target quals) for one call node."""
        fn = call.func
        cn = dotted(fn)
        # thread hand-offs first: the target runs on another thread
        if cn and (cn == "Thread" or cn.endswith(".Thread")
                   or cn == "Process" or cn.endswith(".Process")):
            for kw in call.keywords:
                if kw.arg == "target":
                    return ("thread", self._resolve_ref(sf, owner,
                                                        kw.value))
            return ("call", ())
        if isinstance(fn, ast.Attribute) and fn.attr == "submit" \
                and call.args:
            tgt = self._resolve_ref(sf, owner, call.args[0])
            if tgt:
                return ("thread", tgt)
        if isinstance(fn, ast.Attribute) and fn.attr == "map" \
                and len(call.args) >= 2:
            tgt = self._resolve_ref(sf, owner, call.args[0])
            if tgt:
                return ("thread", tgt)
        if isinstance(fn, ast.Attribute) and "." not in cn:
            # receiver is not a name chain (a call result, subscript,
            # ...): `x().m()` still dispatches on a project method named
            # m — use the attribute heuristic directly
            return ("call", self._method_heuristic(fn.attr))
        if not cn:
            return ("call", ())
        if "." not in cn:
            return ("call", self._resolve_name(sf, owner.qual, cn))
        return ("call", self._resolve_dotted(sf, owner, cn))

    def _resolve_ref(self, sf: SourceFile, owner: FuncInfo,
                     expr, depth: int = 0) -> Tuple[str, ...]:
        """Resolve a function REFERENCE (thread target, submit arg):
        names, ``self.m``/``mod.f`` attributes, ``functools.partial``
        wrappers, lambdas, and single-assignment local aliases."""
        if depth > 3:
            return ()
        if isinstance(expr, ast.Name):
            got = self._resolve_name(sf, owner.qual, expr.id)
            if got:
                return got
            alias = self._local_alias(owner, expr.id)
            if alias is not None:
                return self._resolve_ref(sf, owner, alias, depth + 1)
            return ()
        if isinstance(expr, ast.Attribute):
            dn = dotted(expr)
            if dn:
                return self._resolve_dotted(sf, owner, dn)
            return ()
        if isinstance(expr, ast.Lambda):
            # `target=lambda: f(x)` — the lambda runs on the new thread,
            # so every call inside its body is a thread target (the
            # lambda shares the owner's lexical scope for resolution)
            out: List[str] = []
            for node in ast.walk(expr.body):
                if isinstance(node, ast.Call):
                    _kind, tgts = self.resolve(sf, owner, node)
                    out.extend(tgts)
            return tuple(sorted(set(out)))
        if isinstance(expr, ast.Call):
            cn = dotted(expr.func)
            if cn and (cn == "partial" or cn.endswith(".partial")) \
                    and expr.args:
                return self._resolve_ref(sf, owner, expr.args[0],
                                         depth + 1)
        return ()

    def _local_alias(self, owner: FuncInfo, name: str):
        """The value of the LAST single-target ``name = <expr>`` in the
        owner function, when the value is a plausible callable reference
        (name/attribute/partial/lambda). Conservative: only one binding
        shape is chased; anything fancier stays unresolved."""
        node = owner.node
        if node is None:
            return None
        found = None
        for stmt in ast.walk(node):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and stmt.targets[0].id == name \
                    and isinstance(stmt.value, (ast.Name, ast.Attribute,
                                                ast.Lambda, ast.Call)):
                found = stmt.value
        if isinstance(found, ast.Name) and found.id == name:
            return None
        return found

    # -------------------------------------------------------- call sites
    def _collect_calls(self, sf: SourceFile) -> None:
        # map every node to its owning function (innermost def)
        def tag(node, qual: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FUNC_DEFS):
                    inner = self._qual_of_def(sf, child, qual)
                    self.owner_of[id(child)] = qual
                    tag(child, inner)
                elif isinstance(child, ast.ClassDef):
                    self.owner_of[id(child)] = qual
                    tag(child, qual)  # class body stmts run at def time
                else:
                    self.owner_of[id(child)] = qual
                    tag(child, qual)

        mod_q = sf.rel + "::<module>"
        self.owner_of[id(sf.tree)] = mod_q
        tag(sf.tree, mod_q)
        # class bodies re-tag: methods' quals were computed in
        # _collect_defs; _qual_of_def reuses them via a reverse lookup
        for node in sf.walk():
            if not isinstance(node, ast.Call):
                continue
            owner_qual = self.owner_of.get(id(node), mod_q)
            owner = self.funcs.get(owner_qual) \
                or self.funcs[mod_q]
            self._fuzzy = False
            kind, targets = self.resolve(sf, owner, node)
            site = CallSite(node, kind, targets, self._fuzzy)
            self.calls.setdefault(owner.qual, []).append(site)
            self.by_node[id(node)] = site
        for sites in self.calls.values():
            sites.sort(key=lambda s: (s.node.lineno, s.node.col_offset))

    def _qual_of_def(self, sf: SourceFile, node, outer_qual: str) -> str:
        """Qual of a def encountered while tagging: the record
        _collect_defs made, or the owner when the def went unrecorded
        (e.g. a def synthesized inside an exotic construct)."""
        return self._def_qual.get(id(node), outer_qual)


def get_callgraph(project: Project) -> CallGraph:
    """One CallGraph per Project instance (the concurrency rules share
    it; building twice would double the whole-tree pass)."""
    cg = getattr(project, "_callgraph_cache", None)
    if cg is None or cg.project is not project:
        cg = CallGraph(project)
        project._callgraph_cache = cg  # type: ignore[attr-defined]
    return cg
