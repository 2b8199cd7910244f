"""Torch compile/transfer flow analysis: the counterpart of
difacto_tpu/analysis/jaxflow.py over the port's ``devtrace`` programs.

The port has no jit. Its step programs are the ``devtrace.traced``
creation sites (serve/executor.py, learners/sgd.py, learners/bcd.py,
learners/lbfgs.py, parallel/capacity.py) and its kernels the
``devtrace.kernel`` entry points of ops/fused.py. In eager PyTorch a new
call signature is what a recompile is in JAX: a new allocation pattern,
and for a CUDA graph (ROADMAP item 1.2) one more graph to capture. A
sync inside a program is what stops a graph being captured at all. This
pass finds every program, follows its call sites through the call graph
(callgraph.py) and checks four property families:

- **torch-recompile** — every static (``traced(f, statics=...)``
  positions) and every shape that reaches a program's call must be drawn
  from a BOUNDED set: constants, config fields (``*.param.*``), sticky
  caps (``ShapeSchedule.cap``), bucket rungs (``ops.batch.bucket``),
  attributes only ever assigned from bounded values and parameters whose
  every exact caller passes bounded values — jaxflow's depth-capped
  fixpoint, copied. A shape is an argument sliced (``x[lo:hi]``) or
  made (``torch.zeros(n)``) at the call: its bounds and sizes must be
  bounded. A static or a shape fed straight from data (``len(...)``,
  ``.size``/``.shape``) is a new signature per distinct value. Also
  flagged: a program wrapped inside a loop or wrapped and called in one
  expression.
- **torch-host-sync** — implicit device->host syncs on the hot path:
  ``float()``/``int()``/``bool()``/``np.asarray``/``.item()``/
  ``.tolist()``/``.cpu()`` of a device value (a program's result, or a
  hot helper's that returns one), inside the hot set and outside
  ``devtrace.fetch``. The hot set is jaxflow's: functions that call a
  program from inside a loop, every ``*._loop``, and what they reach
  over exact call edges.
- **torch-inplace-flow** — the cross-edge half of ``torch-inplace``: a
  function updates its parameter in place (an ``op_`` method or an
  in-place kernel entry, directly or through another such function),
  and an exact caller reads a view of the tensor it passed, bound before
  the call, after the call returns — as if it held the old values.
- **torch-dtype64** (local) — float64 inside traced programs, float64
  device tensors (``dtype=torch.float64`` with a ``device=`` that is not
  the CPU, ``.double()``/``.to(torch.float64)`` inside a program), and
  int32 accumulators incremented in loops.

The runtime half is utils/devtrace.py (``DIFACTO_JAXTRACE=1``); its
dumps are merged with this model by ``python -m
difacto_tpu_torch.tools.devmap --check``: a site whose signatures grew
must be one the model proves bounded (or whose unbounded call carries a
reasoned suppression), and an undeclared sync at a hot-set line must be
one the model flags or a suppression covers.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import CallGraph, get_callgraph
from .core import (Finding, Project, SourceFile, call_name, dotted,
                   enclosing_function, node_key, rule, statement_of)
from .localrules import (inplace_target, is_traced_name,
                         stale_alias_reads, traced_functions)

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOPS = (ast.For, ast.AsyncFor, ast.While)

# calls that quantize a data-dependent value onto a bounded set: the
# sticky caps (data/pack_stream.ShapeSchedule.cap, only grows, log-many
# values) and the bucket rungs (ops/batch.bucket)
_BOUNDING_CALLS = {"cap", "bucket"}
# attribute segments that mark config-derived constants (the Param
# dataclasses): bounded for a run's lifetime
_CONFIG_SEGMENTS = {"param", "uparam"}
# data-dependent attributes: feeding one of these to a static or a
# shape is the canonical new-signature hazard
_DATA_ATTRS = {"size", "nnz", "shape", "ndim"}
_COERCIONS = {"float", "int", "bool"}
_NP_SINKS = {"asarray", "array"}
_ITEM_SINKS = {"item", "tolist", "cpu"}
# tensor factories whose size arguments are a shape
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "rand",
              "randn", "randint", "zeros_like", "ones_like"}
# methods a shape passes through unchanged (x[lo:hi].to(dev))
_SHAPE_KEEPING = {"to", "contiguous", "float", "long", "int", "half",
                  "bfloat16", "clone", "detach", "pin_memory", "cuda"}

_PROV_DEPTH = 8
_DEVTRACE = "utils/devtrace.py"


def _self_shift(func, fi) -> int:
    """1 when callers' positional args are offset by an implicit
    receiver: the function is a METHOD (first parameter self/cls AND
    the callgraph places it in a class). Nested functions inside a
    method keep the class context but take no receiver."""
    if fi is None or fi.cls is None or not isinstance(func, _FUNC_DEFS):
        return 0
    params = func.args.posonlyargs + func.args.args
    return 1 if params and params[0].arg in ("self", "cls") else 0


def _is_fetch_call(cn: str) -> bool:
    """Only the tracer's own ``devtrace.fetch`` is the declared sync —
    other ``.fetch`` methods (the tile caches) move device data and must
    NOT sanction or untaint anything."""
    return cn == "devtrace.fetch" or cn.endswith(".devtrace.fetch")


def _is_put_call(cn: str) -> bool:
    return cn == "devtrace.to_device" or cn.endswith(".devtrace.to_device")


def _is_kernel_name(cn: str) -> bool:
    return cn == "devtrace.kernel" or cn.endswith(".devtrace.kernel")


def _int_tuple(kwval) -> Tuple[int, ...]:
    consts = kwval.elts if isinstance(kwval, (ast.Tuple, ast.List)) \
        else [kwval]
    return tuple(c.value for c in consts
                 if isinstance(c, ast.Constant) and isinstance(c.value, int))


def _point(call: ast.Call, literals: List[str]):
    """The ``point=`` name of a fetch/to_device call: its literal, or,
    when the name is passed in a variable, the point literals its module
    hands on (a list, as tools/devmap.py's inventory has it); '' when
    there is none."""
    for kw in call.keywords:
        if kw.arg != "point":
            continue
        if isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
        return list(literals)
    return ""


def point_literals(tree) -> List[str]:
    """The point names a module hands on: ``point="..."`` keywords of its
    calls to its own functions and the defaults of parameters named
    ``point``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            cn = call_name(node)
            if _is_fetch_call(cn) or _is_put_call(cn):
                continue
            for kw in node.keywords:
                if kw.arg == "point" and isinstance(kw.value, ast.Constant):
                    out.add(kw.value.value)
        elif isinstance(node, _FUNC_DEFS):
            a = node.args
            named = a.posonlyargs + a.args
            pairs = list(zip(named[len(named) - len(a.defaults):],
                             a.defaults)) + list(zip(a.kwonlyargs,
                                                     a.kw_defaults))
            for arg, d in pairs:
                if arg.arg == "point" and isinstance(d, ast.Constant):
                    out.add(d.value)
    out.discard("")
    return sorted(out)


@dataclass
class TracedSite:
    site_id: str                    # "rel:lineno": devtrace's identity
    sf: SourceFile
    node: ast.AST                   # the traced()/kernel() call or decorator
    bound: Optional[str]            # node_key of the bound name, or None
    target_name: str                # wrapped function's name
    target_node: Optional[ast.AST]  # FunctionDef when resolvable
    statics: Tuple[int, ...] = ()
    owner: str = ""                 # qual of the function holding it
    kind: str = "program"           # "program" | "kernel"
    call_sites: List[ast.Call] = field(default_factory=list)
    unbounded: List[Tuple[ast.Call, int, str]] = field(default_factory=list)

    @property
    def bounded(self) -> bool:
        return not self.unbounded


class TorchModel:
    """The whole-program traced-program/transfer model. Built once per
    Project (cached — the four rules, devmap and the gates share it)."""

    def __init__(self, project: Project):
        self.project = project
        self.cg: CallGraph = get_callgraph(project)
        self.sites: Dict[str, TracedSite] = {}
        self.fetch_sites: Dict[str, object] = {}  # "rel:lineno" -> point(s)
        self.put_sites: Dict[str, object] = {}    # "rel:lineno" -> point(s)
        self.hot_funcs: Set[str] = set()
        self.hot_roots: Set[str] = set()
        self._call_to_site: Dict[int, TracedSite] = {}
        self._findings: Dict[str, List[Finding]] = {
            "torch-recompile": [], "torch-host-sync": [],
            "torch-inplace-flow": []}
        self._bounded_memo: Dict[Tuple[str, str], Optional[str]] = {}
        self._attr_inprog: Set[Tuple[str, str]] = set()
        for sf in project.files:
            # the tracer module is the instrument, not a program
            if sf.tree is not None and not sf.rel.endswith(_DEVTRACE):
                self._discover_sites(sf)
        self._index_call_sites()
        self._discover_hot()
        self._check_recompile()
        self._check_host_sync()
        self._check_inplace_flow()

    # -------------------------------------------------------- discovery
    def _discover_sites(self, sf: SourceFile) -> None:
        literals = point_literals(sf.tree)
        for call in sf.call_nodes():
            cn = call_name(call)
            if _is_fetch_call(cn) or _is_put_call(cn):
                reg = self.fetch_sites if _is_fetch_call(cn) \
                    else self.put_sites
                reg[f"{sf.rel}:{call.lineno}"] = _point(call, literals)
                continue
            kernel = _is_kernel_name(cn)
            if not (kernel or is_traced_name(cn)):
                continue
            parent = getattr(call, "parent", None)
            target, tname = None, "<unknown>"
            if isinstance(parent, _FUNC_DEFS) \
                    and call in parent.decorator_list:
                target, tname, bound = parent, parent.name, parent.name
            else:
                if call.args:
                    a0 = call.args[0]
                    if isinstance(a0, ast.Name):
                        tname = a0.id
                        target = self._find_def(sf, call, a0.id)
                    elif isinstance(a0, ast.Attribute):
                        tname = dotted(a0)
                # a kernel entry's calls are inside the programs that
                # call it, as a pallas_call's are in JAX: not indexed
                bound = None if kernel else self._bound_key(call)
            statics: Tuple[int, ...] = ()
            if len(call.args) > 1:
                statics = _int_tuple(call.args[1])
            for kw in call.keywords:
                if kw.arg == "statics":
                    statics = _int_tuple(kw.value)
            owner = self.cg.owner_of.get(id(call), sf.rel + "::<module>")
            site = TracedSite(f"{sf.rel}:{call.lineno}", sf, call, bound,
                              tname, target, statics, owner,
                              "kernel" if kernel else "program")
            self.sites[site.site_id] = site
            self._call_to_site[id(call)] = site
        # bare @devtrace.traced decorators (no Call node)
        for node in sf.walk():
            if not isinstance(node, _FUNC_DEFS):
                continue
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) \
                        or not is_traced_name(dotted(dec)):
                    continue
                owner = self.cg.owner_of.get(id(node),
                                             sf.rel + "::<module>")
                site = TracedSite(f"{sf.rel}:{dec.lineno}", sf, dec,
                                  node.name, node.name, node, owner=owner)
                self.sites[site.site_id] = site

    def _find_def(self, sf: SourceFile, call: ast.Call, name: str):
        """The FunctionDef a traced() wraps, searched lexically: nested
        defs of the enclosing function first, then module level."""
        scope = enclosing_function(call) or sf.tree
        for n in ast.walk(scope):
            if isinstance(n, _FUNC_DEFS) and n.name == name:
                return n
        for n in sf.walk():
            if isinstance(n, _FUNC_DEFS) and n.name == name:
                return n
        return None

    def _bound_key(self, call: ast.Call) -> Optional[str]:
        stmt = statement_of(call)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and stmt.value is call:
            return node_key(stmt.targets[0]) or None
        if isinstance(stmt, ast.AnnAssign) and stmt.value is call:
            return node_key(stmt.target) or None
        return None

    def _index_call_sites(self) -> None:
        """Wrapper call sites, matched per file by the bound key
        (``self._step(...)`` matches the ``._step = traced(...)``
        binding whatever the receiver half — the node_key contract the
        local rules use) or, for decorated defs, by the
        call graph's exact resolution."""
        by_file: Dict[str, List[TracedSite]] = {}
        decorated: Dict[str, TracedSite] = {}
        for site in self.sites.values():
            if isinstance(site.target_node, _FUNC_DEFS) \
                    and site.bound == site.target_name:
                qual = self.cg._def_qual.get(id(site.target_node))
                if qual:
                    decorated[qual] = site
            if site.bound:
                by_file.setdefault(site.sf.rel, []).append(site)
        for sf in self.project.files:
            if sf.tree is None:
                continue
            sites = by_file.get(sf.rel, [])
            keys = {s.bound: s for s in sites}
            for call in sf.call_nodes():
                if id(call) in self._call_to_site:
                    continue
                k = node_key(call.func)
                site = keys.get(k)
                if site is not None:
                    site.call_sites.append(call)
        self._index_returned_wrappers()
        for qual, site in decorated.items():
            for caller, csites in self.cg.calls.items():
                for cs in csites:
                    if cs.kind == "call" and not cs.fuzzy \
                            and qual in cs.targets \
                            and id(cs.node) not in self._call_to_site:
                        if cs.node not in site.call_sites:
                            site.call_sites.append(cs.node)

    def _index_returned_wrappers(self) -> None:
        """A builder that returns its wrapper (``step = traced(f); return
        ..., step, ...``): the name each exact caller unpacks it into is
        the wrapper there, one level deep."""
        for site in list(self.sites.values()):
            if site.kind != "program" or not site.bound \
                    or site.bound.startswith("."):
                continue
            fi = self.cg.funcs.get(site.owner)
            if fi is None or fi.node is None:
                continue
            positions: Set[Optional[int]] = set()
            for n in ast.walk(fi.node):
                if not isinstance(n, ast.Return) or n.value is None:
                    continue
                if isinstance(n.value, ast.Name) \
                        and n.value.id == site.bound:
                    positions.add(None)
                elif isinstance(n.value, ast.Tuple):
                    for k, e in enumerate(n.value.elts):
                        if isinstance(e, ast.Name) and e.id == site.bound:
                            positions.add(k)
            if not positions:
                continue
            for caller, csites in self.cg.calls.items():
                cfi = self.cg.funcs.get(caller)
                if cfi is None or cfi.node is None:
                    continue
                for cs in csites:
                    if cs.kind != "call" or cs.fuzzy \
                            or site.owner not in cs.targets:
                        continue
                    stmt = statement_of(cs.node)
                    if not isinstance(stmt, ast.Assign) \
                            or stmt.value is not cs.node:
                        continue
                    names = set()
                    for t in stmt.targets:
                        if isinstance(t, ast.Name) and None in positions:
                            names.add(t.id)
                        elif isinstance(t, ast.Tuple):
                            for k in positions - {None}:
                                if k < len(t.elts) and isinstance(
                                        t.elts[k], ast.Name):
                                    names.add(t.elts[k].id)
                    for n in ast.walk(cfi.node):
                        if isinstance(n, ast.Call) \
                                and isinstance(n.func, ast.Name) \
                                and n.func.id in names \
                                and n not in site.call_sites:
                            site.call_sites.append(n)

    # ---------------------------------------------------------- hot set
    def _discover_hot(self) -> None:
        """Hot roots: every function that dispatches a traced program from
        inside a loop (a step/replay loop), plus every ``_loop`` (the
        serve dispatch threads). The hot set is their closure over
        exact call edges — where an implicit sync stalls the pipeline
        every iteration, not once."""
        wrapper_calls: Dict[str, List[ast.Call]] = {}
        for site in self.sites.values():
            for c in site.call_sites:
                owner = self.cg.owner_of.get(id(c))
                if owner:
                    wrapper_calls.setdefault(owner, []).append(c)
        # functions that (transitively, over exact edges) invoke a traced
        # wrapper: a loop that calls one of these dispatches device work
        # every iteration even when the program call itself lives in a
        # helper (_dispatch_packed and friends)
        invokes: Set[str] = set(wrapper_calls)
        changed = True
        while changed:
            changed = False
            for qual, csites in self.cg.calls.items():
                if qual in invokes:
                    continue
                for cs in csites:
                    if cs.kind == "call" and not cs.fuzzy \
                            and any(t in invokes for t in cs.targets):
                        invokes.add(qual)
                        changed = True
                        break
        wrapper_ids = {id(c) for calls in wrapper_calls.values()
                       for c in calls}
        for qual, csites in self.cg.calls.items():
            for cs in csites:
                dispatches = id(cs.node) in wrapper_ids \
                    or (cs.kind == "call" and not cs.fuzzy
                        and any(t in invokes for t in cs.targets))
                if not dispatches:
                    continue
                cur = getattr(cs.node, "parent", None)
                while cur is not None and not isinstance(cur, _FUNC_DEFS):
                    if isinstance(cur, _LOOPS):
                        self.hot_roots.add(qual)
                        break
                    cur = getattr(cur, "parent", None)
        for qual, fi in self.cg.funcs.items():
            if fi.name == "_loop":
                self.hot_roots.add(qual)
        seen = set(self.hot_roots)
        frontier = list(seen)
        while frontier:
            q = frontier.pop()
            for cs in self.cg.calls.get(q, []):
                if cs.kind != "call" or cs.fuzzy:
                    continue
                for t in cs.targets:
                    if t not in seen and t in self.cg.funcs:
                        seen.add(t)
                        frontier.append(t)
        self.hot_funcs = seen
    # ----------------------------------------------- bounded provenance
    def _bounded(self, sf: SourceFile, func, expr,
                 depth: int = 0) -> Optional[str]:
        """None when ``expr`` is provably drawn from a bounded set;
        otherwise a human-readable reason naming the unbounded source."""
        if depth > _PROV_DEPTH:
            return "provenance chain too deep"
        if isinstance(expr, ast.Constant):
            return None
        if isinstance(expr, (ast.Tuple, ast.List)):
            for e in expr.elts:
                r = self._bounded(sf, func, e, depth + 1)
                if r:
                    return r
            return None
        if isinstance(expr, ast.UnaryOp):
            return self._bounded(sf, func, expr.operand, depth + 1)
        if isinstance(expr, ast.BinOp):
            return self._bounded(sf, func, expr.left, depth + 1) \
                or self._bounded(sf, func, expr.right, depth + 1)
        if isinstance(expr, (ast.BoolOp,)):
            for e in expr.values:
                r = self._bounded(sf, func, e, depth + 1)
                if r:
                    return r
            return None
        if isinstance(expr, ast.Compare):
            return None                     # a bool: two values
        if isinstance(expr, ast.IfExp):
            return self._bounded(sf, func, expr.body, depth + 1) \
                or self._bounded(sf, func, expr.orelse, depth + 1)
        if isinstance(expr, ast.Call):
            cn = call_name(expr)
            tail = cn.rsplit(".", 1)[-1]
            if tail in _BOUNDING_CALLS:
                return None                 # cap()/bucket(): quantized
            if tail == "len":
                return "len(...) is data-dependent"
            if tail in ("int", "min", "max", "abs", "round"):
                for e in expr.args:
                    r = self._bounded(sf, func, e, depth + 1)
                    if r:
                        return r
                return None
            if tail == "bool":
                return None
            return f"value of {cn or '<dynamic>'}(...) not provably bounded"
        if isinstance(expr, ast.Attribute):
            chain = dotted(expr)
            parts = chain.split(".") if chain else []
            if any(p in _CONFIG_SEGMENTS for p in parts[:-1]):
                return None                 # config-derived constant
            if expr.attr in _DATA_ATTRS:
                return f"`.{expr.attr}` is data-dependent — route it " \
                       f"through a ShapeSchedule cap or bucket rung"
            return self._attr_bounded(sf, expr.attr, depth)
        if isinstance(expr, ast.Name):
            return self._name_bounded(sf, func, expr.id, depth)
        if isinstance(expr, ast.Subscript):
            return "subscripted value (payload/tuple element) not " \
                   "provably bounded"
        if isinstance(expr, ast.Starred):
            return self._bounded(sf, func, expr.value, depth + 1)
        return f"{type(expr).__name__} expression not provably bounded"

    def _attr_bounded(self, sf: SourceFile, attr: str,
                      depth: int) -> Optional[str]:
        """``<obj>.attr`` is bounded when every assignment to ``.attr``
        in the same file has a bounded RHS (and at least one exists —
        an attribute this file never sets is somebody else's data)."""
        memo_key = (sf.rel, "." + attr)
        if memo_key in self._bounded_memo:
            return self._bounded_memo[memo_key]
        if memo_key in self._attr_inprog:
            return None                     # optimistic on cycles
        self._attr_inprog.add(memo_key)
        try:
            stores = []
            for node in sf.walk():
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and node_key(node.targets[0]) == "." + attr:
                    stores.append(node)
                elif isinstance(node, ast.AnnAssign) \
                        and node_key(node.target) == "." + attr \
                        and node.value is not None:
                    stores.append(node)
            if not stores:
                res: Optional[str] = \
                    f"`.{attr}` is never assigned in {sf.rel} — " \
                    f"not provably bounded"
            else:
                res = None
                for st in stores:
                    f = enclosing_function(st)
                    res = self._bounded(sf, f, st.value, depth + 1)
                    if res:
                        res = f"`.{attr}` assigned from an unbounded " \
                              f"value at {sf.rel}:{st.lineno} ({res})"
                        break
            self._bounded_memo[memo_key] = res
            return res
        finally:
            self._attr_inprog.discard(memo_key)

    def _name_bounded(self, sf: SourceFile, func, name: str,
                      depth: int) -> Optional[str]:
        # local / enclosing assignments first; a tuple-unpack target
        # remembers its POSITION so `(a, b) = payload` can check just
        # the matching element of the caller's literal payload tuple
        scope = func if func is not None else sf.tree
        # self-referential rebinding (`u_cap = max(u_cap, bucket(n))`)
        # recurses through itself: optimistic on cycles — the base
        # binding and every step still get checked on their own
        cyc_key = (f"name@{id(scope)}", name)
        if cyc_key in self._attr_inprog:
            return None
        self._attr_inprog.add(cyc_key)
        try:
            return self._name_bounded_inner(sf, func, scope, name, depth)
        finally:
            self._attr_inprog.discard(cyc_key)

    def _name_bounded_inner(self, sf: SourceFile, func, scope, name: str,
                            depth: int) -> Optional[str]:
        assigns: List[Tuple[ast.AST, Optional[int]]] = []
        for node in ast.walk(scope):
            if isinstance(node, _FUNC_DEFS) and node is not scope:
                continue
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        assigns.append((node.value, None))
                    elif isinstance(t, ast.Tuple):
                        for pos, e in enumerate(t.elts):
                            if isinstance(e, ast.Name) and e.id == name:
                                assigns.append((node.value, pos))
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id == name:
                return f"`{name}` is an accumulating local " \
                       f"(augmented assignment)"
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                for e in ast.walk(node.target):
                    if isinstance(e, ast.Name) and e.id == name:
                        return f"`{name}` iterates a runtime sequence"
        if assigns:
            for v, pos in assigns:
                r = self._elem_bounded(sf, func, v, pos, depth)
                if r:
                    return r
            return None
        # a parameter: bounded iff every exact caller passes bounded
        if isinstance(func, _FUNC_DEFS):
            params = [a.arg for a in (func.args.posonlyargs
                                      + func.args.args)]
            if name in params:
                return self._param_bounded(sf, func, params.index(name),
                                           name, depth)
            # closure variable: resolve in the lexically enclosing def
            outer = enclosing_function(func)
            if outer is not None:
                return self._name_bounded(sf, outer, name, depth + 1)
        # module-level constant
        mod_assigns = [
            node.value for node in sf.tree.body
            if isinstance(node, ast.Assign)
            for t in node.targets
            if isinstance(t, ast.Name) and t.id == name
        ]
        if mod_assigns:
            for v in mod_assigns:
                r = self._bounded(sf, func, v, depth + 1)
                if r:
                    return r
            return None
        return f"`{name}` has no visible bounded binding"

    def _elem_bounded(self, sf: SourceFile, func, value, pos: Optional[int],
                      depth: int) -> Optional[str]:
        """Boundedness of one unpacked element: select ``elts[pos]``
        when the value is a literal tuple, and thread the position
        through a parameter so ``(a, b) = payload`` checks element
        ``pos`` of each caller's literal payload tuple."""
        if pos is not None and isinstance(value, (ast.Tuple, ast.List)) \
                and pos < len(value.elts):
            return self._bounded(sf, func, value.elts[pos], depth + 1)
        if pos is not None and isinstance(value, ast.Name) \
                and isinstance(func, _FUNC_DEFS):
            params = [a.arg for a in (func.args.posonlyargs
                                      + func.args.args)]
            local_tuples = [
                node.value for node in ast.walk(func)
                if isinstance(node, ast.Assign)
                for t in node.targets
                if isinstance(t, ast.Name) and t.id == value.id
            ]
            if local_tuples:
                for v in local_tuples:
                    r = self._elem_bounded(sf, func, v, pos, depth + 1)
                    if r:
                        return r
                return None
            if value.id in params:
                return self._param_bounded(sf, func,
                                           params.index(value.id),
                                           value.id, depth, elem=pos)
        return self._bounded(sf, func, value, depth + 1)

    def _param_bounded(self, sf: SourceFile, func, idx: int, name: str,
                       depth: int,
                       elem: Optional[int] = None) -> Optional[str]:
        qual = self.cg._def_qual.get(id(func))
        if qual is None:
            return f"parameter `{name}` of an unindexed function"
        memo_key = (qual, name if elem is None else f"{name}[{elem}]")
        if memo_key in self._bounded_memo:
            return self._bounded_memo[memo_key]
        if memo_key in self._attr_inprog:
            return None
        self._attr_inprog.add(memo_key)
        try:
            fi = self.cg.funcs.get(qual)
            # methods: caller positional j maps to param j+1 — keyed on
            # the first parameter being self/cls (a nested function
            # keeps its class CONTEXT in the callgraph but receives no
            # implicit receiver)
            shift = _self_shift(func, fi)
            callers = []
            for caller_q, csites in self.cg.calls.items():
                for cs in csites:
                    if cs.kind == "call" and not cs.fuzzy \
                            and qual in cs.targets:
                        callers.append((caller_q, cs.node))
            if not callers:
                res: Optional[str] = \
                    f"parameter `{name}` has no resolvable callers"
            else:
                res = None
                for caller_q, cnode in callers:
                    pos = idx - shift
                    arg_expr = None
                    if 0 <= pos < len(cnode.args):
                        arg_expr = cnode.args[pos]
                    else:
                        for kw in cnode.keywords:
                            if kw.arg == name:
                                arg_expr = kw.value
                    if arg_expr is None:
                        continue            # defaulted: checked below
                    c_fi = self.cg.funcs.get(caller_q)
                    c_sf = c_fi.sf if c_fi is not None else sf
                    c_func = c_fi.node if c_fi is not None else None
                    if elem is None:
                        r = self._bounded(c_sf, c_func, arg_expr,
                                          depth + 1)
                    else:
                        r = self._elem_bounded(c_sf, c_func, arg_expr,
                                               elem, depth + 1)
                    if r:
                        res = f"caller {caller_q.split('::')[-1]} at " \
                              f"{c_sf.rel}:{cnode.lineno} passes " \
                              f"`{name}` from an unbounded value ({r})"
                        break
            self._bounded_memo[memo_key] = res
            return res
        finally:
            self._attr_inprog.discard(memo_key)
    # ------------------------------------------------- rule: recompile
    def _shape_bounds(self, arg) -> List[ast.AST]:
        """The expressions that set an argument's shape at the call: the
        bounds of a slice (``x[lo:hi]``, through shape-keeping methods
        such as ``.to(dev)``) and the sizes of a tensor factory."""
        cur = arg
        while isinstance(cur, ast.Call) \
                and isinstance(cur.func, ast.Attribute) \
                and cur.func.attr in _SHAPE_KEEPING:
            cur = cur.func.value
        out: List[ast.AST] = []
        if isinstance(cur, ast.Subscript):
            sl = cur.slice
            for part in (sl.elts if isinstance(sl, ast.Tuple) else [sl]):
                if isinstance(part, ast.Slice):
                    out += [e for e in (part.lower, part.upper, part.step)
                            if e is not None]
        elif isinstance(cur, ast.Call) and call_name(cur).startswith(
                "torch.") and call_name(cur).rsplit(".", 1)[-1] \
                in _FACTORIES:
            out += list(cur.args)
        return out

    def _check_recompile(self) -> None:
        out = self._findings["torch-recompile"]
        for sid in sorted(self.sites):
            site = self.sites[sid]
            if site.kind != "program":
                # a kernel entry is wrapped once at import; its shapes are
                # the calling program's
                continue
            call = site.node
            parent = getattr(call, "parent", None)
            if isinstance(call, ast.Call) and isinstance(parent, ast.Call) \
                    and parent.func is call:
                out.append(site.sf.finding(
                    "torch-recompile", call,
                    f"traced program `{site.target_name}` is wrapped and "
                    f"called in one expression — every execution "
                    f"registers the site anew; wrap it once and reuse "
                    f"the wrapper"))
            cur = parent
            while cur is not None and not isinstance(cur, _FUNC_DEFS):
                if isinstance(cur, _LOOPS):
                    out.append(site.sf.finding(
                        "torch-recompile", call,
                        f"traced program `{site.target_name}` is wrapped "
                        f"inside a loop — one wrapper (and one capture) "
                        f"per iteration; hoist the traced() out"))
                    break
                cur = getattr(cur, "parent", None)
            for cs in site.call_sites:
                func = enclosing_function(cs)
                csf = self._sf_of(cs, site)
                shift = 0
                if isinstance(site.target_node, _FUNC_DEFS) \
                        and site.bound == site.target_name:
                    shift = _self_shift(site.target_node, self.cg.funcs.get(
                        self.cg._def_qual.get(id(site.target_node), "")))
                loose: List[Tuple[str, str]] = []
                for i, arg in enumerate(cs.args):
                    pos = i + shift
                    if pos in site.statics:
                        if isinstance(arg, (ast.List, ast.Dict, ast.Set)):
                            reason = "non-hashable static"
                        else:
                            reason = self._bounded(csf, func, arg)
                        if reason:
                            site.unbounded.append((cs, pos, reason))
                            loose.append((f"static {pos}", reason))
                        continue
                    for e in self._shape_bounds(arg):
                        reason = self._bounded(csf, func, e)
                        if reason:
                            site.unbounded.append((cs, pos, reason))
                            loose.append((f"shape of argument {pos}",
                                          reason))
                            break
                if loose:
                    # one finding per CALL SITE: one reasoned pragma on
                    # the dispatch line covers every loose input there
                    what = ", ".join(w for w, _ in loose)
                    out.append(csf.finding(
                        "torch-recompile", cs,
                        f"{what} of traced `{site.target_name}` ({sid}) "
                        f"not provably drawn from a bounded set: "
                        f"{loose[0][1]} — every distinct value is a new "
                        f"call signature (a new CUDA graph); route it "
                        f"through a ShapeSchedule cap / bucket rung, or "
                        f"suppress with the boundedness argument"))

    def _sf_of(self, node, site: TracedSite) -> SourceFile:
        # call sites matched by bound key live in the site's own file;
        # decorated-def call sites can live anywhere in the project
        owner = self.cg.owner_of.get(id(node))
        if owner:
            fi = self.cg.funcs.get(owner)
            if fi is not None:
                return fi.sf
        return site.sf

    # ------------------------------------------------ rule: host sync
    def _check_host_sync(self) -> None:
        out = self._findings["torch-host-sync"]
        wrapper_by_call = self._call_to_wrapper_index()
        # which hot functions RETURN device values (callers taint their
        # results), and which parameters are fed device values — one
        # fixpoint over the hot set
        device_returns: Set[str] = set()
        param_taint: Dict[str, Set[str]] = {}
        changed = True
        rounds = 0
        while changed and rounds < 6:
            changed = False
            rounds += 1
            for qual in sorted(self.hot_funcs):
                fi = self.cg.funcs.get(qual)
                if fi is None or fi.node is None:
                    continue
                tainted = self._taint_names(
                    fi, wrapper_by_call, device_returns,
                    param_taint.get(qual, set()))
                flow = self._flow(fi, tainted, wrapper_by_call,
                                  device_returns)
                for n in ast.walk(fi.node):
                    if isinstance(n, ast.Return) and n.value is not None \
                            and self._expr_tainted(
                                n.value, tainted, wrapper_by_call,
                                device_returns, fi, flow):
                        if qual not in device_returns:
                            device_returns.add(qual)
                            changed = True
                        break
                for cs in self.cg.calls.get(qual, []):
                    if cs.kind != "call" or cs.fuzzy:
                        continue
                    for t in cs.targets:
                        if t not in self.hot_funcs:
                            continue
                        ti = self.cg.funcs.get(t)
                        if ti is None or ti.node is None:
                            continue
                        params = [a.arg for a in
                                  (ti.node.args.posonlyargs
                                   + ti.node.args.args)]
                        shift = _self_shift(ti.node, ti)
                        for j, a in enumerate(cs.node.args):
                            pj = j + shift
                            if pj < len(params) and self._expr_tainted(
                                    a, tainted, wrapper_by_call,
                                    device_returns, fi, flow):
                                cur = param_taint.setdefault(t, set())
                                if params[pj] not in cur:
                                    cur.add(params[pj])
                                    changed = True
        self.device_returns = device_returns
        for qual in sorted(self.hot_funcs):
            fi = self.cg.funcs.get(qual)
            if fi is None or fi.node is None \
                    or fi.sf.rel.endswith(_DEVTRACE):
                continue
            tainted = self._taint_names(
                fi, wrapper_by_call, device_returns,
                param_taint.get(qual, set()))
            flow = self._flow(fi, tainted, wrapper_by_call, device_returns)
            for call in ast.walk(fi.node):
                if not isinstance(call, ast.Call):
                    continue
                sink = self._sink(call)
                if sink is None or not self._expr_tainted(
                        sink, tainted, wrapper_by_call, device_returns, fi,
                        flow):
                    continue
                if self._inside_fetch(call):
                    continue
                cn = call_name(call)
                what = dotted(sink) or type(sink).__name__
                out.append(fi.sf.finding(
                    "torch-host-sync", call,
                    f"device value `{what}` is copied to the host by "
                    f"`{cn or call.func.attr}` inside the hot "
                    f"step/dispatch path ({qual.split('::', 1)[1]}) — "
                    f"an implicit blocking device->host sync every "
                    f"iteration; batch the copy, or declare it with "
                    f"devtrace's fetch(x, point=...) so the runtime "
                    f"tracer counts it"))

    @staticmethod
    def _sink(call: ast.Call):
        """The expression ``call`` copies to the host, or None."""
        cn = call_name(call)
        tail = cn.rsplit(".", 1)[-1]
        if cn in _COERCIONS and call.args:
            return call.args[0]
        if tail in _NP_SINKS and call.args \
                and cn.partition(".")[0] in ("np", "numpy"):
            return call.args[0]
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _ITEM_SINKS:
            return call.func.value
        return None

    def _call_to_wrapper_index(self) -> Dict[int, TracedSite]:
        idx: Dict[int, TracedSite] = {}
        for site in self.sites.values():
            for c in site.call_sites:
                idx[id(c)] = site
        return idx

    def _taint_names(self, fi, wrapper_by_call, device_returns,
                     pre_tainted: Set[str]) -> Set[str]:
        """Names in ``fi`` holding device values: results of traced
        wrapper calls / device-returning hot helpers, via (tuple)
        assignment, plus device-tainted parameters."""
        tainted = set(pre_tainted)
        for _ in range(3):                   # tiny local fixpoint
            grew = False
            for node in ast.walk(fi.node):
                if not isinstance(node, ast.Assign):
                    continue
                if not self._expr_tainted(node.value, tainted,
                                          wrapper_by_call,
                                          device_returns, fi):
                    continue
                for t in node.targets:
                    for e in ast.walk(t):
                        if isinstance(e, ast.Name) \
                                and e.id not in tainted:
                            tainted.add(e.id)
                            grew = True
            if not grew:
                break
        return tainted

    def _flow(self, fi, tainted: Set[str], wrapper_by_call,
              device_returns) -> Dict[str, List[Tuple[int, bool]]]:
        """Each name's bindings in ``fi`` in line order, with whether the
        bound value is a device value."""
        out: Dict[str, List[Tuple[int, bool]]] = {}
        assigns = sorted((n for n in ast.walk(fi.node)
                          if isinstance(n, ast.Assign)),
                         key=lambda n: (n.lineno, n.col_offset))
        for node in assigns:
            dev = self._expr_tainted(node.value, tainted, wrapper_by_call,
                                     device_returns, fi, out)
            for t in node.targets:
                for e in ast.walk(t):
                    if isinstance(e, ast.Name):
                        out.setdefault(e.id, []).append((node.lineno, dev))
        return out

    def _expr_tainted(self, expr, tainted: Set[str], wrapper_by_call,
                      device_returns, fi, flow=None) -> bool:
        """Does ``expr`` hold a device value? With ``flow`` (from
        :meth:`_flow`), a name is judged by its last binding above the
        use, so ``x = fetch(x, ...)`` (devtrace's) leaves ``x`` on the
        host."""
        if isinstance(expr, ast.Name):
            if flow is not None:
                above = [t for ln, t in flow.get(expr.id, ())
                         if ln < expr.lineno]
                if above:
                    return above[-1]
            return expr.id in tainted
        if isinstance(expr, ast.Call):
            if id(expr) in wrapper_by_call:
                return True
            cn = call_name(expr)
            tail = cn.rsplit(".", 1)[-1]
            if _is_fetch_call(cn):
                return False                 # declared sync: host after
            if tail in _NP_SINKS | _COERCIONS | _ITEM_SINKS | {"numpy"}:
                return False                 # already host
            # calls into device-returning hot helpers
            owner = self.cg.owner_of.get(id(expr))
            if owner is not None:
                cs = self.cg.by_node.get(id(expr))
                if cs is not None and cs.kind == "call" and not cs.fuzzy:
                    if any(t in device_returns for t in cs.targets):
                        return True
            return False
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self._expr_tainted(e, tainted, wrapper_by_call,
                                          device_returns, fi, flow)
                       for e in expr.elts)
        if isinstance(expr, (ast.Subscript, ast.Starred)):
            return self._expr_tainted(expr.value, tainted, wrapper_by_call,
                                      device_returns, fi, flow)
        if isinstance(expr, ast.BinOp):
            return any(self._expr_tainted(e, tainted, wrapper_by_call,
                                          device_returns, fi, flow)
                       for e in (expr.left, expr.right))
        return False

    @staticmethod
    def _inside_fetch(node) -> bool:
        cur = getattr(node, "parent", None)
        while cur is not None and not isinstance(cur, ast.stmt):
            if isinstance(cur, ast.Call) and _is_fetch_call(call_name(cur)):
                return True
            cur = getattr(cur, "parent", None)
        return False

    # ---------------------------------------------- rule: in-place flow
    def _inplace_params(self) -> Dict[str, Set[int]]:
        """qual -> positions (as callers count them) of the parameters a
        function updates in place: an ``op_`` method or an in-place
        kernel entry on the parameter, or the parameter passed on to
        another such position (one fixpoint over exact edges)."""
        out: Dict[str, Set[int]] = {}

        def params_of(fi):
            return [a.arg for a in (fi.node.args.posonlyargs
                                    + fi.node.args.args)]

        for qual, fi in self.cg.funcs.items():
            if fi.node is None:
                continue
            params = params_of(fi)
            shift = _self_shift(fi.node, fi)
            for n in ast.walk(fi.node):
                if isinstance(n, ast.Call):
                    tgt = inplace_target(n)
                    if isinstance(tgt, ast.Name) and tgt.id in params \
                            and params.index(tgt.id) >= shift:
                        out.setdefault(qual, set()).add(
                            params.index(tgt.id) - shift)
        changed = True
        while changed:
            changed = False
            for qual, fi in self.cg.funcs.items():
                if fi.node is None:
                    continue
                params = params_of(fi)
                shift = _self_shift(fi.node, fi)
                for cs in self.cg.calls.get(qual, []):
                    if cs.kind != "call" or cs.fuzzy:
                        continue
                    for t in cs.targets:
                        for pos in out.get(t, ()):
                            if pos >= len(cs.node.args):
                                continue
                            a = cs.node.args[pos]
                            if isinstance(a, ast.Name) and a.id in params \
                                    and params.index(a.id) >= shift:
                                p = params.index(a.id) - shift
                                if p not in out.setdefault(qual, set()):
                                    out[qual].add(p)
                                    changed = True
        return out

    def _check_inplace_flow(self) -> None:
        found = self._findings["torch-inplace-flow"]
        self.inplace = self._inplace_params()
        for caller, csites in self.cg.calls.items():
            fi = self.cg.funcs.get(caller)
            if fi is None or fi.node is None:
                continue
            updates = []
            for cs in csites:
                if cs.kind != "call" or cs.fuzzy:
                    continue
                for t in cs.targets:
                    for pos in sorted(self.inplace.get(t, ())):
                        if pos < len(cs.node.args) and isinstance(
                                cs.node.args[pos], ast.Name):
                            updates.append((
                                statement_of(cs.node),
                                cs.node.args[pos].id,
                                t.split("::", 1)[1]))
            for read, alias, base, what in stale_alias_reads(fi.node,
                                                             updates):
                if enclosing_function(read) is not fi.node:
                    continue
                found.append(fi.sf.finding(
                    "torch-inplace-flow", read,
                    f"`{alias}` is a view of `{base}` bound before "
                    f"`{base}` was passed to {what}, which updates it in "
                    f"place — read here it holds the new values; clone() "
                    f"it before the call if the old values are meant"))

    # ------------------------------------------------------------ views
    def known_warm(self) -> Set[str]:
        """Program sites whose every static and shape at every call site
        is bounded — or whose unbounded call sites all carry a reasoned
        torch-recompile suppression: the sites whose signatures may grow
        only with the bounded sets."""
        out = set()
        by_rel = {sf.rel: sf for sf in self.project.files}
        for sid, site in self.sites.items():
            ok = True
            for cs, _i, _r in site.unbounded:
                sf = self._sf_of(cs, site)
                sf = by_rel.get(sf.rel, sf)
                if "torch-recompile" not in sf.suppressions.get(
                        cs.lineno, set()):
                    ok = False
                    break
            if ok:
                out.add(sid)
        return out

    def points(self, puts: bool = False) -> Set[str]:
        """The point names of the declared fetches (of the declared
        host-to-device copies with ``puts``)."""
        out: Set[str] = set()
        for p in (self.put_sites if puts else self.fetch_sites).values():
            out.update([p] if isinstance(p, str) else p)
        out.discard("")
        return out

    def hot_line(self, site: str) -> Optional[str]:
        """The hot-set function holding ``rel:lineno``, or None."""
        rel, _, line = site.rpartition(":")
        try:
            ln = int(line)
        except ValueError:
            return None
        for qual in self.hot_funcs:
            fi = self.cg.funcs.get(qual)
            if fi is None or fi.node is None or fi.sf.rel != rel:
                continue
            if fi.node.lineno <= ln <= fi.node.end_lineno:
                inner = [q for q in self.cg.funcs
                         if q.startswith(qual + ".")]
                if not any(self._contains(q, rel, ln) for q in inner):
                    return qual
        return None

    def _contains(self, qual: str, rel: str, ln: int) -> bool:
        fi = self.cg.funcs.get(qual)
        return fi is not None and fi.node is not None \
            and fi.sf.rel == rel \
            and fi.node.lineno <= ln <= fi.node.end_lineno

    def sync_verdict(self, site: str) -> str:
        """How the model judges an undeclared sync observed at
        ``rel:lineno``: "cold" (outside the hot set), "flagged" (a
        torch-host-sync finding there), "suppressed" (a torch-host-sync
        pragma covers the line) or "unknown" (hot, and the model has
        nothing there: devmap --check fails)."""
        if self.hot_line(site) is None:
            return "cold"
        rel, _, line = site.rpartition(":")
        ln = int(line)
        for f in self._findings["torch-host-sync"]:
            if f.path == rel and f.line == ln:
                sf = next((s for s in self.project.files if s.rel == rel),
                          None)
                if sf is not None and sf.is_suppressed(f):
                    return "suppressed"
                return "flagged"
        sf = next((s for s in self.project.files if s.rel == rel), None)
        if sf is not None and "torch-host-sync" in sf.suppressions.get(
                ln, set()):
            return "suppressed"
        return "unknown"

    def to_json(self) -> dict:
        warm = self.known_warm()
        return {
            "sites": {
                sid: {
                    "target": site.target_name,
                    "bound": site.bound,
                    "kind": site.kind,
                    "statics": list(site.statics),
                    "call_sites": sorted(
                        {f"{self._sf_of(c, site).rel}:{c.lineno}"
                         for c in site.call_sites}),
                    "warm_bounded": sid in warm,
                    "unbounded": [
                        {"call": f"{self._sf_of(c, site).rel}:{c.lineno}",
                         "arg": i, "reason": r}
                        for c, i, r in site.unbounded],
                }
                for sid, site in sorted(self.sites.items())
            },
            "fetch_sites": dict(sorted(self.fetch_sites.items())),
            "put_sites": dict(sorted(self.put_sites.items())),
            "hot_roots": sorted(self.hot_roots),
            "hot_funcs": len(self.hot_funcs),
        }


def get_torch_model(project: Project) -> TorchModel:
    m = getattr(project, "_torch_model", None)
    if m is None or m.project is not project:
        m = TorchModel(project)
        project._torch_model = m  # type: ignore[attr-defined]
    return m


# ---------------------------------------------------------------------------
# rule registrations


@rule("torch-recompile",
      "traced-program statics and shapes must come from a bounded set "
      "(the call-signature model)", cross=True)
def check_torch_recompile(project: Project) -> List[Finding]:
    return list(get_torch_model(project)._findings["torch-recompile"])


@rule("torch-host-sync",
      "no implicit device->host copies on the hot dispatch path",
      cross=True)
def check_torch_host_sync(project: Project) -> List[Finding]:
    return list(get_torch_model(project)._findings["torch-host-sync"])


@rule("torch-inplace-flow",
      "callers must not read a view of a tensor they passed to an "
      "in-place update as the old value", cross=True)
def check_torch_inplace_flow(project: Project) -> List[Finding]:
    return list(get_torch_model(project)._findings["torch-inplace-flow"])


# --------------------------------------------------------------- local rule


def _mentions_float64(node) -> bool:
    if isinstance(node, ast.Attribute) and node.attr in ("float64",
                                                         "double"):
        return True
    if isinstance(node, ast.Constant) and node.value == "float64":
        return True
    return False


def _host_device(kw_value) -> bool:
    """A ``device=`` value that names the host."""
    if isinstance(kw_value, ast.Constant):
        return kw_value.value == "cpu"
    if isinstance(kw_value, ast.Call) and call_name(kw_value) in (
            "torch.device",) and kw_value.args:
        a = kw_value.args[0]
        return isinstance(a, ast.Constant) and a.value == "cpu"
    return False


@rule("torch-dtype64",
      "no float64 device tensors or float64 inside traced programs; no "
      "int32 accumulators on overflow paths")
def check_torch_dtype64(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    # float64 inside a traced program: one float64 intermediate promotes
    # the fp32 computation (and runs at a 64th of the rate on the card)
    for fn in traced_functions(sf):
        for n in ast.walk(ast.Module(body=fn.body, type_ignores=[])):
            if _mentions_float64(n):
                out.append(sf.finding(
                    "torch-dtype64", n,
                    f"float64 inside traced `{fn.name}` promotes the "
                    f"fp32 pipeline (float64 runs at a fraction of the "
                    f"card's fp32 rate) — keep device math in float32, "
                    f"or reduce in float64 on the host"))
                break
    # a float64 tensor made on a device
    for call in sf.call_nodes():
        cn = call_name(call)
        if not cn.startswith("torch."):
            continue
        kws = {kw.arg: kw.value for kw in call.keywords}
        if "dtype" in kws and _mentions_float64(kws["dtype"]) \
                and "device" in kws and not _host_device(kws["device"]):
            out.append(sf.finding(
                "torch-dtype64", call,
                f"`{cn}(dtype=float64, device=...)` makes a float64 "
                f"device tensor — the fp32 pipeline promotes on first "
                f"contact; use float32 (host-side float64 is fine)"))
    # int32 accumulators in loops: row counters overflow past 2^31
    for fn in [n for n in sf.walk() if isinstance(n, _FUNC_DEFS)]:
        names: Set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not isinstance(t, ast.Name):
                continue
            v = node.value
            is32 = False
            if isinstance(v, ast.Call):
                if call_name(v).rsplit(".", 1)[-1] == "int32":
                    is32 = True
                for kw in v.keywords:
                    if kw.arg == "dtype" and (
                            (isinstance(kw.value, ast.Attribute)
                             and kw.value.attr == "int32")
                            or (isinstance(kw.value, ast.Constant)
                                and kw.value.value == "int32")):
                        is32 = True
            if is32:
                names.add(t.id)
        if not names:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id in names:
                cur = getattr(node, "parent", None)
                while cur is not None and cur is not fn:
                    if isinstance(cur, _LOOPS):
                        out.append(sf.finding(
                            "torch-dtype64", node,
                            f"`{node.target.id}` is an int32-created "
                            f"accumulator incremented in a loop — row "
                            f"counters overflow past 2^31 on "
                            f"production-size streams; count in int64"))
                        break
                    cur = getattr(cur, "parent", None)
    return out
