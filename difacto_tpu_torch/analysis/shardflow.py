"""Sharding-flow analysis of the port: the counterpart of
difacto_tpu/analysis/shardflow.py for the torch layout.

Under an fs-sharded mesh the port's slot table stays ONE tensor on its
device, and each fs key range is a VIEW of its rows
(``parallel/mesh.state_sharding``); parallel/sharded.py launches the flat
path's kernels once per shard run over those views. Breaking a layout
therefore means something else than in JAX, where GSPMD may re-partition
a program's output: here a shard view is only good while the table it
views stays the tensor it was cut from. A whole-table op that replaces
or re-lays the table (``torch.cat``/``stack``/``sort`` over its shards or
rows, ``reshape``/``view``/``contiguous``/``clone``/``t`` of it) leaves
the views on the old storage, and a push through them is lost, or moves
the whole table through memory once per step. The multi-host planes
move per-step partials and rows (``DataPlane``, ``allgather_np``),
never the table, and the three CUDA entries run only behind
ops/fused.py's device dispatch, which hands the plain versions every
CPU tensor.

Three rules, all cross-file:

- ``torch-shard-replicate`` — a table-sized tensor (the ``table`` name,
  a ``state.<field>`` chain such as ``store.state.VVg``, or a local bound
  from one) reaches a ``torch.distributed`` collective or the data plane
  (``allgather_np``, ``allreduce_np``, ``DataPlane.gather``,
  parallel/multihost.py): the table moved whole across processes, the
  memory wall fs-sharding removes.
- ``torch-shard-kernel`` — the CUDA entries ``gather_rows_cuda``,
  ``scatter_rows_cuda`` and ``fm_update_rows_cuda`` are called only from
  ops/fused.py, under its device dispatch (``if table.device.type ==
  "cuda"``): the counterpart of the ``resolve_backend`` guard.
- ``torch-shard-break`` — in fs-aware code (a function that cuts or
  routes shard views: ``state_sharding``, ``sharded_*``,
  ``ShardedSlots``, ``fs_shard_bounds``), a whole-table op over a shard
  view or the table.

The runtime half is utils/collscan.py (``DIFACTO_HLOSCAN=1``); ``python
-m difacto_tpu_torch.tools.collmap --check`` merges its dumps with this
model: every collective must be recorded at a site the model knows (a
traced program, or a call that reaches a collective or the moves between
a mesh's logical devices, parallel/mesh.device_copy).

Blind spots, as in JAX: table provenance is name-based and one
assignment hop deep; collectives reached through dynamic dispatch are
known only by the call graph's method heuristic.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .callgraph import CallGraph, get_callgraph
from .core import (Finding, Project, call_name, dotted,
                   enclosing_function, rule)
from .torchflow import get_torch_model

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

# torch.distributed's data-moving calls
COLLECTIVES = {"all_gather", "all_gather_into_tensor", "all_reduce",
               "broadcast", "gather", "scatter", "reduce", "all_to_all",
               "all_to_all_single", "reduce_scatter",
               "reduce_scatter_tensor", "send", "recv", "isend", "irecv",
               "all_gather_object", "broadcast_object_list"}
_DIST_HEADS = ("dist", "torch.distributed")
# the data plane's entry points (parallel/multihost.py)
_PLANE_FUNCS = {"allgather_np", "allreduce_np"}
_PLANE_METHODS = {"gather", "global_batch"}

CUDA_ENTRIES = {"gather_rows_cuda", "scatter_rows_cuda",
                "fm_update_rows_cuda"}
_DISPATCH_FILE = "ops/fused.py"

# the fs shard API: a function that touches one cuts or routes views
_FS_API = {"state_sharding", "sharded_gather", "sharded_push",
           "sharded_scatter", "ShardedSlots", "fs_shard_bounds",
           "plan_slots"}
# whole-table ops: torch functions over an operand, and tensor methods
_WHOLE_FUNCS = {"cat", "concatenate", "stack", "sort", "argsort",
                "flatten", "reshape", "hstack", "vstack"}
_WHOLE_METHODS = {"reshape", "view", "contiguous", "clone", "t",
                  "flatten", "permute", "transpose"}


def _last(cn: str) -> str:
    return cn.rsplit(".", 1)[-1]


def _own_body(func) -> List[ast.AST]:
    """Nodes of ``func``'s own body, nested function/lambda bodies
    excluded."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(func.body)
    while stack:
        n = stack.pop()
        out.append(n)
        for c in ast.iter_child_nodes(n):
            if isinstance(c, _FUNC_DEFS + (ast.Lambda,)):
                continue
            stack.append(c)
    return out


def _table_prov(expr, local_prov: Set[str]) -> bool:
    """Name-based table provenance: ``table``, any ``state.<field>``
    chain, or a local name assigned from one."""
    if isinstance(expr, ast.Name):
        return expr.id == "table" or expr.id in local_prov
    if isinstance(expr, ast.Attribute):
        segs = dotted(expr).split(".")
        return len(segs) > 1 and "state" in segs[:-1] \
            or segs[-1] == "table"
    return False


def _local_prov(func) -> Set[str]:
    """One assignment hop: names bound from a table-provenance
    expression."""
    out: Set[str] = set()
    for n in _own_body(func):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and _table_prov(n.value, out):
            out.add(n.targets[0].id)
    return out


def _is_dist_collective(cn: str) -> bool:
    head, _, tail = cn.rpartition(".")
    return tail in COLLECTIVES and head in _DIST_HEADS


# the one move between a mesh's logical devices (parallel/mesh.py): the
# collective scan records its bytes, so its call sites are known sites
_DEVICE_COPY = "device_copy"


def _is_recorded_move(cn: str) -> bool:
    return _is_dist_collective(cn) or _last(cn) == _DEVICE_COPY


class ShardModel:
    """The whole-program sharding-flow model. Built once per Project
    (cached — the three rules, collmap and the gates share it)."""

    def __init__(self, project: Project):
        self.project = project
        self.cg: CallGraph = get_callgraph(project)
        self.torch = get_torch_model(project)
        self._findings: Dict[str, List[Finding]] = {
            "torch-shard-break": [], "torch-shard-replicate": [],
            "torch-shard-kernel": []}
        self.collective_funcs: Set[str] = set()
        self.collective_sites: Set[str] = set()
        self.kernel_calls: Dict[str, bool] = {}   # site -> guarded
        self._find_collectives()
        self._check_replication()
        self._check_kernel_reach()
        self._check_breaks()

    def _sources(self):
        for sf in self.project.files:
            if sf.tree is not None:
                yield sf

    # --------------------------------------------------- collectives
    def _find_collectives(self) -> None:
        """Functions that issue a collective (a ``torch.distributed``
        call, or one handed to a helper as ``self._collective(dist.x,
        ...)``) and, over exact call edges and the data plane's methods,
        their callers; the call sites of those functions are where a
        collective outside a traced program can be recorded."""
        funcs: Set[str] = set()
        for qual, fi in self.cg.funcs.items():
            if fi.node is None:
                continue
            for n in ast.walk(fi.node):
                if isinstance(n, ast.Call) and (
                        _is_recorded_move(call_name(n))
                        or any(_is_dist_collective(dotted(a))
                               for a in n.args)):
                    funcs.add(qual)
                    self.collective_sites.add(
                        f"{fi.sf.rel}:{n.lineno}")
        changed = True
        while changed:
            changed = False
            for caller, csites in self.cg.calls.items():
                for cs in csites:
                    # exact edges, and the data plane's methods, which
                    # resolve by name (``plane.gather``)
                    if cs.kind == "call" and (
                            not cs.fuzzy or self._moves(cs.node)) \
                            and any(t in funcs for t in cs.targets):
                        fi = self.cg.funcs.get(caller)
                        if fi is not None:
                            self.collective_sites.add(
                                f"{fi.sf.rel}:{cs.node.lineno}")
                        if caller not in funcs \
                                and not caller.endswith("::<module>"):
                            funcs.add(caller)
                            changed = True
        self.collective_funcs = funcs
        # a collective function handed on as a callable
        # (``monitor.guarded(allgather_np, buf)``): the callee's calls of
        # that parameter are collective sites too
        for caller, csites in self.cg.calls.items():
            fi = self.cg.funcs.get(caller)
            if fi is None:
                continue
            for cs in csites:
                if cs.kind != "call":
                    continue
                for pos, a in enumerate(cs.node.args):
                    if not isinstance(a, (ast.Name, ast.Attribute)) \
                            or not any(t in funcs for t in self.cg.
                                       _resolve_ref(fi.sf, fi, a)):
                        continue
                    for t in cs.targets:
                        self._param_call_sites(t, pos)

    def _param_call_sites(self, qual: str, pos: int) -> None:
        """Add the calls of ``qual``'s parameter at caller position
        ``pos`` to the collective sites."""
        ti = self.cg.funcs.get(qual)
        if ti is None or not isinstance(ti.node, _FUNC_DEFS):
            return
        params = [a.arg for a in ti.node.args.posonlyargs
                  + ti.node.args.args]
        if ti.cls is not None and params and params[0] in ("self", "cls"):
            params = params[1:]
        if pos >= len(params):
            return
        for n in ast.walk(ti.node):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                    and n.func.id == params[pos]:
                self.collective_sites.add(f"{ti.sf.rel}:{n.lineno}")

    def knows_collective_at(self, site: str, traced: bool) -> bool:
        """Whether a collective recorded at ``site`` (a traced program's
        site when ``traced``, else its caller's line) is one the model
        knows."""
        if traced:
            return site in self.torch.sites
        return site in self.collective_sites

    # --------------------------------------------------- replication
    def _moves(self, call: ast.Call) -> Optional[str]:
        """What moves ``call``'s arguments across processes, or None."""
        cn = call_name(call)
        if _is_dist_collective(cn):
            return f"torch.distributed.{_last(cn)}"
        if _last(cn) in _PLANE_FUNCS:
            return f"the data plane's {_last(cn)}"
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _PLANE_METHODS \
                and "plane" in dotted(call.func.value).lower():
            return f"the data plane's {call.func.attr}"
        return None

    def _check_replication(self) -> None:
        out = self._findings["torch-shard-replicate"]
        for sf in self._sources():
            for func in [n for n in sf.walk() if isinstance(n, _FUNC_DEFS)]:
                prov = _local_prov(func)
                for c in _own_body(func):
                    if not isinstance(c, ast.Call):
                        continue
                    how = self._moves(c)
                    if how is None:
                        continue
                    args = list(c.args) + [kw.value for kw in c.keywords]
                    flat = []
                    for a in args:
                        flat += a.elts if isinstance(
                            a, (ast.List, ast.Tuple)) else [a]
                    hit = next((a for a in flat if _table_prov(a, prov)),
                               None)
                    if hit is None:
                        continue
                    out.append(sf.finding(
                        "torch-shard-replicate", c,
                        f"table-sized transfer: `{dotted(hit) or 'table'}`"
                        f" reaches {how} — the table crossed processes "
                        f"whole; the planes move per-step partials and "
                        f"rows (losses/fm.dp_reduce), and a table moves "
                        f"through its sharded checkpoint, never a "
                        f"collective"))

    # ------------------------------------------------ kernel dispatch
    @staticmethod
    def _device_guarded(node) -> bool:
        """Under an ``if <x>.device.type == "cuda"`` (or ``<x>.is_cuda``)
        test in its own function."""
        cur = getattr(node, "parent", None)
        while cur is not None and not isinstance(cur, _FUNC_DEFS):
            if isinstance(cur, (ast.If, ast.IfExp)):
                for n in ast.walk(cur.test):
                    if isinstance(n, ast.Compare) and any(
                            isinstance(s, ast.Constant)
                            and s.value == "cuda"
                            for s in [n.left] + list(n.comparators)) \
                            and any(dotted(s).endswith("device.type")
                                    for s in [n.left]
                                    + list(n.comparators)):
                        return True
                    if isinstance(n, ast.Attribute) \
                            and n.attr == "is_cuda":
                        return True
            cur = getattr(cur, "parent", None)
        return False

    def _check_kernel_reach(self) -> None:
        out = self._findings["torch-shard-kernel"]
        for sf in self._sources():
            for c in sf.call_nodes():
                name = _last(call_name(c))
                if name not in CUDA_ENTRIES:
                    continue
                guarded = sf.rel.endswith(_DISPATCH_FILE) \
                    and self._device_guarded(c)
                self.kernel_calls[f"{sf.rel}:{c.lineno}"] = guarded
                if guarded:
                    continue
                where = "outside ops/fused.py" \
                    if not sf.rel.endswith(_DISPATCH_FILE) \
                    else "without the device-type guard"
                out.append(sf.finding(
                    "torch-shard-kernel", c,
                    f"CUDA entry `{name}` is called {where} — the kernels "
                    f"run only behind ops/fused.py's device dispatch "
                    f"(gather_rows / scatter_rows / fm_update_rows), "
                    f"which gives a CPU tensor the plain version and a "
                    f"shard view the same path as the flat table; call "
                    f"the dispatcher"))

    # --------------------------------------------------- layout breaks
    def _fs_aware(self, func) -> bool:
        for n in ast.walk(func):
            if isinstance(n, ast.Name) and n.id in _FS_API:
                return True
            if isinstance(n, ast.Attribute) and n.attr in _FS_API:
                return True
        return False

    def _view_names(self, func) -> Set[str]:
        """Placements and shard views bound in ``func``'s scope chain:
        names bound from ``state_sharding(...)`` (a placement), and from
        a placement's call (a list of views)."""
        placements: Set[str] = set()
        scopes = []
        cur = func
        while cur is not None:
            scopes.append(cur)
            cur = enclosing_function(cur)
        for scope in scopes:
            for n in _own_body(scope):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and "state_sharding" in {
                            _last(call_name(c)) for c in ast.walk(n.value)
                            if isinstance(c, ast.Call)}:
                    placements.add(n.targets[0].id)
        views: Set[str] = set()
        for n in _own_body(func):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and self._is_views(n.value, placements | views):
                views.add(n.targets[0].id)
        return placements | views

    @staticmethod
    def _is_views(expr, names: Set[str]) -> bool:
        """A placement's call (shard views), a name bound from one, or
        an element of them."""
        if isinstance(expr, ast.Name):
            return expr.id in names
        if isinstance(expr, ast.Subscript):
            return ShardModel._is_views(expr.value, names)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id in names:
                return True
            if isinstance(f, ast.Call) \
                    and _last(call_name(f)) == "state_sharding":
                return True
        return False

    @staticmethod
    def _into_table(call: ast.Call, prov: Set[str]) -> bool:
        """Whether ``call``'s value becomes the table: assigned to a
        table-provenance target, or handed to a state constructor
        (``state._replace(VVg=...)``, ``SGDState(...)``)."""
        cur = getattr(call, "parent", None)
        while cur is not None and not isinstance(cur, ast.stmt):
            if isinstance(cur, ast.Call) and (
                    _last(call_name(cur)) in ("_replace", "SGDState")):
                return True
            cur = getattr(cur, "parent", None)
        if isinstance(cur, ast.Assign):
            for t in cur.targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if _table_prov(e, prov) or (
                            isinstance(e, ast.Name) and e.id == "state"):
                        return True
        return False

    def _check_breaks(self) -> None:
        out = self._findings["torch-shard-break"]
        for sf in self._sources():
            for func in [n for n in sf.walk() if isinstance(n, _FUNC_DEFS)]:
                if not self._fs_aware(func):
                    continue
                prov = _local_prov(func)
                views = self._view_names(func)
                for c in _own_body(func):
                    if not isinstance(c, ast.Call):
                        continue
                    cn = call_name(c)
                    operand = None
                    if isinstance(c.func, ast.Attribute) \
                            and c.func.attr in _WHOLE_METHODS:
                        operand = c.func.value
                    elif cn.startswith("torch.") \
                            and _last(cn) in _WHOLE_FUNCS and c.args:
                        operand = c.args[0]
                    if operand is None:
                        continue
                    ops = operand.elts if isinstance(
                        operand, (ast.List, ast.Tuple)) else [operand]
                    what = None
                    for o in ops:
                        if self._is_views(o, views):
                            what = "the fs shard views"
                        elif _table_prov(o, prov) \
                                and self._into_table(c, prov):
                            what = f"the table `{dotted(o) or 'table'}`"
                        if what:
                            break
                    if what is None:
                        continue
                    op = c.func.attr if isinstance(c.func, ast.Attribute) \
                        and c.func.attr in _WHOLE_METHODS else cn
                    out.append(sf.finding(
                        "torch-shard-break", c,
                        f"`{op}` over {what} in fs-aware code re-lays "
                        f"or replaces the whole table — the shard views "
                        f"(parallel/mesh.state_sharding) keep the old "
                        f"storage, so a push through them is lost (and "
                        f"the whole table moves through memory); route "
                        f"the rows through parallel/sharded.py's "
                        f"per-shard launches instead"))


def get_shard_model(project: Project) -> ShardModel:
    m = getattr(project, "_shard_model", None)
    if m is None or m.project is not project:
        m = ShardModel(project)
        project._shard_model = m  # type: ignore[attr-defined]
    return m


# ---------------------------------------------------------------------------
# rule registrations


@rule("torch-shard-break",
      "no whole-table op over the fs shard views or the table in "
      "fs-aware code", cross=True)
def check_torch_shard_break(project: Project) -> List[Finding]:
    return list(get_shard_model(project)._findings["torch-shard-break"])


@rule("torch-shard-replicate",
      "no table-sized tensor through a collective or the data plane",
      cross=True)
def check_torch_shard_replicate(project: Project) -> List[Finding]:
    return list(
        get_shard_model(project)._findings["torch-shard-replicate"])


@rule("torch-shard-kernel",
      "the CUDA entries only behind ops/fused.py's device dispatch",
      cross=True)
def check_torch_shard_kernel(project: Project) -> List[Finding]:
    return list(get_shard_model(project)._findings["torch-shard-kernel"])
