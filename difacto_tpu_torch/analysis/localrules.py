"""Single-file rules: concurrency hygiene, the monotonic-clock
contract, exception discipline (copies of difacto_tpu/analysis/
localrules.py), and the torch counterparts of its three JAX tracing
rules: ``torch-inplace`` (``jax-donate``), ``torch-traced-capture``
(``jax-jit-capture``) and ``torch-host-call`` (``jax-host-call``).

Each rule is a function ``(SourceFile) -> list[Finding]`` registered
with :func:`core.rule`. They share one parsed AST (with ``.parent``
links) per file and a handful of helpers from :mod:`core`; none of them
import anything outside the stdlib. Per-rule fixtures live in
``tests/test_lint.py`` and ``tests/test_torch_analysis.py`` — every
rule has at least one true-positive and one suppressed/negative
fixture there.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import (Finding, SourceFile, call_name, dotted,
                   enclosing_function, from_imports, import_aliases,
                   node_key, rule, statement_of)


def _walk_calls(tree) -> List[ast.Call]:
    """Call nodes of a tree — or of a whole SourceFile, in which case
    the file's shared node index is reused instead of re-walking."""
    if isinstance(tree, SourceFile):
        return tree.call_nodes()
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)]


def _assign_key(call: ast.Call) -> Optional[str]:
    """Key of the single name/attribute a call's value is bound to, or
    None when unbound (bare expression, tuple target, nested use)."""
    stmt = statement_of(call)
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and stmt.value is call:
        return node_key(stmt.targets[0]) or None
    if isinstance(stmt, ast.AnnAssign) and stmt.value is call:
        return node_key(stmt.target) or None
    return None


def _method_calls_on(tree, key: str, methods: Set[str]) -> bool:
    """Is there any ``<key>.m(...)`` call with m in methods?"""
    for c in _walk_calls(tree):
        if isinstance(c.func, ast.Attribute) and c.func.attr in methods \
                and node_key(c.func.value) == key:
            return True
    return False


def _in_withitem(node) -> bool:
    """Is this expression (possibly wrapped, e.g. ``closing(...)``) the
    context expression of a ``with`` statement?"""
    cur = node
    while cur is not None and not isinstance(cur, ast.stmt):
        parent = getattr(cur, "parent", None)
        if isinstance(parent, ast.withitem):
            return True
        cur = parent
    return False


# ---------------------------------------------------------------------------


@rule("thread-daemon",
      "threads must be created with daemon= or joined")
def check_thread_daemon(sf: SourceFile) -> List[Finding]:
    out = []
    for call in _walk_calls(sf):
        cn = call_name(call)
        if not (cn == "Thread" or cn.endswith(".Thread")):
            continue
        if any(kw.arg == "daemon" for kw in call.keywords):
            continue
        key = _assign_key(call)
        if key and _method_calls_on(sf, key, {"join"}):
            continue
        out.append(sf.finding(
            "thread-daemon", call,
            "thread created without daemon= and never joined — a "
            "non-daemon thread blocks interpreter exit; pass "
            "daemon=True or join() it on every path"))
    return out


@rule("lock-release",
      "Lock.acquire() needs `with lock:` or finally: release()")
def check_lock_release(sf: SourceFile) -> List[Finding]:
    out = []
    for call in _walk_calls(sf):
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr == "acquire"):
            continue
        key = node_key(call.func.value)
        if not key:
            continue
        # accept a matching `finally: release()` anywhere in the
        # enclosing function — it may guard the acquire from an
        # ancestor Try OR follow it as a sibling (`if not
        # lock.acquire(timeout=...): return` then try/finally)
        scope = enclosing_function(call) or sf.tree
        released = False
        for t in ast.walk(scope):
            if not isinstance(t, ast.Try):
                continue
            for stmt in t.finalbody:
                for c in _walk_calls(stmt):
                    if isinstance(c.func, ast.Attribute) \
                            and c.func.attr == "release" \
                            and node_key(c.func.value) == key:
                        released = True
        if not released:
            out.append(sf.finding(
                "lock-release", call,
                f"{key.lstrip('.')}.acquire() outside `with` without a "
                f"finally: release() — an exception between acquire and "
                f"release deadlocks every other holder"))
    return out


# resources whose open must pair with a close on every path
_OPEN_EXACT = {"open", "io.open", "os.fdopen", "gzip.open",
               "socket.socket", "socket.create_connection", "mmap.mmap"}
_CLOSERS = {"close", "shutdown", "unlink", "release", "detach",
            "terminate", "fileno"}  # fileno: fd handed to an owning wrapper


def _is_opener(cn: str) -> bool:
    return cn in _OPEN_EXACT or cn == "SharedMemory" \
        or cn.endswith(".SharedMemory")


def _name_escapes(scope, key: str, binder: ast.stmt) -> bool:
    """Does the bound resource leave this scope (returned, yielded,
    stored in a container/attribute, or passed to another call)? An
    escaped resource is some other owner's to close."""
    for n in ast.walk(scope):
        if not (isinstance(n, ast.Name) and n.id == key
                and isinstance(n.ctx, ast.Load)):
            continue
        parent = getattr(n, "parent", None)
        if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom,
                               ast.Tuple, ast.List, ast.Dict, ast.Set)):
            return True
        if isinstance(parent, ast.Call) and n in parent.args:
            return True
        if isinstance(parent, ast.keyword):
            return True
        if isinstance(parent, (ast.Assign, ast.AnnAssign)) \
            and getattr(parent, "value", None) is n \
                and statement_of(parent) is not binder:
            return True  # re-bound elsewhere: aliased, owner unclear
        if isinstance(parent, ast.Subscript):
            return True
    return False


@rule("resource-close",
      "sockets/files/SharedMemory/mmap need `with` or a close on "
      "every path")
def check_resource_close(sf: SourceFile) -> List[Finding]:
    out = []
    for call in _walk_calls(sf):
        cn = call_name(call)
        if not _is_opener(cn):
            continue
        if _in_withitem(call):
            continue
        stmt = statement_of(call)
        if isinstance(stmt, ast.Return) or any(
                isinstance(p, (ast.Yield, ast.YieldFrom))
                for p in ast.walk(stmt)):
            continue  # handed to the caller: theirs to close
        key = _assign_key(call)
        if key is None:
            # not bound to a name: `f(open(p))` leaks the handle, a bare
            # `socket.socket()` statement leaks the fd
            out.append(sf.finding(
                "resource-close", call,
                f"{cn}(...) opened without a binding or `with` — the "
                f"handle can never be closed"))
            continue
        if key.startswith("."):
            # self/obj attribute: accept when the module closes that
            # attribute somewhere (close()/stop() methods, __exit__)
            if _method_calls_on(sf, key, _CLOSERS):
                continue
        else:
            scope = enclosing_function(call) or sf.tree
            if _method_calls_on(scope, key, _CLOSERS):
                continue
            if _name_escapes(scope, key, stmt):
                continue
        out.append(sf.finding(
            "resource-close", call,
            f"{cn}(...) bound to {key.lstrip('.')} is never closed — "
            f"use `with`, or close it in a finally/close() path"))
    return out


@rule("wall-clock",
      "durations and deadlines must use time.monotonic()")
def check_wall_clock(sf: SourceFile) -> List[Finding]:
    time_aliases = import_aliases(sf.tree, "time")
    time_members = {alias for alias, orig in
                    from_imports(sf.tree, "time").items() if orig == "time"}
    out = []
    for call in _walk_calls(sf):
        f = call.func
        hit = (isinstance(f, ast.Attribute) and f.attr == "time"
               and isinstance(f.value, ast.Name)
               and f.value.id in time_aliases) \
            or (isinstance(f, ast.Name) and f.id in time_members)
        if hit:
            out.append(sf.finding(
                "wall-clock", call,
                "time.time() is wall clock: NTP steps/slew corrupt "
                "durations and deadlines — use time.monotonic() (the "
                "obs clock contract); a true timestamp-of-record may "
                "suppress with `# lint: ok(wall-clock)`"))
    return out


_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log"}
_COUNT_METHODS = {"inc", "observe", "set", "record_error", "record_shed",
                  "set_exception", "print_exc", "format_exc",
                  "count_swallowed"}


def _handler_reports(handler: ast.ExceptHandler) -> bool:
    """A broad handler is acceptable when the error is visibly routed
    somewhere: re-raised, logged, counted, printed, formatted for a
    result channel — or when the bound exception name is referenced at
    all (captured into an err list, stuffed into a message, ...)."""
    for n in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, ast.Call):
            fn = n.func
            if isinstance(fn, ast.Attribute) \
                    and fn.attr in (_LOG_METHODS | _COUNT_METHODS):
                return True
            if isinstance(fn, ast.Name) and fn.id == "print":
                return True
        if handler.name and isinstance(n, ast.Name) \
                and n.id == handler.name and isinstance(n.ctx, ast.Load):
            return True
    return False


@rule("broad-except",
      "broad excepts must log-and-count, re-raise, or narrow")
def check_broad_except(sf: SourceFile) -> List[Finding]:
    out = []
    for node in sf.walk():
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            out.append(sf.finding(
                "broad-except", node,
                "bare `except:` also swallows SystemExit and "
                "KeyboardInterrupt — catch `Exception` at most, and "
                "log what was caught"))
            continue
        names = [node.type] if not isinstance(node.type, ast.Tuple) \
            else list(node.type.elts)
        broad = any(dotted(n) in ("Exception", "BaseException")
                    for n in names)
        if broad and not _handler_reports(node):
            out.append(sf.finding(
                "broad-except", node,
                "`except Exception` that neither re-raises, logs, nor "
                "counts — failures vanish silently; log-and-count (obs "
                "counter) or narrow the type"))
    return out


# ---------------------------------------------------------------------------
# torch tracing rules

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

# in-place kernel entries of ops/fused.py and parallel/sharded.py: name ->
# position of the tensor they update
INPLACE_ENTRIES = {
    "scatter_rows": 0, "fm_update_rows": 0, "scatter_rows_ref": 0,
    "fm_update_rows_ref": 0, "scatter_rows_cuda": 0,
    "fm_update_rows_cuda": 0, "sharded_push": 0, "sharded_scatter": 0,
}
# methods that hand back a view of (or the very) tensor they are called
# on: a name bound from one of them aliases the receiver
_VIEW_METHODS = {"view", "view_as", "reshape", "detach", "narrow",
                 "select", "expand", "expand_as", "flatten", "squeeze",
                 "unsqueeze", "permute", "transpose", "t", "unflatten",
                 "as_strided", "diagonal", "movedim", "unfold",
                 "contiguous", "requires_grad_", "T", "mT", "real"}


def _inplace_method(call: ast.Call) -> bool:
    """``x.op_(...)``: torch's in-place spelling (a trailing underscore,
    not a dunder or a private name)."""
    f = call.func
    return isinstance(f, ast.Attribute) and f.attr.endswith("_") \
        and not f.attr.startswith("_") and len(f.attr) > 1


def inplace_target(call: ast.Call) -> Optional[ast.AST]:
    """The tensor expression ``call`` updates in place: the receiver of
    an ``op_`` method, or the updated argument of an in-place kernel
    entry; None otherwise."""
    if _inplace_method(call):
        return call.func.value
    name = call_name(call).rsplit(".", 1)[-1]
    pos = INPLACE_ENTRIES.get(name)
    if pos is not None and pos < len(call.args):
        return call.args[pos]
    return None


def alias_base(expr) -> Optional[str]:
    """The name whose tensor ``expr`` aliases: the name itself, a basic
    slice of it (``t[:n]``, ``t[0]``), or a view method on it
    (``t.view(-1)``, ``t.detach()``, ``t.T``); None when ``expr`` makes
    a new tensor (``clone()``, advanced indexing, arithmetic)."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Subscript):
        sl = expr.slice
        parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        if all(isinstance(p, (ast.Slice, ast.Constant)) for p in parts):
            return alias_base(expr.value)
        return None
    if isinstance(expr, ast.Attribute) and expr.attr in _VIEW_METHODS:
        return alias_base(expr.value)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr in _VIEW_METHODS:
        return alias_base(expr.func.value)
    return None


def stale_alias_reads(scope, updates) -> List[Tuple[ast.Name, str, str,
                                                    ast.AST]]:
    """(read, alias, base, update) for each first Load of a local alias of
    a tensor after an in-place update of it in ``scope``. ``updates`` are
    (statement, updated base name, what) pairs; an alias is a name bound
    by ``alias = <view of base>`` before the update and not rebound in
    between."""
    binds: Dict[str, List[Tuple[int, Optional[str]]]] = {}
    for n in ast.walk(scope):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    binds.setdefault(t.id, []).append(
                        (n.lineno, alias_base(n.value)))
    out = []
    for stmt, base, what in updates:
        for alias, bl in binds.items():
            if alias == base:
                continue
            before = [b for ln, b in bl if ln < stmt.lineno]
            after = [ln for ln, _ in bl
                     if stmt.lineno <= ln <= stmt.end_lineno]
            if not before or before[-1] != base or after:
                continue
            later = [ln for ln, _ in bl if ln > stmt.end_lineno]
            for n in ast.walk(scope):
                if isinstance(n, ast.Name) and n.id == alias \
                        and isinstance(n.ctx, ast.Load) \
                        and n.lineno > stmt.end_lineno \
                        and not any(ln < n.lineno for ln in later):
                    out.append((n, alias, base, what))
                    break
    return out


def _local_updates(scope) -> List[Tuple[ast.stmt, str, str]]:
    out = []
    for call in _walk_calls(scope):
        tgt = inplace_target(call)
        if isinstance(tgt, ast.Name):
            what = call.func.attr if _inplace_method(call) \
                else call_name(call)
            out.append((statement_of(call), tgt.id, what))
    return out


@rule("torch-inplace",
      "a view of a tensor must not be read as the old value after an "
      "in-place update of that tensor")
def check_torch_inplace(sf: SourceFile) -> List[Finding]:
    out = []
    for fn in [n for n in sf.walk() if isinstance(n, _FUNC_DEFS)]:
        for read, alias, base, what in stale_alias_reads(
                fn, _local_updates(fn)):
            if enclosing_function(read) is not fn:
                continue
            out.append(sf.finding(
                "torch-inplace", read,
                f"`{alias}` aliases `{base}` (a view bound before "
                f"`{what}` updated `{base}` in place) and is read after "
                f"the update — it holds the new values, not the old "
                f"ones; clone() it before the update if the old values "
                f"are meant"))
    return out


def is_traced_name(cn: str) -> bool:
    """``devtrace.traced``: the port's step-program wrapper."""
    return cn == "devtrace.traced" or cn.endswith(".devtrace.traced")


def traced_functions(sf: SourceFile) -> List[ast.AST]:
    """FunctionDefs that are traced programs: decorated with
    ``@devtrace.traced`` or passed by name to a ``traced(...)``
    call in the same file."""
    by_name: Set[str] = set()
    for call in _walk_calls(sf):
        if is_traced_name(call_name(call)) and call.args \
                and isinstance(call.args[0], ast.Name):
            by_name.add(call.args[0].id)
    out = []
    for node in sf.walk():
        if not isinstance(node, _FUNC_DEFS):
            continue
        traced = node.name in by_name
        for dec in node.decorator_list:
            d = dec.func if isinstance(dec, ast.Call) else dec
            if is_traced_name(dotted(d)):
                traced = True
        if traced:
            out.append(node)
    return out


def _loop_assigned_attrs(cls: ast.ClassDef) -> Set[str]:
    """``self.<attr>`` names a class rebinds inside a loop: state that
    changes between the calls of its programs."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            continue
        for n in ast.walk(node):
            tgts = n.targets if isinstance(n, ast.Assign) else \
                [n.target] if isinstance(n, (ast.AugAssign,
                                             ast.AnnAssign)) else []
            for t in tgts:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    out.add(t.attr)
    return out


def _rebound_names(fn) -> Set[str]:
    """Names an enclosing function binds more than once (or augments):
    a closure over one reads whatever the last binding left."""
    count: Dict[str, int] = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                for e in ast.walk(t):
                    if isinstance(e, ast.Name):
                        count[e.id] = count.get(e.id, 0) + 1
        elif isinstance(n, ast.AugAssign) \
                and isinstance(n.target, ast.Name):
            count[n.target.id] = count.get(n.target.id, 0) + 2
        elif isinstance(n, ast.Nonlocal):
            for name in n.names:
                count[name] = count.get(name, 0) + 2
    return {k for k, v in count.items() if v > 1}


@rule("torch-traced-capture",
      "traced programs must not close over mutable state")
def check_torch_traced_capture(sf: SourceFile) -> List[Finding]:
    out = []
    for fn in traced_functions(sf):
        params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                  + fn.args.kwonlyargs)}
        body = ast.Module(body=fn.body, type_ignores=[])
        outer = enclosing_function(fn)
        cls = getattr(fn, "parent", None)
        if "self" in params and isinstance(cls, ast.ClassDef):
            # a traced method: the attributes its class rebinds in a
            # loop change under a captured program
            moving = _loop_assigned_attrs(cls)
            for n in ast.walk(body):
                if isinstance(n, ast.Attribute) \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id == "self" and n.attr in moving \
                        and isinstance(n.ctx, ast.Load):
                    out.append(sf.finding(
                        "torch-traced-capture", n,
                        f"traced `{fn.name}` reads `self.{n.attr}`, which "
                        f"the class rebinds in a loop — a captured CUDA "
                        f"graph bakes in the tensor of its capture; pass "
                        f"it as an argument"))
                    break
            continue
        if outer is None:
            continue
        rebound = _rebound_names(outer) - params
        for n in ast.walk(body):
            if not isinstance(n, ast.Name) or not isinstance(n.ctx,
                                                             ast.Load):
                continue
            if n.id in ("self", "cls") and n.id not in params:
                out.append(sf.finding(
                    "torch-traced-capture", n,
                    f"traced `{fn.name}` closes over `{n.id}` — its state "
                    f"is read at call time in eager mode but baked in by "
                    f"a captured CUDA graph; pass the values as "
                    f"arguments"))
                break
            if n.id in rebound:
                out.append(sf.finding(
                    "torch-traced-capture", n,
                    f"traced `{fn.name}` closes over `{n.id}`, which "
                    f"its enclosing function rebinds — a captured CUDA "
                    f"graph keeps the binding of its capture; pass it "
                    f"as an argument"))
                break
    return out


# numpy attributes that are metadata, not host array work
_NP_OK = {"dtype", "iinfo", "finfo", "result_type", "promote_types",
          "can_cast", "isscalar", "ndim", "shape",
          "float16", "float32", "float64", "int8", "int16", "int32",
          "int64", "uint8", "uint16", "uint32", "uint64", "bool_"}
_HOST_MODULES = {"time", "random", "os"}
# tensor methods that copy to the host (and wait for the device)
_HOST_METHODS = {"item", "cpu", "tolist", "numpy"}


@rule("torch-host-call",
      "no host numpy, side-effect or device-to-host calls inside a "
      "traced program")
def check_torch_host_call(sf: SourceFile) -> List[Finding]:
    np_aliases = import_aliases(sf.tree, "numpy")
    out = []
    for fn in traced_functions(sf):
        for call in _walk_calls(ast.Module(body=fn.body, type_ignores=[])):
            cn = call_name(call)
            head, _, tail = cn.partition(".")
            msg = None
            if head in np_aliases and tail and tail not in _NP_OK:
                msg = (f"host numpy call `{cn}(...)` inside traced "
                       f"`{fn.name}` runs on the host every call (and a "
                       f"captured CUDA graph skips it) — use torch ops")
            elif head in _HOST_MODULES and tail:
                msg = (f"side-effecting host call `{cn}(...)` inside "
                       f"traced `{fn.name}` is not part of the device "
                       f"program a CUDA graph captures — hoist it out")
            elif cn == "print":
                msg = (f"print() inside traced `{fn.name}` runs on the "
                       f"host (and syncs on a device value) — log "
                       f"outside the program")
            elif isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _HOST_METHODS:
                msg = (f"`.{call.func.attr}()` inside traced "
                       f"`{fn.name}` copies to the host and waits for "
                       f"the device — a sync inside the program, which "
                       f"a CUDA graph cannot capture; return the tensor "
                       f"and fetch it outside (devtrace.fetch)")
            if msg:
                out.append(sf.finding("torch-host-call", call, msg))
    return out
