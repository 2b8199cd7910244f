"""Run-time tracing of the port's step programs, kernel launches,
declared device-host copies and CUDA syncs (counterpart of
difacto_tpu/utils/jaxtrace.py).

Every step program of the port is created through :func:`traced`, every
hand-written kernel's entry point through :func:`kernel`, every
sanctioned device-to-host copy goes through :func:`fetch` and every
declared host-to-device staging copy through :func:`to_device`.
Disabled (the default), ``traced`` and ``kernel`` return the function
they were given (the same object) and ``fetch``/``to_device`` are one
call around the copy: a run with tracing off launches the same kernels
in the same order.

With ``DIFACTO_JAXTRACE=1`` (or ``DIFACTO_HLOSCAN=1``, utils/collscan.py,
which rides the same wrappers):

- ``traced`` records, per **creation site** (``relpath:lineno`` of the
  ``traced(...)`` call, the key jaxtrace uses), the calls and the
  distinct call **signatures**: tensors by ``(shape, dtype, device)``,
  Python scalars by type, statics by value. In eager PyTorch a new
  signature is what a recompile is in JAX: a new allocation pattern, and
  for a CUDA graph a new graph to capture. The dump's ``compiles`` is the
  signature count, so jaxtrace's JSON shape holds;
- ``kernel`` counts the launches per entry point's creation site (the
  launches its ``.launches`` counter took during the call: the entry
  points count them on their module-level name, which is the wrapper);
- ``fetch`` and ``to_device`` count each copy per call site with its
  point name (``fetches`` and ``puts``);
- on a CUDA device, ``torch.cuda.set_sync_debug_mode("warn")`` is turned
  on for the run, and each sync it reports is attributed by its Python
  stack: with ``fetch`` or ``to_device`` on the stack it is **declared**,
  otherwise **undeclared** and counted per site, the innermost frame
  inside ``difacto_tpu_torch/``, with how many of them ran under a serve
  dispatch (a frame in ``serve/``) and how many inside a traced program.
  The mode is process-wide and the port dispatches from several threads
  (the serve batcher, the lookahead, the producers), so syncs are
  classified by stack and the mode is never toggled around a copy.

``DIFACTO_JAXTRACE_OUT=<path>`` dumps the sites, copies and syncs as
JSON at process exit. ``python -m difacto_tpu_torch.tools.devmap`` merges
a dump with the static inventory of the port's sites.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import sys
import threading
import types
import warnings
from pathlib import Path
from typing import Dict

from .locktrace import mutex

# repo root: difacto_tpu_torch/utils/devtrace.py -> two parents up from
# the package directory; sites are relative to it, as jaxtrace's are
_ROOT = Path(__file__).resolve().parents[2]
_PKG = str(_ROOT / "difacto_tpu_torch") + os.sep
_SELF = os.path.abspath(__file__)

SYNC_MESSAGE = "called a synchronizing CUDA operation"

_reg_mu = mutex()                # guards the registries
_sites: Dict[str, "_SiteStats"] = {}
_fetches: Dict[str, dict] = {}   # site -> {point, count}
_puts: Dict[str, dict] = {}      # site -> {point, count}
_syncs: Dict[str, dict] = {}     # undeclared: site -> {count, serve, ...}
_declared = [0]                  # syncs with a declared copy on the stack
_armed = [False, False]          # [tried, sync debug mode on]
_tls = threading.local()         # per-thread stack of running programs
_rel_cache: Dict[str, str] = {}


class _SiteStats:
    __slots__ = ("calls", "keys", "label", "kind", "launches")

    def __init__(self, label: str, kind: str):
        self.calls = 0
        self.keys: set = set()
        self.label = label
        self.kind = kind
        self.launches = 0


def enabled() -> bool:
    # DIFACTO_HLOSCAN implies tracing: the collective and memory scan
    # (utils/collscan.py) rides the traced wrappers and their sites
    return os.environ.get("DIFACTO_JAXTRACE", "") not in ("", "0") \
        or os.environ.get("DIFACTO_HLOSCAN", "") not in ("", "0")


def _rel(filename: str) -> str:
    rel = _rel_cache.get(filename)
    if rel is None:
        try:
            rel = Path(filename).resolve().relative_to(_ROOT).as_posix()
        except ValueError:
            rel = filename
        _rel_cache[filename] = rel
    return rel


def _site(depth: int = 2) -> str:
    fr = sys._getframe(depth)
    return f"{_rel(fr.f_code.co_filename)}:{fr.f_lineno}"


def _leaf_key(a):
    # the objects themselves (a torch.Size is a tuple; dtypes and devices
    # hash): the key is made on every traced call, its repr only in dumps
    shape = getattr(a, "shape", None)
    if shape is not None and not isinstance(a, type):
        return ("a", tuple(shape), getattr(a, "dtype", None),
                getattr(a, "device", None))
    if a is None or isinstance(a, bool):
        return ("c", a)
    if isinstance(a, (int, float, complex, str, bytes)):
        return ("py", type(a).__name__)
    if isinstance(a, (tuple, list)):
        return ("s", tuple(_leaf_key(x) for x in a))
    if isinstance(a, dict):
        return ("d", tuple((k, _leaf_key(a[k])) for k in sorted(a)))
    return ("o", type(a).__name__)


def _arg_key(args: tuple, kwargs: dict, statics: frozenset) -> tuple:
    """A call's signature: statics by value, tensors by (shape, dtype,
    device), Python scalars by type, NamedTuples and sequences leaf by
    leaf."""
    out = []
    for i, a in enumerate(args):
        if i in statics:
            try:
                hash(a)
                out.append(("s", a))
            except TypeError:
                out.append(("s!", type(a).__name__))
        else:
            out.append(_leaf_key(a))
    for k in sorted(kwargs):
        out.append((k, _leaf_key(kwargs[k])))
    return tuple(out)


def _register(site: str, label: str, kind: str) -> None:
    with _reg_mu:
        _sites.setdefault(site, _SiteStats(label, kind))
    _arm_sync()


def current_program() -> str:
    """The innermost traced program running on this thread ('' outside
    any): the site a collective or an allocation peak is charged to."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else ""


class _Traced:
    """A traced step program: stamps per-site calls and signatures, and
    under the collective scan measures the call's peak device bytes.
    Attribute access forwards to the wrapped function."""

    __slots__ = ("_fn", "site", "_statics", "label")

    def __init__(self, fn, site: str, statics: frozenset, label: str):
        self._fn = fn
        self.site = site
        self._statics = statics
        self.label = label

    def __call__(self, *args, **kwargs):
        from . import collscan
        key = _arg_key(args, kwargs, self._statics)
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.site)
        try:
            if collscan.enabled():
                out = collscan.measure(self.site, self.label, self._fn,
                                       args, kwargs)
            else:
                out = self._fn(*args, **kwargs)
        finally:
            stack.pop()
        with _reg_mu:
            st = _sites[self.site]
            st.calls += 1
            st.keys.add(key)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __get__(self, obj, objtype=None):
        # a traced method: bind it as the function it wraps would be
        return self if obj is None else types.MethodType(self, obj)


def traced(fn, statics=()):
    """``fn`` itself with tracing off; with it on, a wrapper that records
    the calls and call signatures of this creation site (the
    ``relpath:lineno`` of this call, or of the ``@traced`` line of a
    decorated method). ``statics`` are the positions of arguments that
    key the signature by value (as ``static_argnums`` does for a jit
    program)."""
    if not enabled():
        return fn
    site = _site()
    label = getattr(fn, "__name__", type(fn).__name__)
    _register(site, label, "program")
    if isinstance(statics, int):
        statics = (statics,)
    return _Traced(fn, site, frozenset(statics), label)


def kernel(fn):
    """A hand-written kernel's entry point: ``fn`` itself with tracing
    off; with it on, a wrapper counting the calls, signatures and
    launches at this creation site. The entry point counts a launch on
    its ``launches`` attribute through its module-level name, which is
    then this wrapper (``functools.wraps`` carries the counter over)."""
    if not enabled():
        return fn
    site = _site()
    label = getattr(fn, "__name__", type(fn).__name__)
    _register(site, label, "kernel")

    @functools.wraps(fn)
    def launch(*args, **kwargs):
        key = _arg_key(args, kwargs, frozenset())
        before = getattr(launch, "launches", 0)
        out = fn(*args, **kwargs)
        n = getattr(launch, "launches", 0) - before
        with _reg_mu:
            st = _sites[site]
            st.calls += 1
            st.launches += n
            st.keys.add(key)
        return out

    return launch


def _count(reg: Dict[str, dict], point: str) -> None:
    site = _site(3)
    with _reg_mu:
        rec = reg.setdefault(site, {"point": point, "count": 0})
        rec["count"] += 1


def fetch(t, point: str = "", out=None, fence: bool = False):
    """A declared device-to-host copy, counted per call site under
    ``point`` when tracing is on. Returns ``t.cpu()``; with ``out`` (a
    pinned host tensor) the copy is ``out.copy_(t, non_blocking=True)``
    followed by a sync of the current stream, and ``out`` is returned.
    ``fence`` first waits for the whole device (``torch.cuda.
    synchronize``): the timing fences of parallel/capacity.py."""
    if enabled():
        _count(_fetches, point)
    cuda = getattr(getattr(t, "device", None), "type", "") == "cuda"
    if fence and cuda:
        import torch
        torch.cuda.synchronize(t.device)
    if out is None:
        return t.cpu()
    out.copy_(t, non_blocking=True)
    if cuda:
        import torch
        torch.cuda.current_stream(t.device).synchronize()
    return out


def to_device(a, device, point: str = ""):
    """A declared host-to-device copy of a numpy array (or a host
    tensor): ``torch.from_numpy(a).to(device)``, counted per call site
    under ``point`` when tracing is on. A copy from pageable memory
    syncs the stream on a card; routing it here declares that sync."""
    import torch
    if enabled():
        _count(_puts, point)
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    return t.to(device)


# ----------------------------------------------------------- CUDA syncs
def _arm_sync() -> None:
    """Turn on the CUDA sync detector once, when a wrapper is created on
    a machine with a card. It never turns off: the mode is process-wide
    and other threads may be mid-dispatch."""
    if _armed[0]:
        return
    _armed[0] = True
    try:
        import torch
        if not torch.cuda.is_available():
            return
    except ImportError:
        return
    warnings.filterwarnings("always", message=SYNC_MESSAGE)
    prev = warnings.showwarning

    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if str(message).startswith(SYNC_MESSAGE):
            record_sync(sys._getframe(1))
            return
        prev(message, category, filename, lineno, file, line)

    warnings.showwarning = showwarning
    torch.cuda.set_sync_debug_mode("warn")
    _armed[1] = True


def sync_debug_on() -> bool:
    """True when the CUDA sync detector is on in this process."""
    return _armed[1]


_DECLARED_CODES = (fetch.__code__, to_device.__code__)


def record_sync(frame) -> None:
    """Classify one sync from the stack at ``frame``: declared when a
    declared copy is on it, else counted at its innermost frame inside
    the port."""
    site = None
    serve = False
    f = frame
    while f is not None:
        code = f.f_code
        if code in _DECLARED_CODES:
            with _reg_mu:
                _declared[0] += 1
            return
        fn = code.co_filename
        if fn.startswith(_PKG) and os.path.abspath(fn) != _SELF:
            rel = _rel(fn)
            if site is None:
                site = f"{rel}:{f.f_lineno}"
            if rel.startswith("difacto_tpu_torch/serve/"):
                serve = True
        f = f.f_back
    site = site or "<outside the port>"
    in_program = bool(current_program())
    with _reg_mu:
        rec = _syncs.setdefault(site, {"count": 0, "serve": 0,
                                       "in_program": 0})
        rec["count"] += 1
        rec["serve"] += serve
        rec["in_program"] += in_program


# ----------------------------------------------------------------- data
def sites() -> Dict[str, dict]:
    """Snapshot: site -> {label, kind, calls, compiles (distinct
    signatures), keys} and, for a kernel, its launches."""
    with _reg_mu:
        out = {}
        for s, st in _sites.items():
            rec = {"label": st.label, "kind": st.kind, "calls": st.calls,
                   "compiles": len(st.keys),
                   "keys": sorted(repr(k) for k in st.keys)}
            if st.kind == "kernel":
                rec["launches"] = st.launches
            out[s] = rec
        return out


def fetches() -> Dict[str, dict]:
    """Snapshot: fetch site -> {point, count}."""
    with _reg_mu:
        return {s: dict(rec) for s, rec in _fetches.items()}


def puts() -> Dict[str, dict]:
    """Snapshot: host-to-device copy site -> {point, count}."""
    with _reg_mu:
        return {s: dict(rec) for s, rec in _puts.items()}


def syncs() -> Dict[str, dict]:
    """Snapshot: undeclared sync site -> {count, serve, in_program}."""
    with _reg_mu:
        return {s: dict(rec) for s, rec in _syncs.items()}


def declared_syncs() -> int:
    with _reg_mu:
        return _declared[0]


def reset() -> None:
    """Clear the counts (the sites and their wrappers stay registered,
    at zero)."""
    with _reg_mu:
        for st in _sites.values():
            st.calls = st.launches = 0
            st.keys.clear()
        _fetches.clear()
        _puts.clear()
        _syncs.clear()
        _declared[0] = 0


def dump(path) -> str:
    """Write the observed sites, copies and syncs as JSON; returns the
    path."""
    payload = {
        "version": 1,
        "sites": dict(sorted(sites().items())),
        "fetches": dict(sorted(fetches().items())),
        "puts": dict(sorted(puts().items())),
        "syncs": dict(sorted(syncs().items())),
        "declared_syncs": declared_syncs(),
        "sync_debug": sync_debug_on(),
    }
    p = Path(path)
    if p.parent and str(p.parent) not in (".", ""):
        p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=1) + "\n", encoding="utf-8")
    return str(p)


def load(path) -> dict:
    """Read a dump() file back: {'sites', 'fetches', 'puts', 'syncs',
    'declared_syncs', 'sync_debug'}."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    if data.get("version") != 1:
        raise ValueError(f"devtrace dump {path}: unsupported version "
                         f"{data.get('version')!r}")
    return {"sites": dict(data.get("sites", {})),
            "fetches": dict(data.get("fetches", {})),
            "puts": dict(data.get("puts", {})),
            "syncs": dict(data.get("syncs", {})),
            "declared_syncs": int(data.get("declared_syncs", 0)),
            "sync_debug": bool(data.get("sync_debug", False))}


def _atexit_dump() -> None:  # pragma: no cover - process teardown
    out = os.environ.get("DIFACTO_JAXTRACE_OUT", "")
    if out and enabled():
        try:
            dump(out)
        except OSError as e:
            print(f"devtrace: dump to {out} failed: {e}", file=sys.stderr)


atexit.register(_atexit_dump)
