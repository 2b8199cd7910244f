"""Runtime lock-order tracing (counterpart of
difacto_tpu/utils/locktrace.py): the dynamic half of the repo's
concurrency analyzer, whose static half reads the same lock sites.

Every lock of the port is created through :func:`mutex` /
:func:`rmutex` / :func:`condition` instead of a bare
``threading.Lock()``. Disabled (the default), the factories return the
raw ``threading`` primitive: no steady-state cost, one extra function
call at construction. With ``DIFACTO_LOCKTRACE=1`` (or
``DIFACTO_RACETRACE=1``) they return a traced wrapper that keeps, per
thread, the stack of held locks and records on every successful acquire
one *acquisition-order edge* per lock already held:
``(held creation site) -> (acquired creation site)``.

A lock's identity is its **creation site** (``relpath:lineno`` of the
factory call, relative to the repo root), which is the static analyzer's
declaration site: every instance of ``self._mu = mutex()`` is one node in
both graphs, so the observed edges can be checked against the static
lock-order graph edge for edge (tests/test_torch_lint.py).

The edge store is process-global and thread-safe under its own raw lock
(a traced one would recurse). ``dump``/``load`` round-trip the edges as
JSON; ``DIFACTO_LOCKTRACE_OUT=<path>`` dumps them at process exit.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# repo root: difacto_tpu_torch/utils/locktrace.py -> two parents up from
# the package directory; creation sites are stored relative to it so
# they match the static analyzer's repo-relative paths
_ROOT = Path(__file__).resolve().parents[2]

_reg_mu = threading.Lock()          # guards _edges/_sites (raw on purpose)
_edges: Dict[Tuple[str, str], int] = {}
_sites: Dict[str, str] = {}         # site -> kind (Lock/RLock/Condition)
_tls = threading.local()


def enabled() -> bool:
    # DIFACTO_RACETRACE implies lock tracing: the shared-state access
    # tracer (utils/shared.py) records each access's held-lock stack,
    # which only exists while the factories hand out traced wrappers
    return (os.environ.get("DIFACTO_LOCKTRACE", "") not in ("", "0")
            or os.environ.get("DIFACTO_RACETRACE", "") not in ("", "0"))


def _site(depth: int = 2) -> str:
    fr = sys._getframe(depth)
    fn = fr.f_code.co_filename
    try:
        rel = Path(fn).resolve().relative_to(_ROOT).as_posix()
    except ValueError:
        rel = fn
    return f"{rel}:{fr.f_lineno}"


def _held() -> List[str]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _note_acquire(site: str) -> None:
    held = _held()
    new = []
    for h in held:
        if h != site and (h, site) not in new:
            new.append((h, site))
    if new:
        with _reg_mu:
            for e in new:
                _edges[e] = _edges.get(e, 0) + 1
    held.append(site)


def _note_release(site: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] == site:
            del held[i]
            return


class _Traced:
    """Context-manager lock wrapper stamping acquisition-order edges.
    Forwards the full Lock/RLock protocol; ``Condition(lock)`` works
    because it only needs acquire/release (the _is_owned fallback probes
    with a zero-timeout acquire)."""

    __slots__ = ("_lk", "site")

    def __init__(self, lk, site: str):
        self._lk = lk
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # the wrapper forwards the primitive's own acquire; acquire/
        # release pairing is the CALLER'S contract, checked at their site
        # lint: ok(lock-release) forwarding wrapper, pairing checked at callers
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            _note_acquire(self.site)
        return ok

    def release(self) -> None:
        self._lk.release()
        _note_release(self.site)

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> bool:
        # lint: ok(lock-release) __enter__ half of the context protocol
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def _register(site: str, kind: str) -> str:
    with _reg_mu:
        _sites.setdefault(site, kind)
    return site


def mutex():
    """``threading.Lock()``, traced when DIFACTO_LOCKTRACE=1."""
    if not enabled():
        return threading.Lock()
    return _Traced(threading.Lock(), _register(_site(), "Lock"))


def rmutex():
    """``threading.RLock()``, traced when DIFACTO_LOCKTRACE=1 (repeat
    acquisitions of one site record no self edges)."""
    if not enabled():
        return threading.RLock()
    return _Traced(threading.RLock(), _register(_site(), "RLock"))


def condition():
    """``threading.Condition`` over a (possibly traced) fresh lock."""
    if not enabled():
        return threading.Condition()
    return threading.Condition(
        _Traced(threading.Lock(), _register(_site(), "Condition")))


# ----------------------------------------------------------------- data


def edges() -> Dict[Tuple[str, str], int]:
    """Snapshot of the observed acquisition-order edges -> count."""
    with _reg_mu:
        return dict(_edges)


def sites() -> Dict[str, str]:
    with _reg_mu:
        return dict(_sites)


def reset() -> None:
    with _reg_mu:
        _edges.clear()
        _sites.clear()


def dump(path) -> str:
    """Write the observed graph as JSON; returns the path."""
    with _reg_mu:
        payload = {
            "version": 1,
            "sites": dict(sorted(_sites.items())),
            "edges": [{"src": a, "dst": b, "count": c}
                      for (a, b), c in sorted(_edges.items())],
        }
    p = Path(path)
    if p.parent and str(p.parent) not in (".", ""):
        p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=1) + "\n", encoding="utf-8")
    return str(p)


def load(path) -> dict:
    """Read a dump() file back: {'sites': {...}, 'edges': {(a,b): n}}."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    if data.get("version") != 1:
        raise ValueError(f"locktrace dump {path}: unsupported version "
                         f"{data.get('version')!r}")
    return {"sites": dict(data.get("sites", {})),
            "edges": {(e["src"], e["dst"]): int(e.get("count", 1))
                      for e in data.get("edges", [])}}


def _atexit_dump() -> None:  # pragma: no cover - process teardown
    out = os.environ.get("DIFACTO_LOCKTRACE_OUT", "")
    if out and enabled():
        try:
            dump(out)
        except OSError as e:
            print(f"locktrace: dump to {out} failed: {e}",
                  file=sys.stderr)


atexit.register(_atexit_dump)
