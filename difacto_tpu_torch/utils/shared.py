"""Runtime shared-state access tracing (counterpart of
difacto_tpu/utils/shared.py): the dynamic half of the repo's race
analyzer, beside locktrace.py's lock-order half.

Classes whose fields the static model marks guarded (or deliberately
suppresses) opt in by declaring the field through :func:`attr` in the
class body::

    class MicroBatcher:
        _rows_queued = shared.attr()
        _alive = shared.attr()

Disabled (the default), :func:`attr` returns ``None``: the class
attribute is an inert placeholder that ``self._rows_queued = 0`` in
``__init__`` shadows with a plain instance attribute, at no cost. With
``DIFACTO_RACETRACE=1`` (read when the class is defined, at import) it
returns a data descriptor that keeps the value under a private slot and
runs Eraser's per-field state machine on every get and set:

- **exclusive**: only the first thread has touched the field
  (construction; these accesses never constrain the lockset);
- **shared**: a second thread has touched it; from here the field's
  candidate lockset is intersected with the locks held at each access
  (locktrace's per-thread held stack: RACETRACE turns lock tracing on);
- **shared-modified**: a write after sharing began. A shared-modified
  field whose candidate lockset is empty is a race alarm.

``DIFACTO_RACETRACE_SAMPLE=n`` processes every n-th access per field.

A field's identity is ``relpath::Class.attr``, the static shared-state
index's, so a test can hold every alarm to a field the static model
suppresses with a reason. ``DIFACTO_RACETRACE_OUT=<path>`` dumps the
field states as JSON at process exit.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from pathlib import Path
from typing import Dict, FrozenSet, Optional, Set

from . import locktrace

_ROOT = Path(__file__).resolve().parents[2]

EXCLUSIVE = "exclusive"
SHARED = "shared"
SHARED_MODIFIED = "shared-modified"


class FieldState:
    """One field's Eraser state (see module docstring)."""

    __slots__ = ("first_tid", "state", "lockset", "tids", "accesses")

    def __init__(self, tid: int):
        self.first_tid = tid
        self.state = EXCLUSIVE
        self.lockset: Optional[FrozenSet[str]] = None  # None until shared
        self.tids: Set[int] = {tid}
        self.accesses = 0


_reg_mu = threading.Lock()        # guards _fields (raw on purpose)
# field -> instance id -> state. Eraser's machine runs per OBJECT: two
# MicroBatcher instances each have their own exclusive/shared life, so
# instance B's construction (another thread, no lock) must not empty
# instance A's candidate lockset. Reporting aggregates per field.
# (Instance identity is id(obj): entries outlive their objects, and an
# id reused after GC merges histories — fine for a test sentinel.)
_fields: Dict[str, Dict[int, FieldState]] = {}


def enabled() -> bool:
    return os.environ.get("DIFACTO_RACETRACE", "") not in ("", "0")


def _sample_every() -> int:
    try:
        return max(1, int(os.environ.get("DIFACTO_RACETRACE_SAMPLE",
                                         "1") or 1))
    except ValueError:
        return 1


def _note(fid: str, oid: int, write: bool) -> None:
    tid = threading.get_ident()
    held = frozenset(locktrace._held())
    n = _sample_every()
    with _reg_mu:
        insts = _fields.setdefault(fid, {})
        st = insts.get(oid)
        if st is None:
            st = insts[oid] = FieldState(tid)
        st.accesses += 1
        if n > 1 and (st.accesses - 1) % n:
            return
        st.tids.add(tid)
        if st.state == EXCLUSIVE:
            if tid == st.first_tid:
                return          # construction: unconstrained
            st.state = SHARED
        st.lockset = held if st.lockset is None else (st.lockset & held)
        if write:
            st.state = SHARED_MODIFIED


class _TracedAttr:
    """Data descriptor recording every get/set of one opted-in field.
    Takes precedence over the instance ``__dict__`` (that is what makes
    it a data descriptor), so the value lives under a private slot."""

    __slots__ = ("name", "slot", "field")

    def __set_name__(self, owner, name: str) -> None:
        self.name = name
        self.slot = f"_shared${name}"
        mod = sys.modules.get(owner.__module__)
        fn = getattr(mod, "__file__", "") or ""
        try:
            rel = Path(fn).resolve().relative_to(_ROOT).as_posix()
        except ValueError:
            rel = fn
        self.field = f"{rel}::{owner.__qualname__}.{name}"

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        _note(self.field, id(obj), False)
        try:
            return obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj, value) -> None:
        _note(self.field, id(obj), True)
        obj.__dict__[self.slot] = value

    def __delete__(self, obj) -> None:
        _note(self.field, id(obj), True)
        try:
            del obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None


def attr():
    """Class-body field declaration (see module docstring). ``None``
    placeholder when disabled; a traced descriptor when
    DIFACTO_RACETRACE=1 was set before the class was defined."""
    if not enabled():
        return None
    return _TracedAttr()


# ------------------------------------------------------------------ data


_RANK = {EXCLUSIVE: 0, SHARED: 1, SHARED_MODIFIED: 2}


def fields() -> Dict[str, dict]:
    """Snapshot: field -> aggregated state record over its instances.
    ``state`` is the worst instance's; ``lockset`` is [] if ANY
    shared(-modified) instance emptied its candidate set (the alarm
    condition), else the intersection over shared instances; ``threads``
    is the busiest instance's count; ``instances`` rides along."""
    with _reg_mu:
        out: Dict[str, dict] = {}
        for f, insts in _fields.items():
            worst = max(insts.values(), key=lambda s: _RANK[s.state])
            lockset = None
            for st in insts.values():
                if st.state == EXCLUSIVE or st.lockset is None:
                    continue
                lockset = st.lockset if lockset is None \
                    else (lockset & st.lockset)
            out[f] = {
                "state": worst.state,
                "threads": max(len(s.tids) for s in insts.values()),
                "accesses": sum(s.accesses for s in insts.values()),
                "instances": len(insts),
                "lockset": (sorted(lockset)
                            if lockset is not None else None),
            }
        return out


def shared_fields() -> Dict[str, dict]:
    """Fields observed from >= 2 threads (state left ``exclusive``) —
    what the tier-1 gate checks against the static model."""
    return {f: rec for f, rec in fields().items()
            if rec["state"] != EXCLUSIVE}


def alarms() -> Dict[str, dict]:
    """Dynamic race alarms: shared-modified fields whose candidate
    lockset emptied — Eraser's report condition."""
    return {f: rec for f, rec in fields().items()
            if rec["state"] == SHARED_MODIFIED and rec["lockset"] == []}


def reset() -> None:
    with _reg_mu:
        _fields.clear()


def dump(path) -> str:
    """Write the field states as JSON; returns the path."""
    payload = {"version": 1, "fields": dict(sorted(fields().items()))}
    p = Path(path)
    if p.parent and str(p.parent) not in (".", ""):
        p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=1) + "\n", encoding="utf-8")
    return str(p)


def load(path) -> Dict[str, dict]:
    """Read a dump() file back into the fields() shape."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    if data.get("version") != 1:
        raise ValueError(f"racetrace dump {path}: unsupported version "
                         f"{data.get('version')!r}")
    return dict(data.get("fields", {}))


def _atexit_dump() -> None:  # pragma: no cover - process teardown
    out = os.environ.get("DIFACTO_RACETRACE_OUT", "")
    if out and enabled():
        try:
            dump(out)
        except OSError as e:
            print(f"racetrace: dump to {out} failed: {e}",
                  file=sys.stderr)


atexit.register(_atexit_dump)
