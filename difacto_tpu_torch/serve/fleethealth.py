"""Shared endpoint health: one blacklist file the whole fleet reads
(counterpart of difacto_tpu/serve/fleethealth.py, the same file format,
so clients of both packages share one file).

Without it, endpoint health is private per client: every ``ServeClient``
re-discovers a dead replica through its own consecutive-failure ejection
— N clients x ``eject_after`` failed connects per bad replica, each
paying the timeout. This module makes the first discovery fleet-wide:
whoever ejects an endpoint appends a ``down`` mark to a shared
**append-only, advisory-locked** file, and every other reader skips that
endpoint without ever dialing it.

Design constraints, in order:

- **Crash-safe under concurrent writers.** Marks are single JSON lines
  appended under ``fcntl.flock(LOCK_EX)`` with ``O_APPEND``; a writer
  dying mid-line can at worst leave one torn tail line, which readers
  skip (and the next compaction drops). There is no read-modify-write of
  shared state — the file is a log, the state is the fold over it.
- **Self-clearing.** A ``down`` mark carries its wall-clock timestamp and
  only suppresses the endpoint for ``down_s`` seconds — the same timed
  re-probe contract as the in-memory ejection (the first use after the
  window IS the probe). A client whose probe succeeds appends a ``clear``
  mark so the whole fleet un-ejects early instead of each waiting out its
  own copy of the window.
- **Bounded.** Past ``max_bytes`` the appender compacts under the same
  lock: the log is folded and rewritten (atomic rename) with only the
  marks that still matter.
- **Advisory everywhere.** A reader never blocks a writer and malformed
  or stale files degrade to "nothing is down" — shared health is an
  optimization over per-client discovery, never a correctness
  dependency (clients keep their own ejection state regardless).

Wall-clock (`time.time`) timestamps are deliberate: the file is shared
across processes (and potentially hosts over a shared filesystem), where
monotonic clocks don't compare.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import time
from typing import Dict, Optional, Tuple

try:
    from ..utils.locktrace import mutex
except ImportError:
    # tests/fleethealth_worker.py loads this file standalone (no
    # package) to drive two-process concurrent writers
    from threading import Lock as mutex

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

log = logging.getLogger("difacto_tpu_torch")

Endpoint = Tuple[str, int]


def _key(host: str, port: int) -> str:
    return f"{host}:{int(port)}"


class FleetHealth:
    """Reader/writer handle on one shared blacklist file.

    ``mark_down``/``mark_up`` append; ``down_endpoints``/``is_down``/
    ``down_remaining`` fold the log (cached on (mtime, size) so polling
    per connect attempt costs a stat, not a read). The file appears on
    first write — constructing a handle never touches the filesystem, so
    a client can be pointed at a path that no process has written yet.
    """

    def __init__(self, path: str, down_s: float = 5.0,
                 max_bytes: int = 256 * 1024):
        self.path = path
        self.down_s = down_s
        self.max_bytes = max_bytes
        # one handle is polled from every router/client thread: the
        # fold cache must swap (stamp, cache) atomically or a reader
        # can pair a fresh stamp with a stale fold
        self._cache_mu = mutex()
        self._cache_stamp: Optional[Tuple[float, int]] = None
        self._cache: Dict[str, Tuple[str, float]] = {}  # key -> (op, ts)

    # ---------------------------------------------------------- writing
    def _append(self, op: str, host: str, port: int) -> None:
        # wall clock by design: marks are compared across PROCESSES and
        # hosts through a shared file; monotonic clocks do not compare
        rec = json.dumps(
            {"ts": round(time.time(), 3),  # lint: ok(wall-clock)
             "op": op, "ep": _key(host, port), "pid": os.getpid()},
            separators=(",", ":")) + "\n"
        # open-then-lock can race a peer's compaction: if the path was
        # os.replace()d while we waited on the OLD inode's lock, our
        # append would land on the orphan and vanish — so after locking,
        # verify the fd still names the path, else reopen
        for _attempt in range(5):
            try:
                # O_RDWR (not O_WRONLY): the torn-tail check below
                # reads; O_APPEND still forces every write to the end
                fd = os.open(self.path,
                             os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
            except OSError as e:  # pragma: no cover - unwritable path
                log.warning("fleethealth: cannot open %s: %s",
                            self.path, e)
                return
            try:
                if fcntl is not None:
                    fcntl.flock(fd, fcntl.LOCK_EX)
                try:
                    if os.fstat(fd).st_ino != os.stat(self.path).st_ino:
                        continue   # compacted under us; reopen fresh
                except OSError:
                    continue       # path vanished entirely; recreate
                # heal a torn tail: a writer that died mid-append left
                # no newline, and appending onto it would glue THIS
                # record into the garbage line too — one leading newline
                # contains the damage to the dead writer's line
                size = os.fstat(fd).st_size
                if size > 0 and os.pread(fd, 1, size - 1) != b"\n":
                    os.write(fd, b"\n")
                os.write(fd, rec.encode())
                if os.fstat(fd).st_size > self.max_bytes:
                    self._compact_locked()
                return
            except OSError as e:  # pragma: no cover - disk full etc.
                log.warning("fleethealth: append to %s failed: %s",
                            self.path, e)
                return
            finally:
                os.close(fd)   # closing drops the flock

    def mark_down(self, host: str, port: int) -> None:
        """Record a consecutive-failure ejection for the whole fleet."""
        self._append("down", host, port)

    def mark_up(self, host: str, port: int) -> None:
        """A probe succeeded: clear the endpoint fleet-wide, early."""
        self._append("clear", host, port)

    def _compact_locked(self) -> None:
        """Rewrite the log as its fold (atomic rename), caller holds the
        lock. Only currently-down marks survive; clears and expired downs
        are the compactible majority."""
        downs = self._fold(self._read_lines())
        now = time.time()  # lint: ok(wall-clock) cross-process file ts
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for ep, (op, ts) in downs.items():
                if op == "down" and now - ts < self.down_s:
                    f.write(json.dumps(
                        {"ts": ts, "op": "down", "ep": ep,
                         "pid": os.getpid()},
                        separators=(",", ":")) + "\n")
        os.replace(tmp, self.path)
        with self._cache_mu:
            self._cache_stamp = None

    # ---------------------------------------------------------- reading
    def _read_lines(self) -> list:
        try:
            with open(self.path, "rb") as f:
                return f.read().splitlines()
        except OSError as e:
            if e.errno != errno.ENOENT:  # pragma: no cover
                log.warning("fleethealth: read %s failed: %s",
                            self.path, e)
            return []

    @staticmethod
    def _fold(lines: list) -> Dict[str, Tuple[str, float]]:
        """Latest mark per endpoint; torn/garbage lines are skipped (a
        writer may have died mid-append — the log survives it)."""
        state: Dict[str, Tuple[str, float]] = {}
        for ln in lines:
            try:
                rec = json.loads(ln)
                state[rec["ep"]] = (rec["op"], float(rec["ts"]))
            except (ValueError, KeyError, TypeError):
                continue
        return state

    def _state(self) -> Dict[str, Tuple[str, float]]:
        try:
            st = os.stat(self.path)
            stamp = (st.st_mtime, st.st_size)
        except OSError:
            with self._cache_mu:
                self._cache_stamp, self._cache = None, {}
                return self._cache
        with self._cache_mu:
            if stamp != self._cache_stamp:
                self._cache = self._fold(self._read_lines())
                self._cache_stamp = stamp
            return self._cache

    def down_endpoints(self) -> Dict[str, float]:
        """{'host:port': seconds_remaining} for every endpoint currently
        suppressed — a `down` mark younger than ``down_s`` with no later
        `clear`."""
        now = time.time()  # lint: ok(wall-clock) cross-process file ts
        out: Dict[str, float] = {}
        for ep, (op, ts) in self._state().items():
            remaining = self.down_s - (now - ts)
            if op == "down" and remaining > 0:
                out[ep] = remaining
        return out

    def stamp(self) -> Optional[Tuple[float, int]]:
        """The file's current ``(mtime, size)`` — one os.stat, no read.
        Long-lived holders (ServeClient) compare stamps per endpoint
        selection and re-fold only on change, so marks written AFTER
        they connected still reach them."""
        try:
            st = os.stat(self.path)
            return (st.st_mtime, st.st_size)
        except OSError:
            return None

    def down_remaining(self, host: str, port: int) -> float:
        """Seconds the endpoint stays suppressed (0.0 = not down)."""
        return self.down_endpoints().get(_key(host, port), 0.0)

    def is_down(self, host: str, port: int) -> bool:
        return self.down_remaining(host, port) > 0.0


def open_blacklist(blacklist, down_s: float = 5.0) -> Optional[FleetHealth]:
    """Coerce a constructor argument — None | path str | FleetHealth —
    into a handle."""
    if blacklist is None or isinstance(blacklist, FleetHealth):
        return blacklist
    return FleetHealth(str(blacklist), down_s=down_s)
