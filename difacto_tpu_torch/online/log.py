"""Append-only training log for the serve→log→train loop (counterpart of
difacto_tpu/online/log.py; the same segment bytes and index lines for the
same appends and labels).

The serve path appends every served row here; the online trainer tails
the sealed segments (online/tail.py). Three layers:

- **Live tail with a feedback join.** ``append`` enqueues each served
  row (a size-1 RowBlock straight from the serve parser) keyed by a row
  id; ``label`` joins a delayed label reported by any client speaking
  ``#label`` onto its pending row within a ``label_delay_s`` horizon. Rows resolve
  STRICTLY in arrival order — a resolved row is one whose label arrived
  or whose horizon expired — so the sealed log is a faithful temporal
  record of the served stream, not a reordering of it.
- **Horizon default.** An unlabeled row past the horizon resolves to
  the configured default: ``drop`` (excluded from training) or
  ``negative`` (label 0.0 — the standard ad-click convention: an
  impression with no click within the attribution window is a
  non-click).
- **Sealed segments.** Every ``segment_rows`` resolved rows concatenate
  into one RowBlock and seal as ``seg-NNNNNN.rec2`` through the normal
  rec2 writer (data/rec.py: page-aligned sections, per-section CRC32,
  tmp+``os.replace``) — the atomic rename IS the seal marker the tailer
  blocks on, and the segment is readable by every existing rec path
  (the trajectory-integrity contract: replaying the sealed log offline
  through the streamed trainer reproduces the online checkpoint).
  Each seal also appends one JSON line to ``log.idx.jsonl``
  (``{"seg", "rows", "ts"}``; ``ts`` is ``time.monotonic()`` —
  CLOCK_MONOTONIC is machine-wide on Linux, so the trainer process can
  subtract it from its own monotonic clock for the
  ``train_behind_serve_s`` gauge).
  ``end()`` seals the partial buffer and drops a ``log.end`` marker so
  a draining tailer terminates instead of polling forever. Stray files
  (the index, the end marker, ``*.tmp``) are invisible to rec readers —
  ``rec_members`` filters to member suffixes.

Fault points (utils/faultinject.py): ``online.log.append`` (an ``err``
surfaces to the caller — the serve path counts the drop and keeps
serving), ``online.label_join`` (an ``err`` surfaces as a typed ``!err``
reply to the reporting client), ``online.seal`` (an ``err`` keeps the
resolved buffer in memory and retries on the next advance — rows are
never lost to a transient seal failure).

Thread safety: one mutex guards all mutable state; the serve
connection threads (append/label) and any poller share it.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import time
from typing import Dict, List, Optional

import numpy as np

from ..data.rec import write_rec_block
from ..data.rowblock import RowBlock
from ..obs import counter
from ..utils import faultinject
from ..utils.locktrace import mutex

log = logging.getLogger("difacto_tpu_torch")

END_MARKER = "log.end"
INDEX_NAME = "log.idx.jsonl"
_SEG_RE = re.compile(r"^seg-(\d+)\.rec2$")

_c_logged = counter("online_rows_logged_total",
                    "served rows appended to the online training log")
_c_joined = counter("online_labels_joined_total",
                    "delayed labels joined onto a pending logged row")
_c_defaulted = counter(
    "online_label_defaults_total",
    "logged rows that passed the label_delay_s horizon unlabeled and "
    "resolved to the configured default (drop or negative)")
_c_sealed = counter("online_segments_sealed_total",
                    "training-log segments sealed (tmp+rename committed)")
_c_seal_failures = counter(
    "online_seal_failures_total",
    "segment seal attempts that failed (buffer retained, retried)")


def seg_path(log_dir: str, seg: int) -> str:
    return os.path.join(log_dir, f"seg-{seg:06d}.rec2")


def list_segments(log_dir: str) -> List[int]:
    """Sorted indices of the sealed segments present in ``log_dir``."""
    out = []
    try:
        names = os.listdir(log_dir)
    except FileNotFoundError:
        return out
    for name in names:
        m = _SEG_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def read_index(log_dir: str) -> List[Dict]:
    """Parse ``log.idx.jsonl`` — tolerant of a torn final line (the
    index is advisory freshness metadata; the rename is the seal)."""
    out: List[Dict] = []
    path = os.path.join(log_dir, INDEX_NAME)
    try:
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    log.debug("torn index line in %s: %r", path, line[:80])
    except FileNotFoundError:
        pass
    return out


class _Pending:
    __slots__ = ("rid", "blk", "t", "label")

    def __init__(self, rid: int, blk: RowBlock, t: float):
        self.rid = rid
        self.blk = blk
        self.t = t
        self.label: Optional[float] = None


class OnlineLog:
    def __init__(self, log_dir: str, segment_rows: int = 256,
                 label_delay_s: float = 1.0,
                 label_default: str = "negative"):
        if label_default not in ("drop", "negative"):
            raise ValueError(
                f"label_default={label_default!r} (want drop|negative)")
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.segment_rows = int(segment_rows)
        self.label_delay_s = float(label_delay_s)
        self.label_default = label_default
        self._mu = mutex()
        self._pending: "collections.deque[_Pending]" = collections.deque()
        self._by_id: Dict[int, _Pending] = {}
        self._buf: List[RowBlock] = []   # resolved rows awaiting a seal
        self._next_id = 0
        self._rows_logged = 0
        self._rows_dropped = 0
        self._ended = False
        # resume numbering after a restart: never overwrite a sealed seg
        segs = list_segments(log_dir)
        self._seg = (segs[-1] + 1) if segs else 0

    # ------------------------------------------------------------ serve
    def append(self, blk: RowBlock, row_id: Optional[int] = None) -> int:
        """Log one served row; returns its row id (auto-assigned when
        the client did not supply one). An injected ``err`` propagates —
        the serve path treats it like any IO failure (drop + count)."""
        if blk.size != 1:
            raise ValueError(f"online log appends single rows, got "
                             f"size={blk.size}")
        faultinject.act_default(faultinject.fire("online.log.append"))
        now = time.monotonic()
        with self._mu:
            if row_id is None:
                row_id = self._next_id
            self._next_id = max(self._next_id, row_id + 1)
            rec = _Pending(row_id, blk, now)
            self._pending.append(rec)
            # last append wins on a duplicate id: the stale entry stays
            # in arrival order but can no longer be labeled
            self._by_id[row_id] = rec
            self._rows_logged += 1
            _c_logged.inc()
        self._advance(now)
        return row_id

    def label(self, row_id: int, y: float) -> bool:
        """Join a delayed label onto its pending row. Returns False when
        the row already resolved (past horizon / sealed) or was never
        logged — the feedback channel is best-effort by design."""
        faultinject.act_default(faultinject.fire("online.label_join"))
        now = time.monotonic()
        with self._mu:
            rec = self._by_id.get(row_id)
            if rec is None or rec.label is not None:
                return False
            rec.label = float(y)
            _c_joined.inc()
        self._advance(now)
        return True

    def poll(self) -> None:
        """Advance horizon expiry without new traffic (idle streams)."""
        self._advance(time.monotonic())

    # ------------------------------------------------------------ drain
    def flush(self) -> None:
        """Force-resolve every pending row (horizon defaults applied
        immediately) and seal the partial buffer. Safe to call from a
        restarting replica — it does NOT terminate the log."""
        self._advance(time.monotonic(), force=True)
        with self._mu:
            partial = bool(self._buf)
        if partial:
            self._seal(partial=True)

    def end(self) -> None:
        """Flush, then drop the ``log.end`` marker: tailing readers
        drain the remaining sealed segments and terminate."""
        self.flush()
        with self._mu:
            if not self._ended:
                with open(os.path.join(self.log_dir, END_MARKER),
                          "w") as f:
                    # lint: ok(lock-blocking) a file's write; the sleep the
                    # analyzer reaches is through another class's write()
                    f.write("end\n")
                self._ended = True

    def stats(self) -> Dict:
        with self._mu:
            return {
                "rows_logged": self._rows_logged,
                "rows_dropped": self._rows_dropped,
                "pending": len(self._pending),
                "buffered": len(self._buf),
                "next_seg": self._seg,
            }

    # --------------------------------------------------------- internal
    def _advance(self, now: float, force: bool = False) -> None:
        """Resolve the head of the pending queue while it is resolvable
        (labeled, or past the horizon); seal on every full buffer, as
        the JAX package's log does, but with ``_mu`` released across the
        seal's fault point (its ``delay_ms`` kind sleeps)."""
        while self._resolve(now, force):
            self._seal()

    def _resolve(self, now: float, force: bool) -> bool:
        """Move resolvable rows into the buffer until it is full; True
        when a seal is due. Strict arrival order: a labeled row behind
        an unlabeled, in-horizon head waits for the head."""
        with self._mu:
            return self._resolve_locked(now, force)

    def _resolve_locked(self, now: float, force: bool) -> bool:
        while self._pending:
            rec = self._pending[0]
            if (rec.label is None and not force
                    and now - rec.t < self.label_delay_s):
                break
            self._pending.popleft()
            if self._by_id.get(rec.rid) is rec:
                del self._by_id[rec.rid]
            if rec.label is None:
                _c_defaulted.inc()
                if self.label_default == "drop":
                    self._rows_dropped += 1
                    continue
                y = 0.0
            else:
                y = rec.label
            blk = rec.blk
            self._buf.append(RowBlock(
                offset=blk.offset,
                label=np.array([y], dtype=np.float32),
                index=blk.index, value=blk.value, weight=blk.weight))
            if len(self._buf) >= self.segment_rows:
                return True
        return False

    def _seal(self, partial: bool = False) -> None:
        """Concat the resolved buffer and commit it as the next segment.
        The fault point is traversed with no lock held; the write then
        runs under ``_mu`` if the buffer is still due (another thread
        may have sealed it meanwhile). Any failure (injected or real IO)
        keeps the buffer for the next advance — a transient seal failure
        never loses rows."""
        try:
            faultinject.act_default(faultinject.fire("online.seal"))
            err = None
        except faultinject.FaultInjected as e:
            err = e
        with self._mu:
            due = (len(self._buf) >= (1 if partial else self.segment_rows))
            if due:
                # the segment write holds _mu as the JAX package's does;
                # it traverses no fault point (save_npz's fire is reached
                # only with a fault_point, which write_rec_block never
                # passes), and the seal's own point was fired above
                # lint: ok(lock-blocking) no fault point on this write
                self._seal_locked(err)

    def _seal_locked(self, err: Optional[Exception]) -> None:
        try:
            if err is not None:
                raise err
            blk = (self._buf[0] if len(self._buf) == 1
                   else RowBlock.concat(self._buf))
            write_rec_block(seg_path(self.log_dir, self._seg), blk)
        except (faultinject.FaultInjected, OSError) as e:
            _c_seal_failures.inc()
            log.warning("online log: seal of seg %d failed (%s); "
                        "buffer retained", self._seg, e)
            return
        rows = len(self._buf)
        self._buf = []
        with open(os.path.join(self.log_dir, INDEX_NAME), "a") as f:
            f.write(json.dumps({"seg": self._seg, "rows": rows,
                                "ts": time.monotonic()}) + "\n")
        _c_sealed.inc()
        self._seg += 1
