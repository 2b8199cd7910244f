"""Tailing segment reader: blocks on the next seal (counterpart of
difacto_tpu/online/tail.py).

The online trainer consumes the training log one sealed segment at a
time. A segment's seal marker is the segment file itself — rec2 writes
commit with tmp+``os.replace`` (data/rec.py), so ``seg-NNNNNN.rec2``
either exists complete or not at all; the tailer never sees a torn
member. The iterator yields ``(seg_index, path)`` in order and, when
the next segment has not sealed yet, polls until one of:

- the segment appears (the normal tail case);
- ``log.end`` exists and the segment still does not (the writer
  terminated the log; the end marker is written AFTER the final seal,
  so re-checking the segment first makes the hand-off race-free);
- ``replay=True`` (offline replay over a finished prefix: stop at the
  first gap instead of waiting — the trajectory-integrity path);
- the caller's ``stop`` event is set, or ``max_seconds`` elapsed.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterator, Optional, Tuple

from .log import END_MARKER, seg_path


class TailReader:
    def __init__(self, log_dir: str, start_seg: int = 0,
                 poll_s: float = 0.05, replay: bool = False,
                 max_seconds: float = 0.0,
                 stop: Optional[threading.Event] = None):
        self.log_dir = log_dir
        self.start_seg = int(start_seg)
        self.poll_s = float(poll_s)
        self.replay = replay
        self.max_seconds = float(max_seconds)
        self.stop = stop

    def _ended(self) -> bool:
        return os.path.exists(os.path.join(self.log_dir, END_MARKER))

    def __iter__(self) -> Iterator[Tuple[int, str]]:
        seg = self.start_seg
        deadline = (time.monotonic() + self.max_seconds
                    if self.max_seconds > 0 else None)
        while True:
            path = seg_path(self.log_dir, seg)
            if os.path.exists(path):
                yield seg, path
                seg += 1
                continue
            if self.replay or self._ended():
                # the end marker lands after the final seal, but both
                # can land between the exists() above and the end check:
                # look once more before calling it the end of the log
                if os.path.exists(path):
                    continue
                return
            if self.stop is not None and self.stop.is_set():
                return
            if deadline is not None and time.monotonic() >= deadline:
                return
            time.sleep(self.poll_s)
