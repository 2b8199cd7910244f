"""Progress reporter: the out-of-band node -> scheduler channel
(counterpart of difacto_tpu/utils/reporter.py; the reference's Reporter,
include/difacto/reporter.h:14-56).

Components call ``report(payload)``; whoever set the monitor receives it,
so the serving stats and their consumer stay decoupled. ``every``
throttles delivery to every n-th report (the reference's servers report
every 50 pushes, include/difacto/store.h:118-123).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .locktrace import mutex


class Reporter:
    def __init__(self, every: int = 1):
        self._monitor: Optional[Callable[[int, Any], None]] = None
        self._mu = mutex()
        self._count = 0
        self._every = max(every, 1)

    def set_monitor(self, fn: Callable[[int, Any], None]) -> None:
        """fn(node_id, payload)."""
        with self._mu:
            self._monitor = fn

    def report(self, payload: Any, node_id: int = 0) -> int:
        """Deliver payload to the monitor (throttled); returns a sequence
        number like the reference's report timestamp."""
        with self._mu:
            self._count += 1
            seq = self._count
            monitor = self._monitor
        if monitor is not None and seq % self._every == 0:
            monitor(node_id, payload)
        return seq
