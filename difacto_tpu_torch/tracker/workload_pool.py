"""Scheduler-side workload pool: file-part assignment with failure handling
(counterpart of difacto_tpu/tracker/workload_pool.py).

Equivalent of the reference's WorkloadPool (src/reader/workload_pool.h:28-203)
— the host-side half of data parallelism. Parts (byte ranges of the input,
data/reader.py) are handed to nodes (hosts / pipeline threads) on request;
the pool

- re-queues the in-flight parts of a dead node (``reset``,
  workload_pool.h:88-105 Set(del=false)),
- re-issues parts running longer than max(10 x mean, straggler_timeout)
  once >= 10 completion times are known (``remove_stragglers``,
  workload_pool.h:155-176).

Thread-safe; the straggler check is called by the owner (no daemon thread —
the caller's dispatch loop invokes ``remove_stragglers`` periodically, which
keeps tests deterministic; the reference used a 2 s poller thread).
"""

from __future__ import annotations

import logging
import time as _time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

from ..config import Param
from ..utils.locktrace import mutex

log = logging.getLogger("difacto_tpu_torch")


@dataclass
class WorkloadPoolParam(Param):
    straggler_timeout: float = 0.0  # 0 disables straggler re-issue


class _Assigned(NamedTuple):
    node: int
    part: int
    start: float


class WorkloadPool:
    def __init__(self, param: Optional[WorkloadPoolParam] = None):
        self.param = param or WorkloadPoolParam()
        self._mu = mutex()
        self._avail: Dict[int, bool] = {}   # part -> available
        self._assigned: List[_Assigned] = []
        self._times: List[float] = []

    def add(self, num_parts: int) -> None:
        with self._mu:
            self._avail = {i: True for i in range(num_parts)}

    def clear(self) -> None:
        with self._mu:
            self._avail.clear()
            self._assigned.clear()
            self._times.clear()

    def get(self, node: int) -> int:
        """Next part for ``node``; -2 when nothing is available
        (GetOne, workload_pool.h:124-152)."""
        with self._mu:
            avail = [k for k, a in self._avail.items() if a]
            if not avail:
                return -2
            part = avail[0]
            self._avail[part] = False
            self._assigned.append(_Assigned(node, part, _time.monotonic()))
            return part

    def finish(self, node: int) -> None:
        """All of node's in-flight parts completed."""
        self._set(node, done=True)

    def reset(self, node: int) -> None:
        """Node died: its in-flight parts go back to the pool."""
        self._set(node, done=False)

    def reissue_dead(self, node: int) -> List[int]:
        """``reset`` for a node declared DEAD (killed worker process,
        heartbeat-evicted host): re-queue its in-flight parts, count
        them into ``tracker_parts_reissued_total{reason="dead"}`` and
        return the re-queued part ids. The re-queue itself never blocks
        — survivors pick the parts up from their own dispatch loops, so
        a bounded-delay (τ) window keeps draining while the eviction is
        handled (the reference's WorkloadPool::Reset part
        re-advertisement, workload_pool.h:88-105)."""
        with self._mu:
            requeued = [a.part for a in self._assigned if a.node == node]
        self._set(node, done=False)
        if requeued:
            from ..obs import counter
            counter("tracker_parts_reissued_total",
                    "workload parts re-queued after a node death or "
                    "straggler eviction").labels(reason="dead").inc(
                        len(requeued))
        return requeued

    def _set(self, node: int, done: bool) -> None:
        with self._mu:
            rest = []
            for a in self._assigned:
                if a.node != node:
                    rest.append(a)
                    continue
                if done:
                    self._times.append(_time.monotonic() - a.start)
                    self._avail.pop(a.part, None)
                else:
                    self._avail[a.part] = True
                    log.info("%d failed to finish part %d", node, a.part)
            self._assigned = rest

    def touch(self, node: int) -> None:
        """Refresh the assignment clocks of ``node``'s in-flight parts.
        Producers call this while back-pressured (blocked on a full consumer
        queue), so ``remove_stragglers`` measures *stall* time — a healthy
        part waiting for the consumer is not a straggler."""
        with self._mu:
            now = _time.monotonic()
            self._assigned = [a._replace(start=now) if a.node == node else a
                              for a in self._assigned]

    def num_remains(self) -> int:
        """Unfinished parts: available + in-flight, each counted once."""
        with self._mu:
            return (sum(1 for a in self._avail.values() if a)
                    + len(self._assigned))

    def remove_stragglers(self, now: Optional[float] = None) -> List[int]:
        """Re-queue parts exceeding max(10 x mean, straggler_timeout);
        needs >= 10 completion samples (RemoveStraggler,
        workload_pool.h:155-176). Returns the re-queued part ids."""
        if not self.param.straggler_timeout:
            return []
        with self._mu:
            if len(self._times) < 10:
                return []
            mean = sum(self._times) / len(self._times)
            limit = max(mean * 10, self.param.straggler_timeout)
            now = _time.monotonic() if now is None else now
            rest, requeued = [], []
            for a in self._assigned:
                if now - a.start > limit:
                    log.info("part %d on %d ran %.1fs (mean %.1fs); "
                             "re-issuing", a.part, a.node, now - a.start,
                             mean)
                    self._avail[a.part] = True
                    requeued.append(a.part)
                else:
                    rest.append(a)
            self._assigned = rest
        if requeued:
            from ..obs import counter
            counter("tracker_parts_reissued_total",
                    "workload parts re-queued after a node death or "
                    "straggler eviction").labels(reason="straggler").inc(
                        len(requeued))
        return requeued
