"""Log-tailing online trainer (counterpart of
difacto_tpu/online/trainer.py).

Drives the port's :class:`SGDLearner` through its streamed epoch
machinery (``_run_epoch`` → producer pool → device steps), with one
sealed log segment as the epoch: the tailing reader (online/tail.py)
blocks on the next seal, the trainer points ``data_in`` at that one
segment file and runs one training pass over it. Segment files are
ordinary rec2 members and each pass runs with ``shuffle=0`` and one job,
so replaying the same sealed log offline (``online_replay=1``) issues the
identical sequence of ``_run_epoch(seg, ...)`` calls over the identical
bytes, and the per-row sums of ops/segment.py are ordered: the replayed
checkpoint equals the online one byte for byte.

Checkpoints follow the wall clock (``online_ckpt_interval_s``) through the
learner's ``_save_checkpoint`` (table with optimizer state, manifest, the
``.meta`` marker last, ``ckpt_keep`` pruning). Crash recovery is
``auto_resume``: the epoch it resumes is the last trained-through
segment, so tailing restarts at the next one.

Freshness gauges (process-global registry, so they ride an in-process
server's ``#metrics`` and the trainer's ``metrics_path`` JSONL):

- ``train_behind_serve_s`` — seconds the oldest sealed-but-untrained
  segment has waited (0 once trained through the newest seal); seal
  times are CLOCK_MONOTONIC, written by the logging process into
  ``log.idx.jsonl``;
- ``online_rows_behind`` — rows in sealed segments not yet trained.

Each committed generation is pushed to the serving endpoints
(online/loop.py) so the served ``model_generation`` advances.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

from ..config import KWArgs, parse_endpoints
from ..obs import gauge
from .log import read_index
from .tail import TailReader
from ..utils.locktrace import mutex

log = logging.getLogger("difacto_tpu_torch")

_g_behind_s = gauge(
    "train_behind_serve_s",
    "seconds the oldest sealed-but-untrained log segment has waited "
    "(0 = trained through the newest seal)")
_g_rows_behind = gauge(
    "online_rows_behind",
    "rows in sealed log segments the online trainer has not trained yet")


class OnlineTrainer:
    def __init__(self, param, learner_kwargs: KWArgs, device="cuda"):
        self.param = param
        # one SEGMENT FILE per pass: rec format, one job, no shuffle
        # (batch order = arrival order), no replay cache (every segment
        # is new data). Appended after the caller's kwargs so they win.
        forced = [("data_format", "rec"), ("num_jobs_per_epoch", "1"),
                  ("shuffle", "0"), ("device_cache_mb", "0"),
                  ("data_in", param.online_log_dir)]
        from ..learners.base import Learner
        self.learner = Learner.create("sgd", device=device)
        self.leftover = self.learner.init(list(learner_kwargs) + forced)
        self._mu = mutex()
        self._trained_through = -1
        self._generations = 0
        self._stop = threading.Event()

    # ------------------------------------------------------------ state
    def stop(self) -> None:
        """Ask the tail loop to exit after the current segment."""
        self._stop.set()

    def trained_through(self) -> int:
        with self._mu:
            return self._trained_through

    def generations(self) -> int:
        with self._mu:
            return self._generations

    # ------------------------------------------------------------- run
    def run(self) -> int:
        """Tail the log until it ends (``log.end``), the replay prefix
        drains, ``online_max_seconds`` elapses, or :meth:`stop`. Returns
        the last trained-through segment (-1 = none)."""
        from ..learners.sgd import K_TRAINING
        from ..utils.progress import Progress
        op = self.param
        ln = self.learner
        p = ln.param
        if not p.model_out:
            raise ValueError("task=online needs model_out")
        endpoints = (parse_endpoints(op.online_endpoints)
                     if op.online_endpoints else [])
        ln._init_run_state()
        start_seg = 0
        if p.auto_resume:
            resumed = ln._try_resume()
            if resumed is not None:
                start_seg = resumed + 1
                log.info("online: auto-resumed through segment %d",
                         resumed)
        trained = start_seg - 1
        last_saved = trained
        last_ckpt = time.monotonic()
        tail = TailReader(op.online_log_dir, start_seg=start_seg,
                          poll_s=op.online_poll_s,
                          replay=op.online_replay,
                          max_seconds=op.online_max_seconds,
                          stop=self._stop)
        for seg, path in tail:
            # the segment index is the epoch, so epoch-derived behaviour
            # (the count push on epoch 0 only) matches a replay
            ln.param.data_in = path
            prog = Progress()
            ln._run_epoch(seg, K_TRAINING, prog)
            trained = seg
            with self._mu:
                self._trained_through = seg
            self._update_freshness(trained)
            log.info("online: segment %d trained (%s)", seg, prog.text())
            now = time.monotonic()
            if (op.online_ckpt_interval_s > 0
                    and now - last_ckpt >= op.online_ckpt_interval_s):
                self._commit(trained, endpoints)
                last_saved = trained
                last_ckpt = time.monotonic()
        if trained > last_saved:
            # commit the tail so nothing trained is lost and the fleet
            # serves the final state
            self._commit(trained, endpoints)
        self._update_freshness(trained)
        log.info("online: done, trained through segment %d", trained)
        ln.store.save(ln._model_name(p.model_out, -1), p.has_aux)
        if ln.store.hashed:
            ln.store.publish_shard_stats()
        ln.stop()
        return trained

    # --------------------------------------------------------- internal
    def _commit(self, seg: int, endpoints: List[Tuple[str, int]]) -> None:
        """One committed generation: the verified checkpoint, then a
        best-effort push to the endpoints."""
        ln = self.learner
        ln._save_checkpoint(seg)
        with self._mu:
            self._generations += 1
        if endpoints:
            from .loop import push_reload
            push_reload(endpoints, ln.param.model_out + f"_iter-{seg}")

    def _update_freshness(self, trained: int) -> None:
        behind_rows = 0
        oldest_ts: Optional[float] = None
        for entry in read_index(self.param.online_log_dir):
            try:
                seg, rows, ts = (int(entry["seg"]), int(entry["rows"]),
                                 float(entry["ts"]))
            except (KeyError, TypeError, ValueError):
                continue
            if seg > trained:
                behind_rows += rows
                if oldest_ts is None or ts < oldest_ts:
                    oldest_ts = ts
        behind_s = (max(0.0, time.monotonic() - oldest_ts)
                    if oldest_ts is not None else 0.0)
        _g_behind_s.set(behind_s)
        _g_rows_behind.set(float(behind_rows))
