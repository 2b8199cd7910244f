"""Recovery ladder: local walk-back -> peer fetch -> WAL replay to head
(counterpart of difacto_tpu/durability/recover.py).

With a durability leg on (``wal_flush_batches`` / ``replica_peers``),
``auto_resume`` climbs:

    rung "local" : the newest locally verifying checkpoint generation
                   (the learner's ``_try_resume_base``)
    rung "peer"  : nothing local verifies (disk loss, a fresh host) ->
                   fetch the newest peer replica of the family and its WAL
                   chain (replicate.fetch_family), then walk back over the
                   fetched files
    rung "wal"   : replay the delta chain rooted at the loaded base
                   generation to its verified head (wal.replay)

Each failure on the way is typed and falls to the next rung; each rung
that contributes is counted in ``recovery_rung_total{rung}`` and written
to the ``<model_out>.recovery.json`` stamp (``rungs``, ``head``,
``skip_batches``, ``wal_replay_batches``, ``resumed_epoch``, ...).

The ladder returns the last COMPLETED epoch (the run restarts at the next)
and arms ``learner._wal_skip`` when the WAL head is mid-epoch: the
re-entered epoch skips the batches whose effects replay already applied,
so the run continues bit for bit as an unkilled one would (the data order
is deterministic).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from ..obs import counter
from . import replicate, wal as _wal

log = logging.getLogger("difacto_tpu_torch")


def _rung_counter():
    return counter(
        "recovery_rung_total",
        "recovery-ladder rungs that contributed to a resume, per rung "
        "(fresh = nothing recoverable, started from scratch)")


def run_ladder(learner) -> Optional[int]:
    """Climb the ladder for ``learner`` (an SGDLearner with its
    durability legs set up): restores the store, roots the learner's
    WalWriter, sets ``learner._wal_skip`` and writes the recovery stamp.
    Returns the last completed epoch (-1: WAL-only progress on a virgin
    base), or None to start fresh."""
    p = learner.param
    rungs = []
    rung_c = _rung_counter()

    got = learner._try_resume_base()
    if got is not None:
        rungs.append("local")
        rung_c.labels(rung="local").inc()

    peers = replicate.parse_peers(p.replica_peers)
    if got is None and peers:
        peer = replicate.fetch_family(p.model_out, peers)
        if peer is not None:
            got = learner._try_resume_base()
            if got is not None:
                rungs.append("peer")
                rung_c.labels(rung="peer").inc()
            else:
                log.warning("recovery: peer %s family fetched but no "
                            "generation verified locally", peer)

    if learner._wal is None:
        if got is None:
            rung_c.labels(rung="fresh").inc()
            _write_stamp(p.model_out, rungs, None, None)
            return None
        _write_stamp(p.model_out, rungs, got[0], None)
        return got[0]
    return _replay_rung(learner, got, rungs, rung_c)


def _replay_rung(learner, got, rungs, rung_c) -> Optional[int]:
    from ..utils import manifest as mft
    p = learner.param
    writer: _wal.WalWriter = learner._wal
    rank = writer.rank
    if got is not None:
        base_epoch, path = got
        man = mft.read(path) or {}
        generation = int(man.get("generation", 0))
    else:
        # a virgin base: the init table is deterministic, so a chain
        # rooted at generation 0 replays onto a fresh table
        base_epoch, generation = -1, 0
        if not _wal.chain_segments(_wal.wal_dir(p.model_out), rank, 0):
            rung_c.labels(rung="fresh").inc()
            _write_stamp(p.model_out, rungs, None, None)
            return None

    res = _wal.replay(learner.store, _wal.wal_dir(p.model_out), rank,
                      generation, base_epoch=base_epoch)
    writer.adopt(generation, res.next_seq, base_epoch)
    if res.segments:
        rungs.append("wal")
        rung_c.labels(rung="wal").inc()
        log.info("recovery: WAL replayed %d batches (%d segments) to "
                 "(epoch %d, step %d%s) on generation %d",
                 res.batches, res.segments, res.epoch, res.step,
                 ", boundary" if res.boundary else "", generation)

    if res.epoch < 0 or (res.epoch == base_epoch and res.segments == 0):
        # no delta progress past the base checkpoint
        resumed, skip = (None if base_epoch < 0 else base_epoch), 0
    elif res.boundary:
        # the head closes its epoch: a completed epoch
        resumed, skip = res.epoch, 0
    else:
        # a mid-epoch head: re-enter epoch res.epoch, skipping the batches
        # replay applied
        resumed = res.epoch - 1 if res.epoch > 0 else -1
        skip = res.step
    learner._wal_skip = skip
    if not rungs and resumed is None:
        rung_c.labels(rung="fresh").inc()
    _write_stamp(p.model_out, rungs, resumed, res, skip)
    return resumed


def _write_stamp(model_out: str, rungs, resumed, res,
                 skip: int = 0) -> None:
    """``<model_out>.recovery.json``: how the last resume came back."""
    doc = {"rungs": rungs, "resumed_epoch": resumed}
    if res is not None:
        doc.update(base_generation=res.generation,
                   wal_replay_batches=res.batches,
                   wal_segments=res.segments,
                   head={"epoch": res.epoch, "step": res.step,
                         "boundary": res.boundary},
                   stopped=res.stopped, skip_batches=skip)
    tmp = model_out + ".recovery.json.tmp"
    try:
        os.makedirs(os.path.dirname(model_out) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True)
        os.replace(tmp, model_out + ".recovery.json")
    except OSError as e:
        log.warning("recovery stamp write failed: %s", e)
