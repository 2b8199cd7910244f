"""Peer replication of checkpoint families and their live WAL chains
(counterpart of difacto_tpu/durability/replicate.py).

After each verified commit, the family files of ``model_out`` (interval
checkpoints and manifests, the ``.meta`` progress stub) and its live WAL
segments are pushed asynchronously to ``replica_k`` of the
``replica_peers`` directories, off the step path. A peer is a directory: a
shared filesystem path or a mount of another host's disk. A file keeps its
path relative to the model's directory at the peer, so
:func:`fetch_family` can restore a lost local directory byte for byte and
the recovery ladder (durability/recover.py) resumes from it as from a
local checkpoint.

Every copy is tmp + atomic rename with a sha256 readback, so a peer never
shows a torn file at its final name. :meth:`Replicator.scrub` verifies
what a peer holds (npz members against their manifests, WAL segments
through their CRCs, sidecars byte for byte) and pushes again what is
missing or corrupt (``replica_scrub_repairs_total``). Staleness is the
``replica_lag_generations{peer}`` gauge: committed generations a peer has
not finished receiving.

Pushes traverse the ``replica.push`` fault point and fetches
``replica.fetch`` (utils/faultinject.py).
"""

from __future__ import annotations

import glob
import hashlib
import logging
import os
import shutil
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..obs import counter, gauge
from ..utils import faultinject
from ..utils import manifest as mft
from . import wal as _wal
from ..utils.locktrace import condition

log = logging.getLogger("difacto_tpu_torch")


def parse_peers(spec: str) -> List[str]:
    """``replica_peers`` -> peer directories (comma-separated, blanks
    dropped)."""
    return [p.strip() for p in spec.split(",") if p.strip()]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def push_file(src: str, peer: str, root: str) -> str:
    """Copy one file to ``peer`` at its path relative to ``root``: tmp,
    sha256 readback, rename. ``replica.push``: ``err`` is a failed copy
    (the caller counts it and the scrub repairs it later), ``truncate``
    lands a half-length file at the final name, the torn copy the scrub
    must catch."""
    kind = faultinject.fire("replica.push")
    if kind is not None and kind != "truncate":
        faultinject.act_default(kind)
    dst = os.path.join(peer, os.path.relpath(src, root))
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    tmp = dst + ".tmp"
    if kind == "truncate":
        with open(src, "rb") as f:
            buf = f.read()
        with open(tmp, "wb") as f:
            f.write(buf[:max(len(buf) // 2, 1)])
        os.replace(tmp, dst)
        return dst
    want = _sha256(src)
    shutil.copyfile(src, tmp)
    if _sha256(tmp) != want:
        os.remove(tmp)
        raise OSError(f"replica copy of {src} to {peer} failed readback")
    os.replace(tmp, dst)
    return dst


def fetch_file(peer: str, rel: str, root: str) -> str:
    """Copy ``peer``'s ``rel`` back under the local ``root`` (tmp +
    rename; the recovery ladder verifies the fetched family through the
    same manifest and CRC gates a local one passes). ``replica.fetch``:
    ``err`` is a dead peer or a failed read, raised so the ladder tries
    the next peer."""
    faultinject.act_default(faultinject.fire("replica.fetch"))
    src = os.path.join(peer, rel)
    dst = os.path.join(root, rel)
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    tmp = dst + ".tmp"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)
    return dst


def family_files(model_out: str) -> List[str]:
    """Every local file of ``model_out``'s durable state: interval
    checkpoints and manifests, the ``.meta`` stub, the recovery stamp and
    the live WAL segments; the unit of replication and of fetch."""
    out = sorted(glob.glob(model_out + "_iter-*")) \
        + sorted(glob.glob(model_out + ".meta")) \
        + sorted(glob.glob(model_out + ".recovery.json"))
    d = _wal.wal_dir(model_out)
    if os.path.isdir(d):
        out += sorted(os.path.join(d, n) for n in os.listdir(d)
                      if n.endswith(_wal.SUFFIX))
    return out


def fetch_family(model_out: str, peers: Sequence[str]) -> Optional[str]:
    """Restore ``model_out``'s family from the peer holding the newest
    generation (ties: the later path). Returns the peer used, or None. A
    failed file (FaultInjected, OSError) fails that peer and the next one
    is tried."""
    root = os.path.dirname(model_out) or "."
    base = os.path.basename(model_out)
    ranked: List[Tuple[int, str]] = []
    for peer in peers:
        try:
            names = os.listdir(peer)
        except OSError:
            continue
        gen = -1
        for n in names:
            if n.startswith(base + "_iter-") \
                    and n.endswith(mft.MANIFEST_SUFFIX):
                man = mft.read(os.path.join(
                    peer, n[:-len(mft.MANIFEST_SUFFIX)]))
                if man:
                    gen = max(gen, int(man.get("generation", 0)))
        if gen >= 0:
            ranked.append((gen, peer))
    ranked.sort(reverse=True)
    fetch_fail = counter(
        "replica_fetch_failures_total",
        "files a recovery fetch failed to pull from a peer")
    for _, peer in ranked:
        rels = [n for n in os.listdir(peer)
                if n.startswith(base + "_iter-") or n == base + ".meta"]
        wdir = os.path.join(peer, base + ".wal")
        if os.path.isdir(wdir):
            rels += [os.path.join(base + ".wal", n)
                     for n in os.listdir(wdir) if n.endswith(_wal.SUFFIX)]
        ok = True
        for rel in sorted(rels):
            try:
                fetch_file(peer, rel, root)
            except OSError as e:   # FaultInjected is an OSError
                fetch_fail.inc()
                log.warning("replica fetch of %s from %s failed: %s; "
                            "trying the next peer", rel, peer, e)
                ok = False
                break
        if ok and rels:
            log.info("recovered %d family files for %s from peer %s",
                     len(rels), model_out, peer)
            return peer
    return None


class Replicator:
    """The async push worker: the learner enqueues (files, generation,
    epoch) after each verified commit and WAL append; one daemon thread
    drains the queue and copies to ``k`` peers, never holding the lock
    across IO. ``close()`` drains and joins."""

    def __init__(self, peers: Sequence[str], k: int, rank: int,
                 root: str):
        self.peers = list(peers)
        self.k = max(1, min(int(k), len(self.peers)) if self.peers
                     else int(k))
        self.rank = rank
        self.root = root or "."
        self._cv = condition()
        self._queue: List[Tuple[List[str], int, Optional[int]]] = []
        self._inflight_epochs: Set[int] = set()
        self._closed = False
        self._enqueued_gen = 0
        self._pushed_gen: Dict[str, int] = {p: 0 for p in self.peers}
        self._push_fail = counter(
            "replica_push_failures_total",
            "files an async replica push failed to land on a peer")
        self._lag = gauge(
            "replica_lag_generations",
            "committed generations a replica peer has not finished "
            "receiving (0 = caught up)")
        self._thread = threading.Thread(
            target=self._run, name=f"replica-push-r{rank}", daemon=True)
        self._thread.start()

    def push(self, files: Iterable[str], generation: int = 0,
             epoch: Optional[int] = None) -> None:
        """Enqueue files for replication; the copy runs on the worker."""
        files = [f for f in files if os.path.exists(f)]
        if not files or not self.peers:
            return
        with self._cv:
            self._queue.append((files, generation, epoch))
            if epoch is not None:
                self._inflight_epochs.add(epoch)
            self._enqueued_gen = max(self._enqueued_gen, generation)
            self._update_lag_locked()
            self._cv.notify()

    def protected_epochs(self) -> Set[int]:
        """Epochs with queued or in-flight pushes: ``ckpt_keep`` pruning
        leaves them while a peer is still receiving them."""
        with self._cv:
            return set(self._inflight_epochs)

    def flush(self, timeout: float = 30.0) -> bool:
        """Wait until the queue drains (True) or ``timeout`` passes."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._queue and not self._inflight_epochs,
                timeout=timeout)

    def close(self, timeout: float = 30.0) -> None:
        self.flush(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=timeout)

    def scrub(self, model_out: str) -> int:
        """Anti-entropy: verify every family file at every peer and push
        again what is missing or fails. Returns the repairs (also
        ``replica_scrub_repairs_total``)."""
        repairs = 0
        repair_c = counter(
            "replica_scrub_repairs_total",
            "peer replica files re-pushed by the anti-entropy scrub")
        for src in family_files(model_out):
            rel = os.path.relpath(src, self.root)
            for peer in self.peers[:self.k]:
                if self._peer_copy_ok(src, os.path.join(peer, rel)):
                    continue
                try:
                    push_file(src, peer, self.root)
                    repairs += 1
                    repair_c.inc()
                except OSError as e:
                    self._push_fail.inc()
                    log.warning("scrub re-push of %s to %s failed: %s",
                                rel, peer, e)
        return repairs

    def _peer_copy_ok(self, src: str, dst: str) -> bool:
        if not os.path.exists(dst):
            return False
        # a checkpoint (it has a manifest locally) gets the digest check a
        # loader applies
        if not src.endswith(mft.MANIFEST_SUFFIX) \
                and os.path.exists(src + mft.MANIFEST_SUFFIX):
            try:
                mft.verify(dst, require_manifest=True)
                return True
            except (mft.CheckpointCorrupt, OSError):
                return False
        if dst.endswith(_wal.SUFFIX):
            try:
                _wal.read_segment(dst)
                return True
            except (_wal.WalCorrupt, OSError):
                return False
        try:
            with open(src, "rb") as a, open(dst, "rb") as b:
                return a.read() == b.read()
        except OSError:
            return False

    def _update_lag_locked(self) -> None:
        for p in self.peers[:self.k]:
            self._lag.labels(peer=os.path.basename(p.rstrip("/")) or p
                             ).set(max(0, self._enqueued_gen
                                       - self._pushed_gen.get(p, 0)))

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                files, generation, epoch = self._queue.pop(0)
            # copy outside the lock: the enqueueing thread never waits
            for peer in self.peers[:self.k]:
                ok = True
                for src in files:
                    try:
                        push_file(src, peer, self.root)
                    except OSError as e:
                        ok = False
                        self._push_fail.inc()
                        log.warning(
                            "replica push of %s to %s failed: %s (the "
                            "anti-entropy scrub repairs it)", src, peer, e)
                if ok and generation:
                    self._pushed_gen[peer] = max(
                        self._pushed_gen.get(peer, 0), generation)
            with self._cv:
                if epoch is not None and not any(
                        e == epoch for _, _, e in self._queue):
                    self._inflight_epochs.discard(epoch)
                self._update_lag_locked()
                self._cv.notify_all()
