"""Failure detection and recovery for multi-host runs (counterpart of
difacto_tpu/parallel/fault.py, the same protocol, exit codes and
environment).

Reference analog: DistTracker's Monitoring thread polls
``ps::Postoffice::GetDeadNodes`` every 2 s — the scheduler re-queues a dead
worker's parts via ``WorkloadPool::Reset`` and non-scheduler nodes kill
themselves when the scheduler dies (src/tracker/dist_tracker.h:164-186).

The port's planes (parallel/multihost.py) are a TCP key-value store and
gloo collectives: a dead host leaves its peers blocked on a key that
never comes, or surfaces as a failed collective. The recovery contract
splits into three pieces:

- **detection** — a UDP heartbeat mesh (:class:`HeartbeatMonitor`): every
  process beats every ``interval`` seconds; a peer silent for ``timeout``
  is dead (the GetDeadNodes analog);
- **escape** — a watchdog turns "blocked in a DCN collective while a peer
  is dead" into a fast, clean abort (:data:`EXIT_PEER_DEAD`) instead of an
  infinite hang — the moral equivalent of the reference's self `kill -9`
  on scheduler death;
- **recovery** — the launcher (launch.py ``--max-restarts``) relaunches
  with the dead host evicted; byte-range input sharding
  (multihost.host_part) re-partitions the data over the survivors (the
  ``WorkloadPool::Reset`` part re-advertisement, one level up) and
  training resumes from the latest epoch checkpoint (SGDLearner
  ``ckpt_interval`` + ``auto_resume``). As in the reference — where a
  dead server's shard is gone and recovery means reloading a saved model
  (SURVEY §5.3) — lost progress is bounded by the checkpoint cadence.

Configuration rides the environment (set by launch.py): DIFACTO_HB_PORT
(base UDP port; rank i binds base+i), DIFACTO_HB_TIMEOUT (seconds),
DIFACTO_HB_PEERS (comma-separated ``host`` list when ranks are not all on
localhost; defaults to 127.0.0.1 for every rank).
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import List, Optional
from ..utils.locktrace import mutex

log = logging.getLogger("difacto_tpu_torch")

EXIT_PEER_DEAD = 42  # process exit code for "aborted because a peer died"


def restart_attempt() -> int:
    """The launcher's recovery-attempt counter (DIFACTO_RESTART, set by
    launch.py; 0 on the first launch). The bounded-delay clock keys
    (multihost.post_clock/wait_clock) are namespaced by it so a
    relaunched cluster REJOINS AT THE CURRENT CLOCK: every survivor and
    the evicted host's replacement restart in the same fresh clock
    epoch, and stale clock keys a dead attempt left in a lingering
    coordinator can never satisfy a new attempt's window waits.

    The durability ladder (durability/recover.py) composes with this
    unchanged: a relaunched attempt's ``auto_resume`` climbs local
    checkpoint → peer fetch → WAL replay exactly like a first launch —
    nothing here knows about WAL state, and the attempt counter never
    namespaces durable artifacts (checkpoints, ``.wal/`` chains,
    replicas), which must survive relaunches by design."""
    try:
        return int(os.environ.get("DIFACTO_RESTART", "0"))
    except ValueError:
        return 0


def exit_code_for(dead: List[int]) -> int:
    """Exit code that also TELLS the launcher which peer died, so it can
    evict the right host: 100 + min(dead_rank) for ranks < 28 (codes
    101..127 — still below the shell's 128+signo band), else the generic
    EXIT_PEER_DEAD."""
    r = min(dead) if dead else -1
    return 100 + r if 0 <= r < 28 else EXIT_PEER_DEAD


class HostFailure(RuntimeError):
    """A peer host is dead; the synchronized schedule cannot continue."""

    def __init__(self, dead: List[int]):
        super().__init__(f"dead peer host(s): {dead}")
        self.dead = dead


def from_env(rank: int, nprocs: int) -> Optional["HeartbeatMonitor"]:
    """Build + start a monitor from DIFACTO_HB_* (None when unset or
    single-process)."""
    port = os.environ.get("DIFACTO_HB_PORT")
    if not port or nprocs <= 1:
        return None
    timeout = float(os.environ.get("DIFACTO_HB_TIMEOUT", "5"))
    hosts = None
    if os.environ.get("DIFACTO_HB_PEERS"):
        hosts = os.environ["DIFACTO_HB_PEERS"].split(",")
    mon = HeartbeatMonitor(rank, nprocs, int(port), timeout=timeout,
                           peer_hosts=hosts)
    mon.start()
    return mon


class HeartbeatMonitor:
    """UDP heartbeat mesh + blocked-collective watchdog.

    Every process sends a beat to every peer each ``interval`` and records
    when it last heard from each. ``dead_peers()`` lists ranks silent for
    longer than ``timeout``. While the owner is inside a collective
    (``collective()`` context), the watchdog thread aborts the process
    with :data:`EXIT_PEER_DEAD` as soon as a peer is declared dead —
    a blocked store wait or gloo collective cannot be cancelled from
    Python, so a fast process exit is the only way to hand control back to the
    launcher's recovery path.
    """

    def __init__(self, rank: int, nprocs: int, port_base: int,
                 interval: float = 0.5, timeout: float = 5.0,
                 peer_hosts: Optional[List[str]] = None):
        self.rank = rank
        self.nprocs = nprocs
        self.interval = interval
        self.timeout = timeout
        hosts = peer_hosts or ["127.0.0.1"] * nprocs
        if len(hosts) != nprocs:
            raise ValueError(
                f"DIFACTO_HB_PEERS lists {len(hosts)} hosts for {nprocs} "
                "processes")
        self._addrs = [(hosts[r], port_base + r) for r in range(nprocs)]
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", port_base + rank))
        self._sock.settimeout(interval)
        now = time.monotonic()
        self._last_seen = {r: now for r in range(nprocs) if r != rank}
        self._stop = threading.Event()
        self._in_collective_since: Optional[float] = None
        self._collective_depth = 0
        self._depth_lock = mutex()
        self._threads = [
            threading.Thread(target=self._send_loop, daemon=True),
            threading.Thread(target=self._recv_loop, daemon=True),
        ]

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------ threads
    def _send_loop(self) -> None:
        from ..obs import counter
        beats = counter("hb_beats_sent_total",
                        "UDP heartbeats sent to peers")
        msg = str(self.rank).encode()
        while not self._stop.is_set():
            for r, addr in enumerate(self._addrs):
                if r == self.rank:
                    continue
                try:
                    self._sock.sendto(msg, addr)
                    beats.inc()
                except OSError:
                    pass
            self._stop.wait(self.interval)

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(64)
                r = int(data)
                if r in self._last_seen:
                    self._last_seen[r] = time.monotonic()
            except socket.timeout:
                pass
            except (OSError, ValueError):
                if self._stop.is_set():
                    return
            self._watchdog()

    def _watchdog(self) -> None:
        """Abort a hang: blocked in a collective while a peer is dead."""
        if self._in_collective_since is None:
            return
        dead = self.dead_peers()
        if dead:
            from ..obs import counter
            counter("hb_peer_dead_total",
                    "peers declared dead by heartbeat silence").inc(
                        len(dead))
            code = exit_code_for(dead)
            log.error(
                "host %d: peer(s) %s dead while blocked in a collective "
                "— aborting for restart (exit %d)", self.rank, dead, code)
            os._exit(code)

    # ------------------------------------------------------------ queries
    def dead_peers(self) -> List[int]:
        now = time.monotonic()
        return [r for r, t in self._last_seen.items()
                if now - t > self.timeout]

    def check(self) -> None:
        """Raise HostFailure if any peer is dead (call before entering a
        collective — cheaper than entering and relying on the watchdog)."""
        dead = self.dead_peers()
        if dead:
            from ..obs import counter
            counter("hb_peer_dead_total",
                    "peers declared dead by heartbeat silence").inc(
                        len(dead))
            raise HostFailure(dead)

    def collective(self):
        """Context manager marking a collective in flight for the
        watchdog. Depth-counted and therefore REENTRANT: an epoch-long
        outer guard (the cached-replay loop) stays armed when inner
        guarded() calls exit. The depth is lock-protected because the
        SPMD control-plane pipeline issues its allgathers from a
        prefetch thread while the main thread may hold the epoch-long
        drain guard."""
        mon = self

        class _Ctx:
            def __enter__(self):
                with mon._depth_lock:
                    mon._collective_depth += 1
                    if mon._collective_depth == 1:
                        mon._in_collective_since = time.monotonic()

            def __exit__(self, *exc):
                with mon._depth_lock:
                    mon._collective_depth -= 1
                    if mon._collective_depth == 0:
                        mon._in_collective_since = None
                return False

        return _Ctx()

    def guarded(self, fn, *args):
        """check() + run ``fn`` under the collective watchdog."""
        self.check()
        with self.collective():
            return fn(*args)
