"""Fault-injection registry: named failure points, armed by environment
(counterpart of difacto_tpu/utils/faultinject.py, the same grammar, seed
and kinds).

    DIFACTO_FAULTS="point:kind@prob[:after_n][,point:kind@prob...]"

- ``point`` — a dotted site name. The port wires these:
  ``ckpt.write`` / ``ckpt.read`` (the ``fault_point=`` of
  utils/stream.py ``save_npz``/``load_npz`` at every checkpoint save and
  load: the store, BCD and L-BFGS — ``truncate`` lands half the bytes
  under the final name with no manifest, ``kill`` does that and then
  SIGKILLs, ``err`` on a read is the typed OSError a failing disk
  raises); ``producer.part`` (each part attempt of a producer thread or
  worker process, data/producer_pool.py — ``err`` re-queues the part,
  escalating to the consumer after ``max_retries``); ``step.device``
  (the host side of each dispatched step, step.py fire_step_fault —
  ``err`` stands for a lost device surfacing at dispatch);
  ``rec.read`` (every rec2 data-cache member open, data/rec2.py — ``err``
  is a failed disk read, ``truncate`` reads a half-length view which the
  per-section CRCs must reject as a typed ``RecCorrupt``, never a crash
  or a silent short read); ``store.demote`` (a cold-tier demotion batch,
  capacity/tier.py — fired before the device fetch, so a refused demote
  leaves every victim resident and serving); ``store.promote`` (a
  cold-tier promotion batch — fired before the scatter; the missing
  slots stay cold and read zeros for this batch only); ``wal.append``
  (sealing one write-ahead window, durability/wal.py — ``err`` fails the
  write and the learner keeps the window for the next flush,
  ``truncate`` lands a torn segment at its final name that replay's CRCs
  reject as a typed ``WalCorrupt``, ``kill`` dies before any byte
  lands); ``wal.replay`` (reading one segment at recovery — ``err`` and
  ``truncate`` stop replay typed at the verified prefix);
  ``replica.push`` (one file copy of the async peer push,
  durability/replicate.py — ``err`` fails the copy, counted, and the
  scrub pushes it again; ``truncate`` lands a torn copy the scrub
  catches); ``replica.fetch`` (one file copy of a recovery fetch —
  ``err`` is a dead peer, and the ladder tries the next);
  ``batcher.enqueue`` (serve admission, serve/batcher.py — ``err``
  answers the row ``!err``, ``delay_ms`` stalls admission);
  ``serve.sock.read`` / ``serve.sock.write`` (each request line read and
  each reply written, serve/server.py — ``close`` tears the connection
  down, which the retrying client must survive); ``serve.handoff`` (the
  ``#handoff`` line — ``err`` refuses the handoff, no drain);
  ``reload.warm`` (each bucket of a blue/green warm, serve/reload.py —
  ``err`` aborts the swap with the old model serving, ``delay_ms``
  stretches the warm window); ``online.log.append`` (a served row into
  the online log, online/log.py — ``err`` drops only the log entry,
  counted in ``online_log_drops_total``, and the row is answered);
  ``online.label_join`` (a ``#label`` join — ``err`` answers ``!err``,
  the connection stays up); ``online.seal`` (sealing a segment — ``err``
  keeps the resolved rows in memory and retries at the next advance);
  ``router.forward`` (each backend forward of the router,
  serve/router.py — ``err`` and ``close`` model a backend failing
  mid-chunk and surface as a tail retry on a peer, never a client
  error); ``router.takeover`` (the router's ``#handoff`` — ``err``
  refuses the roll before any state changes, the router keeps routing);
  ``fleet.handoff`` (each replica's handoff step of a rolling restart,
  serve/fleet.py — ``err`` aborts the rollout with the incumbent still
  serving); ``autoscale.spawn`` (the autoscaler's scale-up decision,
  serve/autoscale.py — ``err`` refuses the spawn, counted in
  ``autoscale_aborts_total``, and the loop keeps measuring).
  The tier's
  points pass a returned kind to :func:`act_default` (``kill`` dies,
  ``truncate``/``close`` refuse the move), where the JAX package drops
  it. Multi-host training (parallel/multihost.py) wires the last two:
  ``dcn.collective`` (every cross-host control exchange, the store's
  allgather and the gloo one — ``err`` is a dead coordinator or a
  partitioned link) and ``push.stale`` (a host publishing its step clock
  under a bounded-delay window). Both fire before the single-process
  early return, so a one-process τ > 0 run reaches them: 25 of the JAX
  package's 25 points.
- ``kind`` — what happens when the fault fires:
    - ``err``      raise :class:`FaultInjected` (an OSError, so IO call
                   sites treat it exactly like a real IO failure);
    - ``truncate`` the call site tears its artifact;
    - ``close``    the call site drops its connection mid-stream;
    - ``delay_ms`` sleep; the value rides on the kind: ``delay_ms=20``;
    - ``kill``     SIGKILL the current process.
- ``prob`` — firing probability in (0, 1] once armed (seeded RNG:
  deterministic per-process sequence).
- ``after_n`` — skip the first N traversals of the point, fire on the
  (N+1)-th, then re-arm (the counter resets). Omitted = eligible at once.

``fire(point)`` is the one call sites make. Unarmed it is one truthiness
check on an empty dict. Armed, it handles ``err``/``delay_ms`` itself and
returns the kinds the call site must sequence (``truncate``/``close``/
``kill``); sites with no special handling pass the returned kind to
:func:`act_default`. Tests arm and disarm with :func:`configure`; the
environment variable is read once at import, which is how armed
subprocesses inherit the faults.
"""

from __future__ import annotations

import os
import random
import signal
import time
from typing import Dict, List, Optional

from .locktrace import mutex

KINDS = ("err", "truncate", "close", "delay_ms", "kill")


class FaultInjected(OSError):
    """An injected failure. Derives OSError so IO call sites handle it
    through the same paths a real disk/socket failure takes."""


class _Fault:
    __slots__ = ("kind", "arg", "prob", "after", "hits", "fired")

    def __init__(self, kind: str, arg: float, prob: float, after: int):
        self.kind = kind
        self.arg = arg
        self.prob = prob
        self.after = after
        self.hits = 0
        self.fired = 0


_armed: Dict[str, List[_Fault]] = {}
_mu = mutex()
_rng = random.Random()


def parse(spec: str) -> Dict[str, List[_Fault]]:
    """Parse a DIFACTO_FAULTS spec; raises ValueError on a malformed
    entry (a chaos run with a typo'd spec must fail loudly, not silently
    run fault-free)."""
    out: Dict[str, List[_Fault]] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            point, rest = entry.split(":", 1)
            if "@" not in rest:
                raise ValueError("missing @prob")
            kindspec, probspec = rest.split("@", 1)
            after = 0
            if ":" in probspec:
                probspec, afterspec = probspec.split(":", 1)
                after = int(afterspec)
            prob = float(probspec)
            kind, arg = kindspec, 0.0
            if "=" in kindspec:
                kind, argspec = kindspec.split("=", 1)
                arg = float(argspec)
            if kind not in KINDS:
                raise ValueError(f"unknown kind {kind!r} (one of {KINDS})")
            if not (0.0 < prob <= 1.0):
                raise ValueError(f"prob {prob} outside (0, 1]")
        except ValueError as e:
            raise ValueError(
                f"bad DIFACTO_FAULTS entry {entry!r} "
                f"(want point:kind@prob[:after_n]): {e}") from e
        out.setdefault(point, []).append(_Fault(kind, arg, prob, after))
    return out


def configure(spec: Optional[str] = None, seed: int = 0xD1FAC70) -> None:
    """(Re)arm the registry. ``spec=None`` reads DIFACTO_FAULTS from the
    environment; ``spec=""`` disarms everything."""
    global _armed
    if spec is None:
        spec = os.environ.get("DIFACTO_FAULTS", "")
    _rng.seed(seed)
    # lint: ok(data-race) armed at process/test setup before traffic;
    # steady-state readers take the unarmed fast path
    _armed = parse(spec)


def fire(point: str) -> Optional[str]:
    """Traverse injection point ``point``. Returns None (no fault), or
    the kind the call site must sequence (``truncate``/``close``/
    ``kill``). ``err`` raises FaultInjected, ``delay_ms`` sleeps."""
    if not _armed:
        return None
    faults = _armed.get(point)
    if not faults:
        return None
    for f in faults:
        with _mu:
            f.hits += 1
            if f.hits <= f.after:
                continue
            if f.prob < 1.0 and _rng.random() >= f.prob:
                continue
            f.fired += 1
            f.hits = 0  # re-arm: after_n skips apply to the next cycle too
        from ..obs import REGISTRY
        REGISTRY.counter(
            "faults_fired_total",
            "injected faults that actually fired, per point and kind"
        ).labels(point=point, kind=f.kind).inc()
        if f.kind == "delay_ms":
            time.sleep(f.arg / 1e3)
            continue
        if f.kind == "err":
            raise FaultInjected(f"injected fault at {point}")
        return f.kind
    return None


def act_default(kind: Optional[str]) -> None:
    """Fallback for call sites without site-specific handling of a
    returned kind: ``kill`` dies here; tear/drop kinds degrade to an
    injected error (never silently ignored)."""
    if kind is None:
        return
    if kind == "kill":  # pragma: no cover - the process dies
        os.kill(os.getpid(), signal.SIGKILL)
    raise FaultInjected(f"injected fault kind {kind!r} (unhandled here)")


def stats() -> Dict[str, int]:
    """Fired counts per point: a chaos test asserts the fault actually
    fired."""
    with _mu:
        return {p: sum(f.fired for f in fs) for p, fs in _armed.items()}


# arm from the environment at import: subprocesses inherit DIFACTO_FAULTS
configure()
