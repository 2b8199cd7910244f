"""Ordered multi-worker batch production over a WorkloadPool
(counterpart of difacto_tpu/data/producer_pool.py).

The single-host analog of the reference's pull-based worker self-scheduling
(src/tracker/dist_tracker.h:136-156 RespHandle hands a finishing node its
next part from the WorkloadPool): N producer threads request file parts from
a shared :class:`tracker.workload_pool.WorkloadPool`, run the host pipeline
(read -> localize -> slot-map -> pack) for their part, and push prepared
batches into per-part bounded queues. The consumer (the learner's dispatch
loop) drains parts in canonical order, so training trajectories stay
deterministic regardless of worker count or scheduling, where the
reference's asynchronous dispatch was not.

Memory is bounded: each part queue holds <= depth items and a worker blocks
once its queue fills, so at most (workers + completed-but-unconsumed parts)
x depth batches are in flight.

Failure and straggler handling (workload_pool.h:88-105, 155-176):

- a worker that RAISES re-queues its part via ``pool.reset`` so another
  worker retries it, escalating to the consumer after ``max_retries``;
- a part STUCK on a worker (hung IO) is re-issued by ``remove_stragglers``
  — idle workers poll it, so a straggling part is reclaimed as soon as the
  pool's 10x-mean criterion trips.

Both paths deliver every item exactly once through a per-part GENERATION:
taking a part bumps its generation and snapshots the delivered-item count
(both under the part lock); every enqueue re-checks the generation, so a
superseded attempt — failed, stalled-then-woken, or raced — abandons
instead of double-delivering, and the new attempt resumes exactly after
the items already enqueued.

**API contract: ``make_iter(part)`` MUST be deterministic** — calling it
twice for the same part must yield the same item sequence, because retries
and re-issues resume via ``islice(make_iter(part), n_delivered)``. A
nondeterministic iterator (unseeded shuffle, IO-dependent chunking) would
silently skip or duplicate batches. The learner satisfies this by seeding
its shuffle/sampling streams per (epoch, part) (learners/sgd.py
_make_reader).
"""

from __future__ import annotations

import itertools
import os
import pickle
import queue
import threading
import time
from typing import Callable, Iterator, Optional

from ..tracker.workload_pool import WorkloadPool, WorkloadPoolParam
from ..utils import faultinject
from ..utils.locktrace import mutex

_END = object()
# ring leases a consumer may hold at once: the learner keeps two steps in
# flight and one staged batch. Each worker owns ``depth + HELD_LEASES``
# slots: the held leases may all be slots of the worker producing the part
# the consumer waits on, which must still find a free slot
HELD_LEASES = 3


class OrderedProducerPool:
    """Iterate items of ``make_iter(part)`` for part 0..n_parts-1, in order,
    produced by ``n_workers`` background threads."""

    def __init__(self, n_parts: int, make_iter: Callable[[int], Iterator],
                 n_workers: int = 2, depth: int = 4,
                 pool: Optional[WorkloadPool] = None, max_retries: int = 1,
                 obs_registry=None):
        from ..obs import REGISTRY
        self._obs = obs_registry if obs_registry is not None else REGISTRY
        self.n_parts = n_parts
        self.make_iter = make_iter
        self.n_workers = max(1, min(n_workers, n_parts))
        self.depth = depth
        self.pool = pool or WorkloadPool(WorkloadPoolParam())
        self.pool.clear()
        self.pool.add(n_parts)
        self.max_retries = max_retries
        self._queues = [queue.Queue(maxsize=depth) for _ in range(n_parts)]
        self._stop = threading.Event()
        self._errors: list = []
        self._fail_counts = [0] * n_parts
        self._enqueued = [0] * n_parts  # items already delivered per part
        self._gen = [0] * n_parts       # per-part attempt generation
        self._locks = [mutex() for _ in range(n_parts)]
        self._threads = [
            threading.Thread(target=self._work, args=(w,), daemon=True)
            for w in range(self.n_workers)
        ]

    def _deliver(self, part: int, node: int, my_gen: int, item) -> str:
        """Enqueue under the generation guard: 'ok', 'superseded' (another
        attempt took over this part) or 'stopped'.

        The part lock is held only for the non-blocking enqueue + count
        update (the exactly-once critical section) — never across a wait.
        While back-pressured on a full queue we wait OUTSIDE the lock and
        ``touch`` the pool, so (a) a replacement worker is never parked on
        the lock and (b) a healthy, merely-blocked part does not trip the
        straggler criterion."""
        while True:
            with self._locks[part]:
                if self._gen[part] != my_gen:
                    return "superseded"
                try:
                    self._queues[part].put_nowait(item)
                    if item is not _END:
                        self._enqueued[part] += 1
                    return "ok"
                except queue.Full:
                    pass
            if self._stop.is_set():
                return "stopped"
            self.pool.touch(node)
            time.sleep(0.05)

    def _work(self, node: int) -> None:
        while not self._stop.is_set():
            part = self.pool.get(node)
            if part == -2:
                if self.pool.num_remains() == 0:
                    return
                # idle workers double as the straggler poller (the
                # reference used a 2 s monitor thread,
                # workload_pool.h:155-176); a re-queued part is picked up
                # by the next get()
                self.pool.remove_stragglers()
                time.sleep(0.02)
                continue
            with self._locks[part]:
                # supersede any earlier (stalled) attempt and resume after
                # the items it already delivered
                self._gen[part] += 1
                my_gen = self._gen[part]
                start = self._enqueued[part]
            try:
                # fault point: an injected ``err`` takes the path a real
                # parse or read failure takes (re-queue the part, escalate
                # after max_retries)
                faultinject.act_default(faultinject.fire("producer.part"))
                it = itertools.islice(self.make_iter(part), start, None)
                abandoned = False
                for item in it:
                    st = self._deliver(part, node, my_gen, item)
                    if st == "superseded":
                        abandoned = True
                        break
                    if st == "stopped":
                        self.pool.reset(node)
                        return
                if abandoned:
                    continue  # re-issued elsewhere; not ours to finish
                st = self._deliver(part, node, my_gen, _END)
                if st == "stopped":
                    self.pool.reset(node)
                    return
                if st == "ok":
                    self.pool.finish(node)
            except BaseException as e:  # re-queue, escalate if persistent
                self._fail_counts[part] += 1
                self._obs.counter(
                    "producer_part_retries_total",
                    "producer part attempts that failed and were "
                    "re-queued (or escalated)").inc()
                if self._fail_counts[part] > self.max_retries:
                    self._errors.append(e)
                    self._deliver(part, node, my_gen, _END)
                    self.pool.finish(node)
                else:
                    self.pool.reset(node)

    def __iter__(self) -> Iterator:
        for t in self._threads:
            t.start()
        try:
            for part in range(self.n_parts):
                while True:
                    item = self._queues[part].get()
                    if item is _END:
                        break
                    yield part, item
                if self._errors:
                    raise self._errors[0]
        finally:
            self._stop.set()
            for t in self._threads:
                t.join()


# --------------------------------------------------------------------------
# Process-based producers: the same pool contract, across the GIL boundary.
# --------------------------------------------------------------------------

_STOP_ITER = object()
# most items a worker coalesces into one ring slot (bounds both the
# group's decode burst on the consumer and the per-slot latency)
_MAX_COALESCE = 16


def _pp_worker_main(worker_id: int, make_iter_bytes: bytes, ring_desc,
                    free_q, cmd_q, done_q, stop_ev, env: dict) -> None:
    """Worker-process entry point (module-level: spawn pickles a reference).

    Runs one part at a time: receives ("part", part, gen, start) commands,
    resumes ``make_iter(part)`` at item ``start`` (the deterministic-
    iterator contract shared with OrderedProducerPool), writes each item's
    arrays into a leased ring slot and reports it on ``done_q``. The env
    overrides are applied BEFORE unpickling ``make_iter`` — that unpickle
    is what pulls in the packing helpers — so a worker comes up with no
    visible GPU and never opens a CUDA context of its own.

    Observability: the worker instruments against its own process-global
    registry (spec_iter accounts parse/pack; this loop accounts ring-slot
    waits) and publishes a cumulative snapshot + collected trace spans
    through ``done_q`` after every finished part and on exit
    (obs/proc.py) — that is how per-stage seconds survive the process
    boundary into the consumer's stage table.
    """
    os.environ.update(env or {})
    import traceback

    from .shm_ring import ShmRing, SlotOverflow, _align, encode_item
    make_iter = pickle.loads(make_iter_bytes)
    from ..obs import REGISTRY, proc, trace
    ring_wait_c = REGISTRY.counter(
        "stage_seconds_total",
        "seconds spent per streamed-pipeline stage, summed over threads"
    ).labels(stage="ring_wait")
    ring_wait_h = REGISTRY.histogram(
        "ring_slot_wait_seconds",
        "producer wait for a free shm-ring slot (the backpressure point)")

    def publish() -> None:
        try:
            done_q.put(("obs", worker_id, proc.publish_blob()))
        except (ValueError, OSError):  # pragma: no cover - queue closed
            pass

    ring = ShmRing.attach(ring_desc)
    try:
        while not stop_ev.is_set():
            try:
                cmd = cmd_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if cmd[0] == "stop":
                return
            _, part, gen, start = cmd
            try:
                # fault point (armed through the DIFACTO_FAULTS the
                # worker inherits): an ``err`` reports the part failed,
                # and the consumer re-queues or escalates it
                faultinject.act_default(faultinject.fire("producer.part"))
                # multi-part-per-slot coalescing: items far smaller than
                # a slot share one (header count > 1), so small batches
                # pay one lease + one consumer wakeup per GROUP and
                # ring_wait amortizes. Items over half the usable budget
                # ship immediately — coalescing them would delay the
                # in-flight batch by a whole pack cycle for nothing.
                budget = ring.slot_bytes * 3 // 4
                pend: list = []  # [(seq, item, pack_dt, span)]
                pend_bytes = 0

                def est_bytes(it_) -> int:
                    arrays: list = []
                    encode_item(it_, arrays)
                    return sum(_align(a.nbytes) for a in arrays) + 4096

                def lease_slot(seq):
                    t_wait = time.perf_counter()
                    s = None
                    with trace.span("producer.ring_wait", part=part,
                                    seq=seq):
                        while not stop_ev.is_set():  # backpressure point
                            try:
                                s = free_q.get(timeout=0.1)
                                break
                            except queue.Empty:
                                continue
                    wait_dt = time.perf_counter() - t_wait
                    ring_wait_c.inc(wait_dt)
                    ring_wait_h.observe(wait_dt)
                    return s

                def send_single(seq, it_, dt, span, slot=None) -> bool:
                    if slot is None:
                        slot = lease_slot(seq)
                        if slot is None:
                            return False  # stopping
                    try:
                        ring.write(slot, it_, part=part, seq=seq, gen=gen,
                                   span=span)
                        done_q.put(("item", worker_id, part, gen, seq,
                                    slot, None, dt, 1))
                    except SlotOverflow:
                        # oversize item: fall back to the pickled channel
                        # — slower, never wrong. The unused slot rides
                        # the message for the CONSUMER to release: a
                        # worker writing to free_q would share that
                        # queue's write lock with the consumer, and a
                        # kill while holding it would wedge the
                        # consumer's releases.
                        done_q.put(("ovf", worker_id, part, gen, seq,
                                    slot, pickle.dumps(it_), dt, 1))
                    return True

                def flush() -> bool:
                    nonlocal pend, pend_bytes
                    if not pend:
                        return True
                    group, pend = pend, []
                    pend_bytes = 0
                    if len(group) == 1:
                        return send_single(*group[0])
                    seq0, _, _, span0 = group[0]
                    slot = lease_slot(seq0)
                    if slot is None:
                        return False
                    try:
                        ring.write(slot, [g[1] for g in group], part=part,
                                   seq=seq0, gen=gen, span=span0,
                                   count=len(group))
                        done_q.put(("item", worker_id, part, gen, seq0,
                                    slot, None,
                                    sum(g[2] for g in group), len(group)))
                        return True
                    except SlotOverflow:
                        # the estimate undercounted (meta overhead):
                        # degrade to one item per slot, reusing the lease
                        if not send_single(*group[0], slot=slot):
                            return False
                        for g in group[1:]:
                            if not send_single(*g):
                                return False
                        return True

                it = itertools.islice(make_iter(part), start, None)
                n = start
                while True:
                    t0 = time.perf_counter()
                    item = next(it, _STOP_ITER)
                    if item is _STOP_ITER:
                        break
                    pack_dt = time.perf_counter() - t0
                    span = trace.last_span_id()
                    sz = est_bytes(item)
                    if sz > budget // 2:
                        if not flush() or not send_single(n, item,
                                                          pack_dt, span):
                            return
                    else:
                        if pend and (pend_bytes + sz > budget
                                     or len(pend) >= _MAX_COALESCE):
                            if not flush():
                                return
                        pend.append((n, item, pack_dt, span))
                        pend_bytes += sz
                    n += 1
                if not flush():
                    return
                if not stop_ev.is_set():
                    done_q.put(("end", worker_id, part, gen, n))
                    publish()
            except BaseException:
                done_q.put(("err", worker_id, part, gen,
                            traceback.format_exc()))
                publish()
    finally:
        publish()
        ring.close()


class ProcessProducerPool:
    """OrderedProducerPool's process-based sibling: N ``spawn`` worker
    PROCESSES run ``make_iter(part)`` and ship finished items through a
    shared-memory ring (data/shm_ring.py), so the host pipeline genuinely
    overlaps the consumer's dispatch loop instead of time-slicing the GIL
    with it.

    Same contract as the thread pool:

    - parts are pulled from a shared :class:`WorkloadPool` and consumed in
      canonical order (deterministic trajectories);
    - ``make_iter(part)`` MUST be deterministic AND picklable (a module-
      level callable or ``functools.partial`` over picklable state):
      retries and straggler re-issues resume via
      ``islice(make_iter(part), n_delivered)``;
    - exactly-once through per-part GENERATIONS: every reassignment bumps
      the part's generation, deliveries tagged with a stale generation are
      dropped (their ring slots released), and the new attempt resumes
      exactly after the items already accepted — a worker killed mid-part
      (process death = the thread pool's raise) neither duplicates nor
      skips a batch;
    - a worker that RAISES re-queues its part via ``pool.reset`` and
      escalates to the consumer after ``max_retries``; parts stuck on a
      hung worker are re-issued via ``pool.remove_stragglers`` whenever a
      worker sits idle.

    Item lifetime: a yielded item's arrays are zero-copy VIEWS into the
    ring. By default the slot is auto-released when the NEXT item is
    yielded (items are valid for one iteration). A consumer that stages
    the arrays asynchronously (the learner's double-buffered copy to the
    card) calls :meth:`pop_lease` after each item and releases the lease
    itself once the step that read them has finished, holding at most
    ``HELD_LEASES`` at once (with only ``depth`` slots per worker, a
    consumer holding ``depth`` leases of one worker's part would wait on
    that worker forever).

    All pool/queue state is driven by the single consumer thread inside
    ``__iter__`` — no internal threads, no cross-thread races.
    """

    def __init__(self, n_parts: int, make_iter: Callable[[int], Iterator],
                 n_workers: int = 2, depth: int = 4,
                 pool: Optional[WorkloadPool] = None, max_retries: int = 1,
                 slot_bytes: int = 8 << 20, worker_env: Optional[dict] = None,
                 join_timeout: float = 5.0, obs_registry=None):
        import multiprocessing as mp

        from ..obs import REGISTRY, proc as obs_proc
        from .shm_ring import ShmRing
        # workers publish registry snapshots through done_q; they attach
        # here (keyed per worker) and fold into the base at shutdown, so
        # the consumer's registry reports exact cross-process totals
        self._obs = obs_registry if obs_registry is not None else REGISTRY
        self._obs_key = None  # set once the ring name exists
        self.n_parts = n_parts
        self.n_workers = max(1, min(n_workers, n_parts))
        self.depth = max(2, depth)
        self.pool = pool or WorkloadPool(WorkloadPoolParam())
        self.pool.clear()
        self.pool.add(n_parts)
        self.max_retries = max_retries
        self._join_timeout = join_timeout
        # no visible GPU: workers do host work only and must never open a
        # CUDA context (callers may override/extend).
        # DIFACTO_OBS_CHILD marks the worker as an obs child: it collects
        # trace spans in memory and ships them through done_q instead of
        # installing its own trace-file writer (obs/trace.py)
        self._env = {"CUDA_VISIBLE_DEVICES": "", obs_proc.CHILD_ENV: "1"}
        self._env.update(worker_env or {})
        self._ctx = mp.get_context("spawn")  # a CUDA context must never fork
        self._ring = ShmRing(n_slots=self.n_workers
                             * (self.depth + HELD_LEASES),
                             slot_bytes=slot_bytes,
                             n_queues=self.n_workers, ctx=self._ctx)
        self._stop_ev = self._ctx.Event()
        # one done-queue PER worker: queues' write locks are plain (non-
        # robust) semaphores, so a worker killed mid-put would wedge every
        # other writer of a shared queue; with per-worker queues a kill
        # can only wedge the dead worker's own channel — exactly the
        # failure the liveness check already handles
        self._done_qs = [self._ctx.Queue() for _ in range(self.n_workers)]
        self._cmd_qs = [self._ctx.Queue() for _ in range(self.n_workers)]
        mi_bytes = pickle.dumps(make_iter)
        self._procs = [
            self._ctx.Process(
                target=_pp_worker_main,
                args=(w, mi_bytes, self._ring.descriptor(),
                      self._ring.free_qs[w], self._cmd_qs[w],
                      self._done_qs[w], self._stop_ev, self._env),
                daemon=True)
            for w in range(self.n_workers)
        ]
        self._last_lease = None
        self._obs_key = ("ppworker", self._ring.name)
        self.pack_s = 0.0          # producer-side seconds, summed
        self.overflow_items = 0    # items that missed the ring (pickled)
        self.last_producer_span = 0  # trace span that packed the last item
        self._finished = False

    # ------------------------------------------------------------- API
    def pop_lease(self):
        """Take ownership of the last yielded item's slot lease (None if
        that item traveled the pickled fallback channel). The caller must
        ``release()`` it; un-popped leases auto-release on the next
        iteration."""
        lease, self._last_lease = self._last_lease, None
        return lease

    def __iter__(self) -> Iterator:
        for p in self._procs:
            p.start()
        try:
            yield from self._consume()
        finally:
            self._shutdown()

    # -------------------------------------------------------- consumer
    def _consume(self) -> Iterator:
        n = self.n_parts
        accepted = [0] * n      # items handed to the consumer, per part
        gen = [0] * n           # current attempt generation, per part
        complete = [False] * n
        fail_counts = [0] * n
        buffers = [[] for _ in range(n)]   # decoded, awaiting consumption
        errors: dict = {}
        self._worker_part = [None] * self.n_workers  # (part, gen) | None
        dead = [False] * self.n_workers

        def feed(w: int) -> None:
            part = self.pool.get(w)
            if part == -2:
                return
            gen[part] += 1
            self._worker_part[w] = (part, gen[part])
            self._cmd_qs[w].put(("part", part, gen[part], accepted[part]))

        def drop(slot: int) -> None:
            if slot >= 0:
                self._ring.release(slot)

        def handle(msg) -> None:
            kind = msg[0]
            if kind == "obs":
                # a worker's cumulative registry snapshot + trace spans
                # (obs/proc.py): keep the newest per worker
                from ..obs import proc as obs_proc
                obs_proc.absorb_blob(self._obs, self._obs_key + (msg[1],),
                                     msg[2])
                return
            _, w, part, g = msg[:4]
            if kind in ("item", "ovf"):
                _, _, _, _, seq, slot, blob, pack_dt, _cnt = msg
                self.pack_s += pack_dt
                if kind == "ovf":
                    # pickled fallback: the leased-but-unused slot comes
                    # back through the consumer (see _pp_worker_main)
                    drop(slot)
                    slot = -1
                if g != gen[part] or complete[part]:
                    drop(slot)  # superseded attempt — exactly-once guard
                    return
                span = 0
                if slot >= 0:
                    from .shm_ring import SlotLease
                    _, _, _, span, cnt = self._ring.read_header(slot)
                    item, _, _, _ = self._ring.read(slot)
                    # a multi-item slot fans out into per-item entries
                    # sharing one refcounted lease: the slot recycles
                    # when the LAST item's consumer is done with it
                    subs = item if cnt > 1 else [item]
                    handles = SlotLease(self._ring, slot).split(len(subs))
                else:
                    subs = [pickle.loads(blob)]
                    handles = [None]
                    self.overflow_items += 1
                    self._obs.counter(
                        "producer_overflow_total",
                        "items too large for a ring slot (pickled "
                        "fallback)").inc()
                accepted[part] += len(subs)
                for it_, h in zip(subs, handles):
                    buffers[part].append((it_, h, span))
            elif kind == "end":
                if g == gen[part]:
                    complete[part] = True
                    self.pool.finish(w)
                self._worker_part[w] = None
                feed(w)
            elif kind == "err":
                tb = msg[4]
                if g == gen[part]:
                    fail_counts[part] += 1
                    self._obs.counter(
                        "producer_part_retries_total",
                        "producer part attempts that failed and were "
                        "re-queued (or escalated)").inc()
                    if fail_counts[part] > self.max_retries:
                        errors[part] = RuntimeError(
                            f"producer worker failed part {part} "
                            f"{fail_counts[part]}x:\n{tb}")
                        complete[part] = True
                        self.pool.finish(w)
                    else:
                        self.pool.reset(w)
                self._worker_part[w] = None
                feed(w)

        def pump(timeout: float) -> None:
            got = False
            for dq in self._done_qs:
                while True:
                    try:
                        msg = dq.get_nowait()
                    except queue.Empty:
                        break
                    got = True
                    handle(msg)
            if not got:
                time.sleep(timeout)
                self._check_liveness(gen, feed, dead)

        for w in range(self.n_workers):
            feed(w)

        cur = 0
        while cur < n:
            if buffers[cur]:
                item, lease, span = buffers[cur].pop(0)
                if self._last_lease is not None:
                    # consumer didn't pop the previous lease: items are
                    # valid for one iteration by default
                    self._last_lease.release()
                self._last_lease = lease
                self.last_producer_span = span
                yield cur, item
                continue
            if complete[cur]:
                if cur in errors:
                    raise errors[cur]
                cur += 1
                continue
            # idle workers double as the straggler poller (the thread
            # pool's idle loop); a re-queued part is picked up below
            idle = [w for w in range(self.n_workers)
                    if self._worker_part[w] is None and not dead[w]]
            if idle:
                self.pool.remove_stragglers()
                for w in idle:
                    feed(w)
            elif not any(wp and wp[0] == cur
                         for wp in self._worker_part):
                # the current part lost its worker (death / straggler
                # re-issue) and every live worker is busy — likely
                # backpressure-blocked on a future part's full slot
                # quota. Evict buffered future-part items from their
                # ring slots (one memcpy each) so a busy worker can
                # finish its part, go idle, and pick up the re-queued
                # current part; without this the ring deadlocks.
                from .shm_ring import materialize_item
                for pbuf in buffers:
                    for j, (it_, lease, span_) in enumerate(pbuf):
                        if lease is not None:
                            pbuf[j] = (materialize_item(it_), None, span_)
                            lease.release()
            pump(timeout=0.1)
        self._finished = True

    def _check_liveness(self, gen: list, feed, dead: list) -> None:
        """A worker that died mid-part (killed, OOM) is the process
        analog of a raising thread: re-queue its part (pool.reset) and
        bump the generation so any of its in-flight deliveries that
        arrive later are dropped; the replacement resumes after the
        items already accepted."""
        any_alive = False
        for w, p in enumerate(self._procs):
            if dead[w]:
                continue
            if p.is_alive():
                any_alive = True
                continue
            dead[w] = True
            self._obs.counter(
                "producer_worker_deaths_total",
                "producer worker processes that died mid-run").inc()
            wp = self._worker_part[w]
            self._worker_part[w] = None
            if wp is not None:
                part, _ = wp
                self.pool.reissue_dead(w)
                gen[part] += 1  # invalidate its still-queued deliveries
        if not any_alive and not self._finished:
            alive_assignments = [wp for wp in self._worker_part if wp]
            if self.pool.num_remains() > 0 or alive_assignments:
                raise RuntimeError(
                    "all producer worker processes died with parts "
                    "remaining")

    # -------------------------------------------------------- teardown
    def _shutdown(self) -> None:
        if self._last_lease is not None:
            self._last_lease.release()
            self._last_lease = None
        self._stop_ev.set()
        for q_ in self._cmd_qs:
            try:
                q_.put_nowait(("stop",))
            except (ValueError, OSError):  # pragma: no cover
                pass
        deadline = time.monotonic() + self._join_timeout
        for p in self._procs:
            if p.pid is None:
                continue
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():  # pragma: no cover - hung worker
                p.terminate()
                p.join(timeout=1.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=1.0)
        # drain pending queue items so their feeder threads release —
        # absorbing any final obs snapshots the workers published on
        # their way out — then drop the segment; unlink is idempotent
        # and atexit-backed, so no /dev/shm entry survives any exit path
        from ..obs import proc as obs_proc
        for dq in self._done_qs:
            try:
                while True:
                    msg = dq.get_nowait()
                    if msg and msg[0] == "obs":
                        obs_proc.absorb_blob(
                            self._obs, self._obs_key + (msg[1],), msg[2])
            except (queue.Empty, ValueError, OSError):
                pass
        self._ring.unlink()
        # the queues' semaphores and feeder threads go with the pool
        for q_ in self._done_qs + self._cmd_qs + self._ring.free_qs:
            q_.cancel_join_thread()
            q_.close()
        # retire the per-worker snapshots into the base series so the
        # totals survive this pool object (and accumulate across epochs)
        self._obs.fold_children(self._obs_key)
