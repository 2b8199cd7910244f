"""The port's producer pipeline against the JAX package's, on the CPU.

- WorkloadPool: the same call sequences (assignment, dead-node reset and
  re-issue, stragglers past max(10 x mean, straggler_timeout), touch)
  give the same answers as JAX's.
- OrderedProducerPool (threads): the JAX pool's (part, item) order for
  any worker count; a part that raises is retried, then escalated after
  max_retries; a part whose first attempt stalls is re-issued and every
  item still arrives exactly once, also when the stalled attempt wakes.
- ShmRing: slot round trip with its header, multi-item slots, the
  pickled fallback for an item larger than a slot, and no ``/dev/shm``
  segment left behind on a clean exit, a consumer ``break`` or a raise.
- ProcessProducerPool: byte for byte the thread pool's items; resumes
  exactly after a worker is SIGKILLed; escalates a persistent raise;
  re-issues a part stuck on a hung worker.

Every process test runs under its own SIGALRM deadline (a deadlocked
pipeline fails instead of hanging the suite) with small inputs. Leak
checks look only at this process's segments (the ring name carries the
owner's pid), so tests running beside each other cannot disturb them.
The make_iters live at module level, and the module imports neither jax
nor torch at its top: spawned workers unpickle them cheaply.
"""

import contextlib
import functools
import os
import signal
import threading
import time

import numpy as np
import pytest

from difacto_tpu_torch.data.prefetch import prefetch
from difacto_tpu_torch.data.producer_pool import (OrderedProducerPool,
                                                  ProcessProducerPool)
from difacto_tpu_torch.data.shm_ring import (RING_PREFIX, ShmRing,
                                             SlotOverflow, decode_item,
                                             encode_item, materialize_item)
from difacto_tpu_torch.tracker.workload_pool import (WorkloadPool,
                                                     WorkloadPoolParam)


@contextlib.contextmanager
def deadline(seconds: int = 120):
    def on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s deadline")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def my_segments() -> set:
    """This process's live ring segments."""
    mine = f"{RING_PREFIX}{os.getpid()}_"
    return {n for n in os.listdir("/dev/shm") if n.startswith(mine)}


# ---------------------------------------------------------- make_iters
def seeded_items(part):
    """Mixed structure (dict, tuple, arrays, scalars), seeded per part."""
    rng = np.random.RandomState(1000 + part)
    for j in range(5):
        yield {"part": part, "j": j,
               "a": rng.randint(0, 1 << 30, 64).astype(np.int32),
               "b": rng.rand(33).astype(np.float32),
               "meta": ("x", j)}


def slow_items(part):
    for j in range(12):
        time.sleep(0.03)
        yield (part, j, np.full(8, part * 100 + j, dtype=np.int64))


def failing_part1(part):
    if part == 1:
        raise RuntimeError("persistent boom")
    for j in range(3):
        yield (part, j)


def hang_once_items(marker_dir, part):
    """The first attempt of the last part hangs (after leaving a marker);
    the re-issued attempt sees the marker and goes on."""
    if part == 11:
        marker = os.path.join(marker_dir, f"attempt_{part}")
        if not os.path.exists(marker):
            open(marker, "w").close()
            time.sleep(120)  # hung IO; the pool terminates the worker
    for j in range(3):
        yield (part, j)


def _snap(items):
    """Private copies of a pool's yields (ring views last one iteration)."""
    out = []
    for part, item in items:
        arrays = []
        spec = encode_item(item, arrays)
        out.append((part, decode_item(spec, [np.array(a) for a in arrays])))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (pa, ia), (pb, ib) in zip(a, b):
        assert pa == pb
        assert (ia["part"], ia["j"], ia["meta"]) == (ib["part"], ib["j"],
                                                     ib["meta"])
        np.testing.assert_array_equal(ia["a"], ib["a"])
        np.testing.assert_array_equal(ia["b"], ib["b"])


# -------------------------------------------------------- workload pool
def _script(mod, case):
    """Run one call sequence on a WorkloadPool class of ``mod``."""
    Pool, Param = mod.WorkloadPool, mod.WorkloadPoolParam
    out = []
    if case == "assign_finish":
        pool = Pool()
        pool.add(3)
        out += [pool.num_remains(), pool.get(node=1), pool.get(node=1),
                pool.get(node=2), pool.get(node=3)]
        pool.finish(1)
        out += [pool.num_remains()]
        pool.finish(2)
        out += [pool.num_remains()]
    elif case == "dead_node":
        pool = Pool()
        pool.add(3)
        out += [pool.get(node=7), pool.get(node=7), pool.get(node=8)]
        out += [pool.reissue_dead(7), pool.num_remains()]
        out += [pool.get(node=9), pool.get(node=9), pool.get(node=9)]
        pool.reset(8)
        out += [pool.get(node=9), pool.num_remains()]
    elif case in ("straggler", "straggler_timeout_floor"):
        timeout = 0.01 if case == "straggler" else 7200.0
        pool = Pool(Param(straggler_timeout=timeout))
        pool.add(13)
        for _ in range(10):
            pool.get(node=1)
            pool.finish(1)
        slow = pool.get(node=2)
        other = pool.get(node=4)
        pool.touch(4)
        now = time.monotonic() + 3600
        out += [slow, other, pool.remove_stragglers(now=now)]
        out += [pool.get(node=3), pool.num_remains()]
    elif case == "straggler_needs_history":
        pool = Pool(Param(straggler_timeout=0.01))
        pool.add(2)
        pool.get(node=1)
        out += [pool.remove_stragglers(now=time.monotonic() + 3600)]
    elif case == "disabled":
        pool = Pool()
        pool.add(12)
        for _ in range(11):
            pool.get(node=1)
            pool.finish(1)
        pool.get(node=2)
        out += [pool.remove_stragglers(now=time.monotonic() + 3600)]
    elif case == "reissued_part_finishes_once":
        pool = Pool(Param(straggler_timeout=0.01))
        pool.add(12)
        for _ in range(10):
            pool.get(node=1)
            pool.finish(1)
        slow = pool.get(node=2)
        out += [slow, pool.remove_stragglers(now=time.monotonic() + 3600)]
        out += [pool.get(node=3), pool.num_remains()]
        pool.finish(3)
        pool.finish(2)      # the first attempt, already re-issued
        out += [pool.num_remains(), pool.get(node=2), pool.get(node=2)]
    elif case == "reset_requeues_in_order":
        pool = Pool()
        pool.add(5)
        out += [pool.get(node=7) for _ in range(3)] + [pool.get(node=5)]
        pool.reset(7)
        out += [pool.num_remains()]
        out += [pool.get(node=6) for _ in range(4)]
        pool.finish(5)
        pool.finish(6)
        out += [pool.num_remains()]
    return out


@pytest.mark.parametrize("case", [
    "assign_finish", "dead_node", "straggler", "straggler_timeout_floor",
    "straggler_needs_history", "disabled", "reissued_part_finishes_once",
    "reset_requeues_in_order"])
def test_workload_pool_answers_as_jax(case):
    from difacto_tpu.tracker import workload_pool as jwp
    from difacto_tpu_torch.tracker import workload_pool as twp
    got, want = _script(twp, case), _script(jwp, case)
    assert got == want
    if case == "straggler":
        assert got[2] == [got[0], got[1]] and got[3] == got[0]
    if case == "straggler_timeout_floor":
        assert got[2] == []     # 3600 s < the 7200 s floor
    if case == "reissued_part_finishes_once":
        assert got[1] == [got[0]] and got[2] == got[0]
        assert got[4] == 1 and got[5:] == [11, -2]   # only part 11 left
    if case == "reset_requeues_in_order":
        assert got[:4] == [0, 1, 2, 3] and got[5:9] == [0, 1, 2, 4]
        assert got[9] == 0


# ----------------------------------------------------- the thread pool
@pytest.mark.parametrize("workers", [1, 3])
def test_thread_pool_order_equals_jax(workers):
    from difacto_tpu.data.producer_pool import OrderedProducerPool as JPool
    with deadline():
        got = list(OrderedProducerPool(6, seeded_items, n_workers=workers,
                                       depth=2))
        want = list(JPool(6, seeded_items, n_workers=workers, depth=2))
    _same(got, want)
    assert [(p, i["j"]) for p, i in got] == [(p, j) for p in range(6)
                                             for j in range(5)]


def test_thread_pool_escalates_a_persistent_raise():
    with deadline():
        got = []
        with pytest.raises(RuntimeError, match="persistent boom"):
            for part, item in OrderedProducerPool(3, failing_part1,
                                                  n_workers=2,
                                                  max_retries=1):
                got.append((part, item))
    assert got == [(0, (0, j)) for j in range(3)]


def test_thread_pool_retries_a_raise_exactly_once():
    """A part that raises mid-way once is retried from the items already
    delivered: no duplicate, no gap."""
    attempts = {}

    def flaky(part):
        attempts[part] = attempts.get(part, 0) + 1
        for j in range(6):
            if part == 2 and j == 3 and attempts[part] == 1:
                raise IOError("transient")
            yield (part, j)

    with deadline():
        got = list(OrderedProducerPool(4, flaky, n_workers=2,
                                       max_retries=1))
    assert got == [(p, (p, j)) for p in range(4) for j in range(6)]
    assert attempts[2] == 2


def test_thread_pool_reissues_a_straggler_exactly_once():
    """The first attempt of the last part stalls mid-way; the straggler
    check re-issues it to an idle worker, which resumes after the items
    delivered; when the stalled attempt wakes, its deliveries are
    superseded."""
    wake = threading.Event()
    attempts = {}

    def items(part):
        attempts[part] = attempts.get(part, 0) + 1
        for j in range(4):
            if part == 11 and j == 2 and attempts[part] == 1:
                wake.wait(60)
            yield (part, j)

    with deadline():
        wp = WorkloadPool(WorkloadPoolParam(straggler_timeout=0.3))
        got = []
        for part, item in OrderedProducerPool(12, items, n_workers=3,
                                              pool=wp):
            got.append((part, item))
            if part == 11 and item[1] == 3:
                wake.set()      # the stalled attempt wakes and delivers
    wake.set()
    assert got == [(p, (p, j)) for p in range(12) for j in range(4)]
    assert attempts[11] == 2


def test_prefetch_order_and_errors():
    assert list(prefetch(iter(range(100)), depth=2)) == list(range(100))

    def bad():
        yield 1
        raise ValueError("boom")

    with pytest.raises(ValueError):
        list(prefetch(bad()))


# -------------------------------------------------------------- the ring
def test_ring_round_trip_header_and_multi_item_slots():
    from difacto_tpu_torch.data.pack_stream import BlkInfo, Payload
    item = ("ready", BlkInfo(size=2, label=np.array([1.0, 0.0],
                                                    np.float32)),
            Payload("panel", np.arange(12, dtype=np.int32),
                    np.zeros(3, np.float32), True, 2, 6, 8))
    ring = ShmRing(n_slots=2, slot_bytes=1 << 16)
    try:
        assert ring.name in my_segments()
        ring.write(0, item, part=3, seq=7, gen=2, span=99)
        assert ring.read_header(0) == (3, 7, 2, 99, 1)
        out, part, seq, gen = ring.read(0)
        assert (part, seq, gen) == (3, 7, 2)
        kind, info, payload = out
        assert kind == "ready" and isinstance(payload, Payload)
        assert payload.layout == "panel" and payload[3:] == (True, 2, 6, 8,
                                                              0, None, None)
        np.testing.assert_array_equal(payload.i32, np.arange(12))
        np.testing.assert_array_equal(info.label, [1.0, 0.0])
        # zero-copy: the slot's bytes are the arrays' bytes
        assert not payload.i32.flags.owndata
        private = materialize_item(out)
        ring.write(1, [item, item], part=4, seq=0, gen=1, count=2)
        assert ring.read_header(1)[4] == 2
        both, _, _, _ = ring.read(1)
        assert len(both) == 2
        np.testing.assert_array_equal(both[1][2].i32, private[2].i32)
        assert private[2].i32.flags.owndata
        with pytest.raises(SlotOverflow):
            ring.write(0, np.zeros(1 << 15, np.int64), part=0, seq=0,
                       gen=0)
        del out, info, payload, both
    finally:
        ring.unlink()
    assert ring.name not in my_segments()


def test_ring_oversize_items_fall_back_to_pickle():
    with deadline():
        pool = ProcessProducerPool(2, seeded_items, n_workers=1,
                                   slot_bytes=256, join_timeout=60.0)
        got = _snap(pool)
    assert [g[1]["j"] for g in got] == list(range(5)) * 2
    assert pool.overflow_items == 10
    _same(got, _snap(OrderedProducerPool(2, seeded_items)))


@pytest.mark.parametrize("how", ["clean", "break", "raise"])
def test_ring_leaves_no_segment(how):
    with deadline():
        before = my_segments()
        pool = ProcessProducerPool(3, seeded_items, n_workers=2,
                                   slot_bytes=1 << 20, join_timeout=60.0)
        name = pool._ring.name
        assert name in my_segments()
        if how == "clean":
            assert len(list(pool)) == 15
        elif how == "break":
            for i, _ in enumerate(pool):
                if i == 2:
                    break
        else:
            with pytest.raises(KeyError):
                for _, item in pool:
                    item["missing"]
    assert name not in my_segments()
    assert my_segments() == before - {name}


# ----------------------------------------------------- the process pool
@pytest.mark.parametrize("workers", [1, 2])
def test_process_pool_matches_thread_pool_bytes(workers):
    with deadline():
        want = _snap(OrderedProducerPool(4, seeded_items, n_workers=2))
        got = _snap(ProcessProducerPool(4, seeded_items, n_workers=workers,
                                        slot_bytes=1 << 20,
                                        join_timeout=60.0))
    assert len(got) == 20
    _same(got, want)


def test_process_pool_survives_worker_kill():
    with deadline():
        pool = ProcessProducerPool(2, slow_items, n_workers=2, depth=4,
                                   slot_bytes=1 << 20, join_timeout=60.0)
        got, killed = [], False
        for part, item in pool:
            got.append((part, item[1], int(item[2][0])))
            if not killed and len(got) == 3:
                os.kill(pool._procs[0].pid, signal.SIGKILL)
                killed = True
    assert killed
    assert got == [(p, j, p * 100 + j) for p in range(2) for j in range(12)]


def test_process_pool_escalates_after_max_retries():
    with deadline():
        pool = ProcessProducerPool(2, failing_part1, n_workers=2,
                                   max_retries=1, slot_bytes=1 << 20,
                                   join_timeout=60.0)
        got = []
        with pytest.raises(RuntimeError, match="persistent boom"):
            for part, item in pool:
                got.append((part, item))
    assert got == [(0, (0, j)) for j in range(3)]
    assert pool._ring.name not in my_segments()


def test_process_pool_reissues_a_straggler(tmp_path):
    with deadline():
        wp = WorkloadPool(WorkloadPoolParam(straggler_timeout=0.5))
        pool = ProcessProducerPool(
            12, functools.partial(hang_once_items, str(tmp_path)),
            n_workers=3, pool=wp, slot_bytes=1 << 20, join_timeout=2.0)
        items = list(pool)
    assert items == [(p, (p, j)) for p in range(12) for j in range(3)]
    assert os.path.exists(tmp_path / "attempt_11")   # it did hang
    assert pool._ring.name not in my_segments()


def test_process_pool_leases_hold_their_slots():
    """A popped lease keeps its slot's bytes until released: with two
    slots per worker and leases held, the views stay intact while later
    items arrive."""
    with deadline():
        pool = ProcessProducerPool(1, slow_items, n_workers=1, depth=3,
                                   slot_bytes=1 << 20, join_timeout=60.0)
        held = []
        seen = []
        for _, item in pool:
            held.append((pool.pop_lease(), item[2]))
            while len(held) > 2:
                lease, arr = held.pop(0)
                seen.append(int(arr[0]))
                lease.release()
        seen += [int(a[0]) for _, a in held]
        for lease, _ in held:
            lease.release()
    assert seen == list(range(12))


def big_items(part):
    """Items past half a 64 KiB slot's budget: one item per slot."""
    for j in range(10):
        yield (part, j, np.full(30_000 // 8, part * 100 + j, np.int64))


def test_consumer_holding_leases_never_starves_the_worker():
    """The learner holds three leases (two steps in flight, one staged
    batch), which can be every slot ``depth`` gives the worker of the
    part it waits on; the pool gives each worker ``HELD_LEASES`` more, so
    one worker with depth 2 delivers a ten-item part to a consumer that
    keeps the newest three leases."""
    with deadline(120):
        pool = ProcessProducerPool(2, big_items, n_workers=1, depth=2,
                                   slot_bytes=64 << 10,
                                   join_timeout=60.0)
        held, seen = [], []
        for _, item in pool:
            held.append((pool.pop_lease(), item))
            while len(held) > 3:
                lease, it = held.pop(0)
                seen.append(int(it[2][0]))
                lease.release()
        seen += [int(it[2][0]) for _, it in held]
        for lease, _ in held:
            lease.release()
    assert pool.overflow_items == 0
    assert seen == [p * 100 + j for p in range(2) for j in range(10)]
