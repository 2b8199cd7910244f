"""Multi-host training under torch.distributed (counterpart of
difacto_tpu/parallel/multihost.py).

The JAX package runs one jitted program over a global mesh and XLA
inserts the cross-host sums. The port issues them itself, on two planes:

- **the control plane** (deviceless): the per-step key exchange of the
  synchronized schedule, the bounded-delay step clocks and the part-drain
  cleanup, as keys of the ``torch.distributed.TCPStore`` that rank 0
  opens at ``DIFACTO_COORDINATOR`` (the counterpart of the jax.distributed
  KV store, the ps-lite-analog wire of SURVEY §5.8). It touches no device
  and no process-group collective, so the learner's lookahead thread may
  run it ahead of the steps: a process-group collective issued from two
  threads would be entered in different orders on different hosts and
  deadlock. Each thread talks to the store over its own connection.
- **the data plane** (:class:`DataPlane`, the dispatch thread only): each
  step's per-dp-block gradient partials and its rows' (pred, label, mask)
  gathered from every process over the gloo group and summed on the
  device in global dp order (losses/fm.dp_reduce). It is a gather and an
  ordered sum, never an all-reduce, whose order depends on the algorithm:
  every rank then adds the same blocks in the same order, applies the same
  push through the port's own kernels, and the replicas of the table stay
  bit-identical with no table traffic.

The backend is gloo, by rule: ranks of one host may share one card (the
rank's card is ``cuda:{rank % device_count}``) and NCCL refuses two ranks
on one device, so the data plane stages the partials through pinned host
memory. NCCL for ranks on distinct cards is a ROADMAP.md follow-up.

Data parallelism keeps the reference's contract: each host reads its own
byte-range file parts (``host_part``), and the feature -> slot map is
host-consistent: the hashed store hashes statelessly; the dictionary
store's first pass ships raw uint64 ids (as bit views, never casts) and
every host inserts the identical sorted union in the same order.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..utils import collscan, devtrace
from ..utils.locktrace import mutex

log = logging.getLogger("difacto_tpu_torch")

# every blocking store wait and collective gives up after this long (the
# JAX package's _CTRL_TIMEOUT_MS)
TIMEOUT_S = 600
# the exit barrier's wait: a peer that has not arrived by then has failed
SHUTDOWN_S = 120
# the data plane's process-group backend (see the module docstring)
BACKEND = "gloo"


class _Cluster:
    """This process's rendezvous: its rank, the process count, and the
    coordinator's address, to which each thread opens its own store
    connection (:meth:`store`); plus the control plane's sequence
    numbers and the keys this process wrote since the last cleanup."""

    def __init__(self, host: str, port: int, rank: int, n: int, server):
        self.host, self.port, self.rank, self.n = host, port, rank, n
        # rank 0's store object serves the store: it lives as long as the
        # process, past the process group
        self.server = server
        self.abandoned = False
        self._local = threading.local()
        self._lock = mutex()
        self.seq = 0          # control exchanges, exchange thread only
        self.bar = 0          # cleanup barriers, dispatch thread only
        self._written: List[str] = []

    def store(self):
        """The calling thread's connection, under the ``difacto/`` key
        prefix (the process group's own keys live beside it)."""
        s = getattr(self._local, "store", None)
        if s is None:
            import torch.distributed as dist
            s = dist.PrefixStore("difacto", dist.TCPStore(
                self.host, self.port, is_master=False,
                timeout=datetime.timedelta(seconds=TIMEOUT_S)))
            self._local.store = s
        return s

    def wrote(self, key: str) -> None:
        with self._lock:
            self._written.append(key)

    def take_written(self) -> List[str]:
        with self._lock:
            out, self._written = self._written, []
        return out


_cluster: Optional[_Cluster] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """The rendezvous: rank 0 opens the TCPStore at the coordinator
    address and every rank joins the gloo process group through it. None
    arguments resolve from DIFACTO_COORDINATOR / DIFACTO_NPROCS /
    DIFACTO_RANK, as launch.py sets them."""
    import torch
    import torch.distributed as dist
    global _cluster
    coord = coordinator_address or os.environ["DIFACTO_COORDINATOR"]
    n = int(num_processes if num_processes is not None
            else os.environ["DIFACTO_NPROCS"])
    rank = int(process_id if process_id is not None
               else os.environ["DIFACTO_RANK"])
    if torch.cuda.is_available():
        # the rank's card; ranks beyond the card count share round-robin
        torch.cuda.set_device(rank % torch.cuda.device_count())
    host, port = coord.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(host, int(port), n, is_master=rank == 0,
                          timeout=timeout)
    dist.init_process_group(BACKEND, store=store, rank=rank, world_size=n,
                            timeout=timeout)
    _cluster = _Cluster(host, int(port), rank, n, store)
    atexit.register(shutdown)
    log.info("multi-host initialized: process %d of %d, data plane %s "
             "(ranks may share a card; NCCL would refuse that)", rank, n,
             BACKEND)


def shutdown() -> None:
    """Leave the cluster (at exit, registered by :func:`initialize`): a
    barrier, then every rank takes its process group down, so no rank's
    gloo transport sees a peer vanish mid-teardown. Skipped after
    :func:`abandon`; a barrier that times out (a peer failed) is logged
    and the group left as it is."""
    import torch.distributed as dist
    global _cluster
    cl, _cluster = _cluster, None
    if cl is None or cl.abandoned or not dist.is_initialized():
        return
    try:
        dist.monitored_barrier(
            timeout=datetime.timedelta(seconds=SHUTDOWN_S))
    except RuntimeError as e:
        log.warning("multi-host shutdown: %s", e)
        return
    dist.destroy_process_group()


def abandon() -> None:
    """A peer died: exit without the shutdown barrier it would never
    reach."""
    if _cluster is not None:
        _cluster.abandoned = True


def process_index() -> int:
    return _cluster.rank if _cluster is not None else 0


def process_count() -> int:
    return _cluster.n if _cluster is not None else 1


def host_part() -> Tuple[int, int]:
    """(part_idx, num_parts) of this host's share of the input files, the
    reference's Rank()/NumWorkers() reader sharding
    (src/lbfgs/lbfgs_learner.cc:148-150)."""
    return process_index(), process_count()


def _fire_dcn_fault() -> None:
    """The ``dcn.collective`` fault point: traversed before every
    cross-host control exchange, BEFORE the single-process early return
    so chaos tests reach it without a cluster. ``err`` stands for a dead
    coordinator or a partitioned link."""
    from ..utils import faultinject
    faultinject.act_default(faultinject.fire("dcn.collective"))


def _fire_push_stale() -> None:
    """The ``push.stale`` fault point: traversed when a host publishes its
    step clock under a bounded-delay (τ > 0) window, before the
    single-process early return."""
    from ..utils import faultinject
    faultinject.act_default(faultinject.fire("push.stale"))


def allgather_np(arr) -> np.ndarray:
    """A fixed-shape host array from every process -> ``[n_procs,
    *shape]``, over the gloo group as bytes (so 64-bit values travel as
    bit views). A process-group collective: call it from the dispatch
    thread only. One process: adds the leading axis."""
    import torch
    import torch.distributed as dist
    _fire_dcn_fault()
    a = np.ascontiguousarray(np.asarray(arr))
    if process_count() == 1:
        return a[None]
    src = torch.from_numpy(a.reshape(-1).view(np.uint8).copy())
    out = torch.empty((process_count(), src.numel()), dtype=torch.uint8)
    dist.all_gather(list(out.unbind(0)), src)
    if collscan.enabled():
        collscan.record_collective("all_gather", a.shape, a.dtype, a.nbytes,
                                   process_count(), skip_files=(__file__,))
    # the gathered host bytes (gloo's all_gather returns once they land)
    got = devtrace.fetch(out, point="multihost.allgather")
    return got.numpy().view(a.dtype).reshape((process_count(),) + a.shape)


def control_allgather_np(arr) -> np.ndarray:
    """Deviceless allgather over the store: each process sets its bytes
    under a fresh sequence key and reads every peer's, blocking until they
    are there. Touches no device and no process-group collective, so the
    lookahead thread may run it. Every process calls it the same number
    of times with the same shape and dtype; the keys accumulate until
    :func:`control_cleanup`."""
    _fire_dcn_fault()
    from ..obs import REGISTRY
    REGISTRY.counter("dcn_collectives_total",
                     "cross-host control-plane exchanges issued").inc()
    a = np.ascontiguousarray(np.asarray(arr))
    if process_count() == 1:
        return a[None]
    cl = _cluster
    st = cl.store()
    key = f"ctrl/{cl.seq}"
    cl.seq += 1
    st.set(f"{key}/{cl.rank}", a.tobytes())
    cl.wrote(f"{key}/{cl.rank}")
    scan = collscan.enabled()
    if scan:
        collscan.record_store("set", a.nbytes)
    out = np.empty((cl.n,) + a.shape, a.dtype)
    for r in range(cl.n):
        if r == cl.rank:
            out[r] = a
        else:
            b = st.get(f"{key}/{r}")
            if scan:
                collscan.record_store("get", len(b))
            out[r] = np.frombuffer(b, a.dtype).reshape(a.shape)
    return out


# Bounded-delay (τ) step clocks: each host posts its clock after it
# dispatches windowed step t; a host whose exchange would run past the
# window waits on the one peer clock key it needs (a pairwise wait on a
# strictly earlier step, so the protocol cannot deadlock). Keys are
# namespaced by the launcher's restart attempt (fault.restart_attempt): a
# relaunched cluster never reads the clocks of a dead attempt.

_clock_gen = 0


def clock_open() -> int:
    """A new clock generation for one windowed part; every host opens
    them in the same order, so the ids agree without communication."""
    global _clock_gen
    _clock_gen += 1
    return _clock_gen


def post_clock(gen: int, t: int) -> None:
    """Publish "this host has dispatched windowed step ``t``" of
    generation ``gen``. Non-blocking."""
    _fire_push_stale()
    if process_count() == 1:
        return
    from .fault import restart_attempt
    cl = _cluster
    key = f"clock/{restart_attempt()}/{gen}/{cl.rank}/{t}"
    cl.store().set(key, b"1")
    cl.wrote(key)
    if collscan.enabled():
        collscan.record_store("set", 1)


def wait_clock(gen: int, peer: int, t: int) -> float:
    """Block until ``peer`` has posted step ``t`` of generation ``gen``;
    the seconds blocked (0.0 on one process). Callers route it through
    the dead-host monitor (``monitor.guarded``)."""
    if process_count() == 1:
        return 0.0
    from .fault import restart_attempt
    t0 = time.monotonic()
    _cluster.store().wait([f"clock/{restart_attempt()}/{gen}/{peer}/{t}"])
    if collscan.enabled():
        collscan.record_store("wait")
    return time.monotonic() - t0


def control_cleanup() -> None:
    """Delete this process's control keys once every peer has consumed
    them. Called at a point every host reaches together (the part drain):
    a store-side barrier makes the consumption global first. A barrier's
    own key is deleted one barrier later, when every peer is past it."""
    if process_count() == 1:
        return
    cl = _cluster
    st = cl.store()
    bar = cl.bar
    cl.bar += 1
    st.set(f"bar/{bar}/{cl.rank}", b"1")
    st.wait([f"bar/{bar}/{r}" for r in range(cl.n)])
    written = cl.take_written()
    for k in written:
        st.delete_key(k)
    if bar > 0:
        st.delete_key(f"bar/{bar - 1}/{cl.rank}")
    if collscan.enabled():
        collscan.record_store("set", 1)
        collscan.record_store("wait")
        for _ in range(len(written) + (bar > 0)):
            collscan.record_store("delete")


def global_kv_union(ids: np.ndarray, cnts: np.ndarray):
    """Union per-host sorted-unique (id, count) dictionaries across the
    processes, in rank order: counts sum, ids union (the reference's
    servers own one global key space). One process: the inputs."""
    from ..ops.kv import kv_union
    sizes = allgather_np(np.array([len(ids)], dtype=np.int64))[:, 0]
    cap = int(sizes.max())
    ids_p = np.zeros(cap, dtype=np.uint64)
    ids_p[:len(ids)] = ids
    cnt_p = np.zeros(cap, dtype=np.float32)
    cnt_p[:len(cnts)] = cnts
    all_ids = allgather_np(ids_p)
    all_cnt = allgather_np(cnt_p)
    out_ids = np.empty(0, dtype=ids.dtype)
    out_cnt = np.empty(0, dtype=np.float32)
    for h in range(len(sizes)):
        k = int(sizes[h])
        out_ids, out_cnt = kv_union(out_ids, out_cnt,
                                    all_ids[h, :k].astype(ids.dtype),
                                    all_cnt[h, :k])
    return out_ids, out_cnt


def allreduce_np(buf, monitor=None, sum_dtype=None) -> np.ndarray:
    """Sum a host array across the processes: an allgather, then a host
    sum in rank order (``sum_dtype`` widens it, e.g. float32 partials
    summed in float64). ``monitor`` arms the dead-host watchdog around
    the collective (parallel/fault.py)."""
    buf = np.ascontiguousarray(buf)
    g = monitor.guarded(allgather_np, buf) if monitor is not None \
        else allgather_np(buf)
    return g.sum(axis=0, dtype=sum_dtype)


def to_local_numpy(arr) -> np.ndarray:
    """A tensor on this process's device as a full host numpy array (the
    JAX package's ``to_local_numpy``). Every process holds whole tensors
    (the table's replica is whole on each rank's card), so this is the
    host copy; a bfloat16 tensor comes back as float32, as the store's
    host views are. A numpy array passes through."""
    if isinstance(arr, np.ndarray):
        return arr
    import torch
    t = arr.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return devtrace.fetch(t, point="multihost.to_local_numpy").numpy()


def local_rows(arr, lo: int, hi: int) -> np.ndarray:
    """Rows ``[lo, hi)`` of a tensor as host numpy (the JAX package's
    ``local_rows``): a declared device-to-host copy, as callers slice
    prediction rows out for the pred writer. Every process holds the
    whole tensor, so the rows are always local."""
    if isinstance(arr, np.ndarray):
        return arr[lo:hi]
    return devtrace.fetch(arr[lo:hi], point="multihost.local_rows").numpy()


class _Rows:
    """The global batch's rows as the objective and the AUCs read them."""

    def __init__(self, labels, row_mask):
        self.labels = labels
        self.row_mask = row_mask


class DataPlane:
    """The SPMD step's cross-process gathers (dispatch thread only): a
    tensor from every process, ``[n_procs, *shape]`` in rank order, on
    the tensor's device. A card tensor is copied to pinned host memory,
    gathered over gloo and copied back; the sums over what comes back
    run on the card (losses/fm.dp_reduce). Counts what it moved
    (``calls``, ``bytes_out`` per process) and its wall time:
    ``seconds`` in all, ``collective_s`` of it inside the gloo call (the
    rest is the copy out, which waits for the step's queued kernels, and
    the copy back)."""

    def __init__(self, monitor=None):
        self.monitor = monitor
        self.calls = 0
        self.bytes_out = 0
        self.seconds = 0.0
        self.collective_s = 0.0

    def gather(self, t):
        import torch
        import torch.distributed as dist
        t0 = time.perf_counter()
        n = process_count()
        cuda = t.device.type == "cuda"
        if cuda:
            # the partials leave the card once the step's queued kernels
            # have made them: a declared sync of every gather
            host = devtrace.fetch(
                t, point="multihost.plane_stage",
                out=torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
        else:
            host = t.contiguous()
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          pin_memory=cuda)
        t1 = time.perf_counter()
        self._collective(dist.all_gather, list(out.unbind(0)), host)
        self.collective_s += time.perf_counter() - t1
        if cuda:
            out = out.to(t.device, non_blocking=True)
        self.calls += 1
        self.bytes_out += host.numel() * host.element_size()
        self.seconds += time.perf_counter() - t0
        return out

    def global_batch(self, pred, batch):
        """(pred, rows) of the global batch: every process's rows, in rank
        order, so the objective and the AUC are the global batch's and the
        same on every rank."""
        import torch
        g = self.gather(torch.stack([pred.to(torch.float32), batch.labels,
                                     batch.row_mask]))        # [n, 3, B]
        g = g.permute(1, 0, 2).reshape(3, -1)
        return g[0], _Rows(g[1], g[2])

    def _collective(self, fn, *args) -> None:
        """``fn(*args)`` under the dead-host watchdog. A peer that dies
        mid-collective makes gloo raise; with heartbeats on, that becomes
        :class:`~.fault.HostFailure` once the monitor declares the peer
        dead (the watchdog may exit first, with the same code). The
        collective scan records it (its input is the last argument)."""
        if collscan.enabled():
            src = args[-1]
            collscan.record_collective(
                fn.__name__, src.shape, src.dtype,
                src.numel() * src.element_size(), process_count(),
                skip_files=(__file__,))
        mon = self.monitor
        if mon is None:
            fn(*args)
            return
        mon.check()
        with mon.collective():
            try:
                fn(*args)
            except RuntimeError:
                deadline = time.monotonic() + 2 * mon.timeout
                while time.monotonic() < deadline:
                    mon.check()
                    time.sleep(mon.interval)
                raise
