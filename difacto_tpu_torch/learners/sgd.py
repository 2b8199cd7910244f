"""SGD learner: the minibatch FM / logistic-regression trainer (counterpart
of difacto_tpu/learners/sgd.py; the reference's SGDLearner,
src/sgd/sgd_learner.{h,cc}).

Per batch: host read + localize + slot map + pack (data/pack_stream.py;
the hashed store hashes, the dictionary store maps and inserts on this
thread, growing the table; a pre-localized rec cache, ``data_format=rec``,
arrives compacted, data/cached.py, and skips the parse and the
sort/unique), one copy of the two packed buffers to the
device, on epoch 0 the count push, then the train step (step.py: one
gather kernel, FM forward and backward, one scatter kernel with the
FTRL/AdaGrad epilogue, in place on the table; the flat V_dim=0 table
pushes with plain scatters). Metric scalars stay on the device and are
fetched in one transfer at part boundaries when a progress row is due,
every ``_MERGE_CAP`` batches, and at epoch end together with the store's
(penalty, nnz).

The replay cache (``device_cache_mb``, on by default as in JAX) keeps
the first pass's device buffers: a panel training batch is staged with
its chunked-run layout built on the device, and epoch 0 already takes
the chunked backward; later epochs replay the staged batches in a
per-part ``RandomState(epoch)`` permutation with no host-to-device copy
(``_replay_cached``). A dictionary that grows after staging leaves the
staged out-of-bounds pads stale; the replay entry rewrites them
(``_repad_cache``).

Streamed parts are read, parsed and packed off the dispatch thread
(``_iterate_parts``): by ``num_producers`` producer threads
(data/producer_pool.OrderedProducerPool) or, on the hashed store's
streamed training pass, by spawned worker processes that ship each packed
batch through a shared-memory ring (ProcessProducerPool,
data/shm_ring.py). Parts are pulled from a WorkloadPool and consumed in
canonical order, so every transport and producer count yields the same
batches in the same order. A batch's buffers are copied to the device one
iteration before its step runs; a ring slot goes back to its worker only
after the step that read it has finished. ``stream_chunks`` builds the
chunked-run backward layout on the producers; ``device_dedup`` ships raw
hashed tokens and dedups them in the step (ops/fused.dedup_tokens).

The scheduler is the JAX package's (RunScheduler, sgd_learner.cc:52-122):
epoch loop with training and validation jobs, relative-objective and
validation-AUC early stopping, model load and save, interval checkpoints
with optimizer state (``ckpt_interval``, ``ckpt_keep``) and
``auto_resume`` from the newest one that verifies, epoch-end callbacks,
progress rows. ``self.obs`` is the run's metric registry under the JAX
package's metric names (``stage_seconds_total{stage}`` and the rest,
``stage_stats()``), flushed to ``metrics_path`` as JSONL.

The capacity levers ride the same path: count-min admission on the
producers (capacity/sketch.py), the cold tier's routing of every packed
payload before its host-to-device copy (capacity/tier.route_payload, in
``_stage_payload``; the tier turns device_dedup, stream_chunks and the
replay cache off) and occupancy eviction at each training epoch's end.
The durability legs (durability/): the write-ahead log records the slots
each training batch touched from the host payload and seals every
``wal_flush_batches`` steps (and each epoch's end) as one segment of the
rows' current values; each interval checkpoint roots a new chain and is
pushed to the ``replica_peers``; ``auto_resume`` then climbs the recovery
ladder (durability/recover.py).

The single-process mesh (``mesh_dp * mesh_fs > 1`` or ``mesh_force``,
parallel/mesh.py): the store cuts the table into ``mesh_fs`` key-range
shards and each staged payload carries its slot vector's shard routing
(the offsets and local slots, made on the host from the payload's slot
section when it is staged, ``_stage_payload``), so every pull and push
launches the kernels once per non-empty shard run; under ``mesh_dp > 1``
the backward sums its per-slot partials over dp blocks of each batch
(losses/fm.dp_reduce) and the caps are sized by ``mesh_dim_min``. As in
the JAX learner, the producers' fast paths (``device_dedup``,
``stream_chunks``) stay off under a mesh, the dictionary store stages
its replay cache in its second pass and does not repad it, and the
write-ahead log refuses a mesh. ``bounded_delay > 0`` (multi-host, item
11b) raises.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import logging
import os
import re
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import KWArgs, Param
from ..data.batch_reader import BatchReader
from ..data.cached import CachedBatchReader, cache_probe
from ..capacity.sketch import make_admission
from ..data.localizer import compact
from ..data.pack_stream import (Payload, ShapeSchedule, StreamSpec,
                                pack_mapped, prepare_from_uniq,
                                prepare_hashed, spec_iter, timed_reader)
from ..data.producer_pool import (HELD_LEASES, OrderedProducerPool,
                                  ProcessProducerPool)
from ..data.reader import Reader
from ..losses import create as create_loss
from ..obs import REGISTRY, MetricsFlusher, Registry, trace
from ..ops.batch import (bucket, panel_chunk_tokens_flat, unpack_batch,
                         unpack_panel, unpack_panel_raw)
from ..ops.fused import dedup_tokens
from ..parallel.sharded import ShardedSlots
from ..step import fire_step_fault, make_step_fns
from ..store.local import SlotStore
from ..tracker.workload_pool import WorkloadPool, WorkloadPoolParam
from ..updaters.sgd_updater import SGDUpdaterParam, gather_bytes
from ..utils import manifest as mft
from ..utils import stream
from ..utils.progress import Progress, ReportProg
from .base import Learner, register

log = logging.getLogger("difacto_tpu_torch")

# job types (sgd::Job, src/sgd/sgd_utils.h:16-21)
K_TRAINING, K_VALIDATION = 3, 4


@dataclass
class SGDLearnerParam(Param):
    """Every key of the JAX package's SGDLearnerParam, with its default."""
    data_in: str = ""
    data_val: str = ""
    data_format: str = "libsvm"
    model_out: str = ""
    model_in: str = ""
    loss: str = "fm"
    max_num_epochs: int = 20
    load_epoch: int = -1
    batch_size: int = 100
    shuffle: int = 10
    neg_sampling: float = 1.0
    pred_out: str = ""
    pred_prob: bool = True
    num_jobs_per_epoch: int = 10
    report_interval: int = 1
    stop_rel_objv: float = 1e-5
    stop_val_auc: float = 1e-5
    has_aux: bool = False
    task: int = 0
    num_producers: int = 0
    producer_depth: int = 3
    straggler_timeout: float = 0.0
    train_auc: str = dataclasses.field(default="binned", metadata=dict(
        enum=["binned", "exact", "none"]))
    producer_mode: str = dataclasses.field(default="auto", metadata=dict(
        enum=["auto", "thread", "process"]))
    ring_slot_mb: int = 0
    stream_chunks: bool = False
    device_dedup: bool = False
    device_cache_mb: int = 2048
    ckpt_interval: int = 0
    auto_resume: bool = False
    ckpt_keep: int = 0
    mesh_fs: int = 1
    mesh_dp: int = 1
    mesh_force: bool = False
    nnz_cap: int = 0
    uniq_cap: int = 0
    bounded_delay: int = -1
    metrics_path: str = ""
    metrics_interval_s: float = 30.0
    metrics_max_mb: float = dataclasses.field(default=0.0,
                                              metadata=dict(lo=0))
    wal_flush_batches: int = 0
    replica_peers: str = ""
    replica_k: int = 1


# the streamed pipeline's stages (stage_seconds_total{stage}):
#   parse     read + parse, on the producers
#   pack      hash / compact, dedup and pack, on the producers
#   ring_wait a worker process blocked on a free ring slot
#   transfer  host-to-device copies of the packed buffers
#   step      step dispatch, and the metric fetches where device time
#             surfaces
_STAGES = ("parse", "pack", "ring_wait", "transfer", "step")


class _DevPayload(NamedTuple):
    """A payload whose buffers are on the device (data/pack_stream.Payload's
    fields, in order) and, under a mesh, ``route``: its slot vector's
    shard routing, the fs + 1 host offsets and the device's local slots
    (parallel/sharded.py), made on the host when the payload is staged."""
    layout: str
    i32: torch.Tensor
    f32: torch.Tensor
    binary: bool
    b_cap: int
    d2: int
    u_cap: int
    row_cap: int = 0
    chunks: Optional[tuple] = None
    host_slots: Optional[np.ndarray] = None
    route: Optional[tuple] = None


class _Staged(NamedTuple):
    """One batch on the device: the packed buffers and their statics, and
    for a staged panel training batch its chunked-run layout (ci, cl,
    cv)."""
    layout: str           # "panel", "coo" or "panel_raw"
    i32: torch.Tensor
    f32: torch.Tensor
    b_cap: int
    d2: int
    u_cap: int
    row_cap: int
    binary: bool
    nrows: int
    chunks: Optional[tuple] = None
    route: Optional[tuple] = None   # (offsets, local slots) under a mesh

    @property
    def slots_offset(self) -> int:
        """Where the slot vector starts in ``i32``."""
        return self.b_cap * self.d2 if self.layout == "panel" \
            else 2 * self.d2


class _DeviceBatchCache:
    """Device-resident replay cache of staged batches (the JAX package's
    ``_DeviceBatchCache``, one card).

    The first pass over a part stages each batch once and keeps its
    device buffers; later epochs replay them with no host-to-device
    copy, shuffled as a per-epoch permutation of each part's batches
    (``RandomState(epoch)``; the row -> batch assignment is frozen at
    staging). All caches of one learner draw from ONE ``device_cache_mb``
    budget (``shared``). When the budget fills mid-pass the staged part
    prefix is kept (``_freeze``): later epochs replay the prefix and
    stream the rest. A dictionary store may grow after a batch is staged,
    which pulls its out-of-bounds pad slots back in bounds; slot
    assignment is insertion-stable, so only the pads go stale
    (``repadable``: the learner rewrites them, ``_repad_cache``), while a
    store that cannot repad invalidates the cache back to streaming."""

    def __init__(self, budget_mb: int, shared: Optional[dict] = None,
                 repadable: bool = False, stage_after_pass: int = 0) -> None:
        self.budget = budget_mb << 20
        self.shared = shared if shared is not None else {"used": 0}
        self.used = 0
        self.entries: dict = {}   # part -> staged batches
        self.part_bytes: dict = {}
        self.ready = False        # a staging pass has completed
        self.alive = True
        self.frozen = False       # the budget filled mid-pass
        self.repadable = repadable
        # the pass that stages: 0, or 1 for the mesh dictionary store,
        # whose table still grows in its first pass
        self.stage_after_pass = stage_after_pass
        self.stale_pads = False   # some batches padded at an older capacity
        self.passes = 0
        self.capacity: Optional[int] = None  # store capacity at staging

    @property
    def staging(self) -> bool:
        """True while the current pass stages batches."""
        return (self.alive and not self.frozen
                and self.passes == self.stage_after_pass)

    @property
    def partial(self) -> bool:
        """True when the cache holds a proper prefix of the parts: replay
        it and stream the rest."""
        return self.frozen and bool(self.entries)

    def parts(self) -> set:
        return set(self.entries)

    def invalidate(self, reason: str) -> None:
        self.alive = False
        self.ready = False
        self.entries.clear()
        self.part_bytes.clear()
        self.shared["used"] -= self.used
        self.used = 0
        log.info("device batch cache invalidated (%s) — streaming", reason)

    def _freeze(self, drop_part: int, reason: str) -> None:
        """Keep the fully staged part prefix and drop the part being
        staged (its remaining batches would be lost on replay); parts
        stage in order, so what is kept is a prefix."""
        self.frozen = True
        dropped = self.part_bytes.pop(drop_part, 0)
        self.entries.pop(drop_part, None)
        self.used -= dropped
        self.shared["used"] -= dropped
        log.info("device batch cache frozen (%s): keeping %d staged "
                 "part(s), streaming the rest", reason, len(self.entries))

    def add(self, part: int, payload, nbytes: int,
            capacity: Optional[int] = None) -> None:
        if not self.staging:
            return
        if capacity is not None:
            if self.capacity is None:
                self.capacity = capacity
            elif self.capacity != capacity:
                if self.repadable:
                    self.capacity = capacity
                    self.stale_pads = True
                else:
                    self.invalidate("store capacity grew during staging")
                    return
        if self.shared["used"] + nbytes > self.budget:
            self._freeze(part, f"budget {self.budget >> 20} MB filled")
            return
        self.used += nbytes
        self.shared["used"] += nbytes
        self.entries.setdefault(part, []).append(payload)
        self.part_bytes[part] = self.part_bytes.get(part, 0) + nbytes

    def finish_pass(self) -> None:
        if self.alive and self.passes == self.stage_after_pass:
            self.ready = bool(self.entries)
            if self.frozen and not self.entries:
                # nothing fit: stream for good
                self.alive = False
        self.passes += 1

    def iter_parts(self, shuffle: bool, seed: int):
        rng = np.random.RandomState(seed)
        for part in sorted(self.entries):
            items = self.entries[part]
            order = rng.permutation(len(items)) if shuffle \
                else range(len(items))
            for i in order:
                yield part, items[i]


@register("sgd")
class SGDLearner(Learner):
    # dispatched batches whose metrics are held on the device before a
    # merge fetches them
    _MERGE_CAP = 256

    def __init__(self, device="cuda", table_init=None,
                 tier_virgin_V=None) -> None:
        """``table_init`` is the store's init provider
        (store/local.SlotStore): ``table_init(capacity) -> SGDState``;
        None draws the port's own. ``tier_virgin_V`` is the cold tier's
        virgin V (capacity/tier.virgin_V by default)."""
        super().__init__()
        self.device = device
        self._table_init = table_init
        self._tier_virgin_V = tier_virgin_V
        self._wal = None
        self._replica = None
        self.param: Optional[SGDLearnerParam] = None
        self.store: Optional[SlotStore] = None
        self._flusher: Optional[MetricsFlusher] = None

    # ----------------------------------------------------------- init
    def init(self, kwargs: KWArgs) -> KWArgs:
        self.param, remain = SGDLearnerParam.init_allow_unknown(kwargs)
        uparam, remain = SGDUpdaterParam.init_allow_unknown(remain)
        p = self.param
        if p.bounded_delay > 0:
            raise NotImplementedError(
                "bounded_delay > 0 is not ported yet (ROADMAP.md, item 11b: "
                "multi-host under torch.distributed)")
        if p.task != 0:
            raise NotImplementedError(
                "the learner's prediction job is task=pred on the CLI "
                "(difacto_tpu_torch.__main__.run_pred)")
        # the loss owns the effective V_dim (loss=logit forces 0): the
        # store never allocates embedding state it would not train
        self.loss = create_loss(p.loss, uparam.V_dim)
        if uparam.V_dim != self.loss.V_dim:
            uparam = dataclasses.replace(uparam, V_dim=self.loss.V_dim)
        self.mesh = None
        self._dim_min = 8
        if p.mesh_fs * p.mesh_dp > 1 or p.mesh_force:
            from ..ops.batch import mesh_dim_min
            from ..parallel import make_mesh
            self.mesh = make_mesh(dp=p.mesh_dp, fs=p.mesh_fs,
                                  device=self.device)
            self._dim_min = mesh_dim_min(p.mesh_dp)
            if p.mesh_dp > 1:
                # the backward's per-slot partials sum over dp blocks; a
                # dp-cut chunk layout is not declared ascending, as in the
                # JAX learner (losses/__init__.py chunks_sorted)
                self.loss = dataclasses.replace(
                    self.loss, chunks_sorted=False, dp=p.mesh_dp)
            log.info("mesh: dp=%d fs=%d over %s", p.mesh_dp, p.mesh_fs,
                     self.mesh)
        self.store = SlotStore(uparam, device=self.device,
                               init=self._table_init,
                               virgin_V=self._tier_virgin_V, mesh=self.mesh)
        if self.store.tier is not None and (
                p.device_dedup or p.stream_chunks or p.device_cache_mb):
            log.info("cold_tier_rows: device_dedup, stream_chunks and the "
                     "replay cache stay off (tier routing rewrites each "
                     "batch's host slots before its copy to the card)")
        self._shapes = ShapeSchedule()
        self._caches: dict = {}
        self._cache_pool = {"used": 0}   # one budget across job types
        self._cache_probe: dict = {}     # rec uri -> pre-localized
        # this run's own registry (two learners in one process must not
        # blur); producer worker processes report into it through the
        # pool's snapshot channel (obs/proc.py)
        self.obs = Registry()
        stage_c = self.obs.counter(
            "stage_seconds_total",
            "seconds spent per streamed-pipeline stage, summed over "
            "threads")
        self._stage_c = {k: stage_c.labels(stage=k) for k in _STAGES}
        # host time of the cold tier's routing (promotes and demotes
        # included), summed over the batches routed: not a metric of the
        # registry, whose names are the JAX package's
        self.tier_routes = 0
        self.tier_route_s = 0.0
        self._step_h = self.obs.histogram(
            "train_step_seconds",
            "host-side dispatch+wait time of one fused device step")
        self._rows_c = self.obs.counter(
            "train_rows_total", "examples consumed by dispatched steps")
        self._gather_c = self.obs.counter(
            "store_gather_bytes_total",
            "slot-table row bytes gathered+scattered per dispatched "
            "device program").labels(path="train")
        self._last_producer_mode = "thread"
        _, self._train_step, self._eval_step = make_step_fns(
            self.store.fns, self.loss, train_auc=p.train_auc)
        self._init_durability()
        return remain

    def _init_durability(self) -> None:
        """The durability legs (durability/): the write-ahead delta log
        and the async peer replicator, both off by default. The WAL's
        gates raise the JAX package's texts: each refused knob changes
        rows outside the dispatch path the WAL observes."""
        p = self.param
        self._wal = None
        self._replica = None
        self._wal_touched: list = []
        self._wal_step = 0
        self._wal_lo = 0
        self._wal_epoch = 0
        # batches of the re-entered epoch whose effects a WAL replay has
        # applied: the recovery ladder arms it, the dispatch skips them
        self._wal_skip = 0
        if p.wal_flush_batches > 0:
            if not p.model_out:
                raise ValueError(
                    "wal_flush_batches requires model_out: the delta "
                    "log lives in <model_out>.wal/")
            if not self.store.hashed:
                raise ValueError(
                    "wal_flush_batches requires the hashed store "
                    "(hash_capacity > 0): dictionary slots are assigned "
                    "at consume time, so a replayed delta has no stable "
                    "row space to land in")
            if self.mesh is not None:
                raise ValueError(
                    "wal_flush_batches is single-host/flat-device only: "
                    "mesh and multi-host runs mutate rows through the "
                    "SPMD exchange, outside the dispatch path the WAL "
                    "observes")
            if self.store.tier is not None:
                raise ValueError(
                    "wal_flush_batches is incompatible with "
                    "cold_tier_rows: tier promotes/demotes rewrite rows "
                    "off the dispatch path, so replay would miss them")
            if self.store.param.evict_occupancy > 0:
                raise ValueError(
                    "wal_flush_batches is incompatible with "
                    "evict_occupancy: epoch-boundary eviction resets "
                    "rows outside the dispatch path the WAL observes")
            if p.device_dedup:
                raise ValueError(
                    "wal_flush_batches is incompatible with "
                    "device_dedup: panel_raw payloads derive slots "
                    "in-step and carry no host slots section to log")
            if p.device_cache_mb:
                log.info("wal_flush_batches: forcing device_cache_mb=0 "
                         "(HBM-replayed batches bypass the WAL's "
                         "dispatch hook)")
                self.param = p = dataclasses.replace(p, device_cache_mb=0)
            from ..durability.wal import WalWriter, wal_dir
            self._wal = WalWriter(wal_dir(p.model_out), 0,
                                  self.store.wal_geometry())
            self._wal_fail_c = REGISTRY.counter(
                "wal_append_failures_total",
                "WAL segment appends that failed (window retained and "
                "retried at the next flush boundary)")
        if p.replica_peers and p.model_out:
            from ..durability.replicate import Replicator, parse_peers
            self._replica = Replicator(
                parse_peers(p.replica_peers), p.replica_k, 0,
                root=os.path.dirname(p.model_out) or ".")

    # -------------------------------------------------------------- run
    def _init_run_state(self) -> None:
        """Per-run state the epoch loop depends on: the metrics flusher
        and the report accumulator. Shared by run() and the online
        trainer (online/trainer.py), which drives _run_epoch once per
        sealed log segment."""
        p = self.param
        self._start_time = time.monotonic()
        if p.metrics_path and self._flusher is None:
            self._flusher = MetricsFlusher(
                p.metrics_path, p.metrics_interval_s,
                registries=[self.obs, REGISTRY],
                max_mb=p.metrics_max_mb).start()
        self._report = ReportProg()
        self._last_nnz = 0.0
        self._last_row_t = time.monotonic()

    def run(self) -> None:
        """RunScheduler (sgd_learner.cc:52-122)."""
        p = self.param
        self._init_run_state()
        pre_loss, pre_val_auc = 0.0, 0.0
        k = 0
        if p.auto_resume and p.model_out:
            resumed = self._try_resume()
            if resumed is not None:
                k = resumed + 1
                log.info("auto-resumed from epoch %d checkpoint", resumed)
        if k == 0 and p.model_in:
            if p.load_epoch >= 0:
                log.info("loading model from epoch %d", p.load_epoch)
                self.store.load(self._model_name(p.model_in, p.load_epoch),
                                weights_only=False)
                k = p.load_epoch + 1
            else:
                log.info("loading latest model...")
                self.store.load(self._model_name(p.model_in, -1),
                                weights_only=False)
        while k < p.max_num_epochs:
            train_prog = Progress()
            self._run_epoch(k, K_TRAINING, train_prog)
            train_prog.penalty, train_prog.nnz_w = self._eval_scalars
            log.info("epoch[%d] training: %s, nnz(w) = %g, penalty = %g",
                     k, train_prog.text(), train_prog.nnz_w,
                     train_prog.penalty)
            # occupancy eviction: at the epoch boundary only
            n_evicted = self.store.maybe_evict()
            if n_evicted:
                log.info("epoch[%d] evicted %d rows under occupancy "
                         "pressure", k, n_evicted)
            val_prog = Progress()
            if p.data_val:
                self._run_epoch(k, K_VALIDATION, val_prog)
                log.info("epoch[%d] validation: %s", k, val_prog.text())
            for cb in self.epoch_end_callbacks:
                cb(k, train_prog, val_prog)
            if p.ckpt_interval > 0 and p.model_out \
                    and (k + 1) % p.ckpt_interval == 0:
                self._save_checkpoint(k)
            # stop criteria (sgd_learner.cc:92-110): no zero guard on
            # pre_loss in the reference, so the first epoch never stops
            eps = abs(train_prog.loss - pre_loss) / pre_loss \
                if pre_loss else float("inf")
            if eps < p.stop_rel_objv:
                log.info("change of loss [%g] < stop_rel_objv [%g]",
                         eps, p.stop_rel_objv)
                break
            if val_prog.auc > 0:
                eps = (val_prog.auc - pre_val_auc) / val_prog.nrows
                if eps < p.stop_val_auc:
                    log.info("change of val AUC [%g] < stop_val_auc [%g]",
                             eps, p.stop_val_auc)
                    break
            k += 1
            if k >= p.max_num_epochs:
                log.info("reached max_num_epochs %d", p.max_num_epochs)
                break
            pre_loss, pre_val_auc = train_prog.loss, val_prog.auc
        if p.model_out:
            log.info("saving final model...")
            final = self._model_name(p.model_out, -1)
            self.store.save(final, p.has_aux)
            if self._replica is not None:
                self._replica.push(sorted(stream.glob(final + "*")))
        if self.store.fs_count > 1 or self.store.hashed:
            # the per-shard occupancy gauges, read once at the run's end
            self.store.publish_shard_stats()
        self.stop()

    def stop(self) -> None:
        if self._replica is not None:
            # drain the push queue: the last commit's replica is the one a
            # disk-loss recovery needs
            self._replica.close()
            self._replica = None
        if self._flusher is not None:
            self._flusher.close()
            self._flusher = None

    @staticmethod
    def _model_name(prefix: str, it: int) -> str:
        """``<prefix>[_iter-k]_part-0`` (ModelName, sgd_learner.h:65-69)."""
        return prefix + (f"_iter-{it}" if it >= 0 else "") + "_part-0"

    # ----------------------------------------------------- checkpoints
    def _meta_path(self) -> str:
        return self.param.model_out + ".meta"

    def _save_checkpoint(self, epoch: int) -> None:
        """Commit one resumable generation: the table WITH its optimizer
        state at ``<model_out>_iter-<epoch>_part-0`` (manifest stamped
        with the epoch and the family's next generation), then the
        ``.meta`` marker, written last, so a crash mid-save resumes from
        the previous complete epoch; ``ckpt_keep`` > 0 prunes all but the
        newest that many generations, never the WAL chain's live base nor
        an epoch a replica push is still copying. With the durability
        legs on, the open WAL window is sealed first, the chain is rooted
        at the new generation, and the generation's files are pushed to
        the peers."""
        p = self.param
        if self._wal is not None:
            self._wal_flush()
        path = self._model_name(p.model_out, epoch)
        self.store.save(path, save_aux=True, epoch=epoch)
        with stream.open_stream(self._meta_path(), "w") as f:
            f.write(json.dumps({"last_epoch": epoch}))
        if p.ckpt_keep > 0:
            mft.prune_checkpoints(
                p.model_out, p.ckpt_keep,
                protect=self._durability_protected_epochs())
        if self._wal is not None or self._replica is not None:
            gen = int((mft.read(path) or {}).get("generation", 0))
            if self._wal is not None:
                self._wal.rebase(gen, epoch)
            if self._replica is not None:
                self._replica.push(
                    sorted(stream.glob(path + "*")) + [self._meta_path()],
                    generation=gen, epoch=epoch)

    def _durability_protected_epochs(self) -> set:
        """Epochs ``ckpt_keep`` must not retire now: the base of the live
        WAL chain and the epochs a replica push still copies."""
        prot: set = set()
        if self._wal is not None and self._wal.base_epoch is not None:
            prot.add(self._wal.base_epoch)
        if self._replica is not None:
            prot |= self._replica.protected_epochs()
        return prot

    def _try_resume(self) -> Optional[int]:
        """``auto_resume``: the last completed epoch, or None. With the
        durability legs off, the newest local checkpoint that verifies
        (:meth:`_try_resume_base`); with one on, the recovery ladder
        (durability/recover.py), which may arm ``_wal_skip``; its
        recovery stamp goes to the peers with the family (the JAX learner
        leaves the stamp local, so its peers' scrub always repairs it)."""
        if self._wal is None and not self.param.replica_peers:
            got = self._try_resume_base()
            return got[0] if got is not None else None
        from ..durability import recover
        resumed = recover.run_ladder(self)
        if self._replica is not None:
            self._replica.push([self.param.model_out + ".recovery.json"])
        return resumed

    def _try_resume_base(self) -> Optional[Tuple[int, str]]:
        """Load the newest interval checkpoint that verifies: (completed
        epoch, its path), or None. Candidates come from the ``.meta``
        marker AND a scan of the ``_iter-*`` files (a crash can leave a
        torn part behind the marker, or a marker naming bytes that never
        finished); each load requires its manifest, and a corrupt
        generation is logged and skipped, walking back to the newest good
        one."""
        base = self.param.model_out
        epochs = set()
        try:
            with stream.open_stream(self._meta_path(), "r") as f:
                epochs.add(int(json.loads(f.read())["last_epoch"]))
        except (OSError, ValueError, KeyError):
            pass
        parts = [q for q in stream.glob(base + "_iter-*_part-*")
                 if re.search(r"_iter-(\d+)_part-\d+$", q)]
        for q in parts:
            epochs.add(int(re.search(r"_iter-(\d+)_part-", q).group(1)))
        for epoch in sorted(epochs, reverse=True):
            for path in stream.glob(f"{base}_iter-{epoch}_part-*"):
                if not re.search(r"_part-\d+$", path):
                    continue
                try:
                    self.store.load(path, weights_only=False,
                                    require_manifest=True)
                    return epoch, path
                except FileNotFoundError:
                    continue
                except mft.CheckpointCorrupt as e:
                    log.warning("auto_resume: %s; walking back", e)
        if epochs:
            log.warning("checkpoint meta/parts found but no generation "
                        "verified; starting fresh")
        return None

    # ----------------------------------------------------------- epochs
    def _run_epoch(self, epoch: int, job_type: int, prog: Progress) -> None:
        n_jobs = (self.param.num_jobs_per_epoch if job_type == K_TRAINING
                  else 1)
        self._iterate_parts(job_type, epoch, n_jobs, prog)

    def _make_reader(self, job_type: int, epoch: int, g_idx: int,
                     g_num: int):
        p = self.param
        if job_type == K_TRAINING:
            # the shuffle and sampling streams vary across epochs and parts
            return BatchReader(p.data_in, p.data_format, g_idx, g_num,
                               p.batch_size, p.batch_size * p.shuffle,
                               p.neg_sampling,
                               seed=epoch * max(g_num, 1) + g_idx)
        return Reader(p.data_val or p.data_in, p.data_format, g_idx, g_num,
                      chunk_bytes=256 << 20)

    def _cached_uri(self, job_type: int) -> Optional[str]:
        """The job's pre-localized rec cache (``data_format=rec`` whose
        members carry ``uniq``), or None: a cache that is not localized
        reads through the Reader like text. Warns once per uri when its
        members dwarf the batch, since every batch then pays a
        re-compaction (data/cached.py)."""
        p = self.param
        if p.data_format.lower() != "rec":
            return None
        uri = p.data_in if job_type == K_TRAINING \
            else (p.data_val or p.data_in)
        if uri not in self._cache_probe:
            try:
                ok, member_rows = cache_probe(uri)
            except FileNotFoundError:
                ok, member_rows = False, 0
            if ok and member_rows > 4 * p.batch_size:
                log.warning(
                    "rec cache %s has %d-row members but batch_size=%d: "
                    "every batch pays an O(nnz) re-compaction; re-convert "
                    "with batch_size=%d (or rec_batch_size=%d) for "
                    "batch-aligned members", uri, member_rows,
                    p.batch_size, p.batch_size, p.batch_size)
            self._cache_probe[uri] = ok
        return uri if self._cache_probe[uri] else None

    def _part_reports(self, job_type: int) -> bool:
        return job_type == K_TRAINING and self.param.report_interval > 0

    def _row_due(self, job_type: int) -> bool:
        """A part boundary prints a progress row once ``report_interval``
        seconds have passed since the last one."""
        return (self._part_reports(job_type)
                and time.monotonic() - self._last_row_t
                >= self.param.report_interval)

    def _get_cache(self, job_type: int) -> Optional[_DeviceBatchCache]:
        """The replay cache of this job type, or None: ``device_cache_mb``
        0 turns it off, and training with ``neg_sampling != 1`` resamples
        every epoch, so its batches cannot be replayed."""
        p = self.param
        # a staged batch would freeze routes the cold tier later moves
        if p.device_cache_mb <= 0 or self.store.tier is not None or (
                job_type == K_TRAINING and p.neg_sampling != 1.0):
            return None
        if job_type not in self._caches:
            # the dictionary store repads its staged pads after a growth;
            # under a mesh the staged routes would go stale with the shard
            # bounds, so it stages in its second pass and never repads
            dict_single = not self.store.hashed and self.mesh is None
            self._caches[job_type] = _DeviceBatchCache(
                p.device_cache_mb, shared=self._cache_pool,
                repadable=dict_single,
                stage_after_pass=0 if (self.store.hashed or dict_single)
                else 1)
        return self._caches[job_type]

    def device_cache_info(self) -> dict:
        """Replay-cache coverage per job type after a run: ``complete``
        means later epochs replay entirely from the card, ``frozen`` that
        the budget filled mid-staging (a staged prefix replays, the rest
        streams)."""
        return {jt: {"complete": bool(c.ready and c.alive and not c.frozen),
                     "frozen": bool(c.frozen and c.entries),
                     "staged_parts": len(c.entries),
                     "staged_mb": round(c.used / (1 << 20), 1)}
                for jt, c in self._caches.items()}

    # ------------------------------------------------ streamed pipeline
    def stage_stats(self) -> dict:
        """The streamed pipeline's seconds per stage over the run, read
        from the registry (``stage_seconds_total{stage}``, producer
        worker processes included), plus the transport the last streamed
        training pass ran on."""
        series = self.obs.snapshot().get("counters", {}).get(
            "stage_seconds_total", {})
        vals = {dict(k).get("stage", ""): v for k, v in series.items()}
        out = {k + "_s": round(vals.get(k, 0.0), 3) for k in _STAGES}
        out["producer_mode"] = self._last_producer_mode
        return out

    def _resolve_producer_mode(self) -> str:
        """``auto`` -> process on hosts with >= 4 cores, thread below (the
        spawn and the ring only pay where cores can overlap)."""
        mode = self.param.producer_mode
        if mode == "auto":
            mode = "process" if (os.cpu_count() or 1) >= 4 else "thread"
        return mode

    def _absorb_payload_caps(self, job: str, payload: Payload) -> None:
        """Fold the caps a worker process packed at into the consumer's
        sticky schedule, so later epochs' workers start from them."""
        wkey = ".w" if payload.layout in ("panel", "panel_raw") else ".nnz"
        caps = {job + ".b": payload.b_cap, job + wkey: payload.d2,
                job + ".u": payload.u_cap}
        if payload.layout == "coo":
            caps[job + ".row"] = payload.row_cap
        self._shapes.absorb(caps)

    def _iterate_parts(self, job_type: int, epoch: int, n_jobs: int,
                       prog: Progress) -> None:
        """IterateData (sgd_learner.cc:201-317) over this epoch's parts in
        order: a ready replay cache replays its staged parts, and the
        parts it does not hold stream through the producer pool (and are
        staged on the cache's first pass)."""
        p = self.param
        if job_type == K_TRAINING and self._wal is not None:
            # a new delta window per training epoch, numbered (epoch,
            # step): a replayed chain names the exact batch it recovered
            # to. _wal_skip survives this reset.
            self._wal_epoch = epoch
            self._wal_step = 0
            self._wal_lo = 0
            self._wal_touched = []
        cache = self._get_cache(job_type)
        stream_parts = list(range(n_jobs))
        if cache is not None and cache.ready:
            stale = (cache.capacity is not None
                     and (cache.stale_pads
                          or cache.capacity != self.store.state.capacity))
            if stale and cache.repadable:
                self._repad_cache(cache)
                stale = False
            if stale:
                cache.invalidate("store capacity changed since staging")
            else:
                self._replay_cached(job_type, epoch, cache, prog)
                if not cache.partial:
                    return
                cached = cache.parts()
                stream_parts = [q for q in stream_parts if q not in cached]
        is_train = job_type == K_TRAINING
        # the epoch-0 count push exists for the embeddings' activation;
        # the flat table has none (the JAX learner's do_embedding)
        push_cnt = is_train and epoch == 0 and self.loss.V_dim > 0
        job = "train" if is_train else "eval"
        dim_min = self._dim_min
        b_cap = bucket(p.batch_size, dim_min) if is_train else None
        hashed = self.store.hashed
        n_workers = p.num_producers or max(1, min(4, os.cpu_count() or 1))
        # the producers' fast paths, engaged as in the JAX learner:
        # stream_chunks only while no cache may stage (staging builds the
        # same layout on the device); device_dedup only past the count
        # push, while no cache may stage and stream_chunks is off (the
        # chunked layout needs the host inverse)
        # neither engages under the cold tier, which rewrites each
        # payload's host slot section (capacity/tier.route_payload)
        # nor under a mesh, whose batches carry host-made shard routes
        # and a dp-divisible chunk count (the JAX learner's hashed_fast)
        cache_may_stage = (cache is not None and cache.alive
                           and not cache.frozen)
        tier_on = self.store.tier is not None
        flat = self.mesh is None
        stream_chunk = (is_train and hashed and p.stream_chunks
                        and not cache_may_stage and not tier_on and flat)
        device_dedup = (is_train and hashed and p.device_dedup
                        and not stream_chunk and not cache_may_stage
                        and not push_cnt and not tier_on and flat)
        hash_capacity = self.store.param.hash_capacity
        admit_min_count = self.store.param.admit_min_count
        parse_c, pack_c = self._stage_c["parse"], self._stage_c["pack"]

        def packed(part, fn, *args, **kw):
            t0 = time.perf_counter()
            with trace.span("producer.pack", part=part):
                out = fn(*args, **kw)
            pack_c.inc(time.perf_counter() - t0)
            return out

        cached_uri = self._cached_uri(job_type)

        def make_iter(part):
            # the hashed store is stateless: hash, dedup and pack here;
            # the dictionary inserts into host state, so only the compact
            # runs here (a cache's members come compacted) and the
            # consumer maps the keys
            if cached_uri is not None:
                rdr = CachedBatchReader(
                    cached_uri, part, n_jobs, p.batch_size,
                    shuffle=is_train and p.shuffle > 0,
                    neg_sampling=p.neg_sampling if is_train else 1.0,
                    seed=epoch * max(n_jobs, 1) + part,
                    need_counts=push_cnt)
                for sub, uniq, cnts in timed_reader(rdr, parse_c, part):
                    if hashed:
                        yield ("ready", sub, packed(
                            part, prepare_from_uniq, self._shapes,
                            hash_capacity, sub, uniq, cnts, push_cnt,
                            push_cnt, dim_min, job, b_cap,
                            stream_chunk=stream_chunk))
                    else:
                        yield ("compact", sub, (sub, uniq, cnts))
                return
            # count-min admission of the training stream, per (seed,
            # epoch, part): the twin of spec_iter's in worker processes
            admit = make_admission(hash_capacity, admit_min_count,
                                   self.store.param.seed, epoch,
                                   part) if is_train else None
            reader = self._make_reader(job_type, epoch, part, n_jobs)
            for blk in timed_reader(reader, parse_c, part):
                if hashed:
                    yield ("ready", blk, packed(
                        part, prepare_hashed, self._shapes, hash_capacity,
                        blk, push_cnt, push_cnt, dim_min, job, b_cap,
                        stream_chunk=stream_chunk,
                        device_dedup=device_dedup, admit=admit))
                else:
                    yield ("compact", blk, packed(
                        part, compact, blk, need_counts=push_cnt))

        wp = WorkloadPool(WorkloadPoolParam(
            straggler_timeout=p.straggler_timeout))
        # worker processes and the ring on the hashed store's training
        # pass while no cache stages (a staged batch would pin its ring
        # slot for good); producer threads otherwise
        use_process = (self._resolve_producer_mode() == "process"
                       and is_train and hashed and bool(stream_parts)
                       and (cache is None or not cache.staging))
        if is_train:
            self._last_producer_mode = ("process" if use_process
                                        else "thread")
        if use_process:
            spec = StreamSpec(
                parts=tuple(stream_parts), n_jobs=n_jobs, data_in=p.data_in,
                data_format=p.data_format, batch_size=p.batch_size,
                shuffle=p.shuffle, neg_sampling=p.neg_sampling,
                epoch=epoch, hash_capacity=hash_capacity,
                want_counts=push_cnt, fill_counts=push_cnt, dim_min=dim_min,
                job=job, b_cap=b_cap, stream_chunk=stream_chunk,
                device_dedup=device_dedup, caps=self._shapes.snapshot(),
                trace_id=trace.trace_id(), cached_uri=cached_uri,
                admit_min_count=admit_min_count,
                admit_seed=self.store.param.seed)
            slot_mb = p.ring_slot_mb or max(1, (p.batch_size * 320) >> 20)
            pool = ProcessProducerPool(
                len(stream_parts), functools.partial(spec_iter, spec),
                n_workers=n_workers, depth=p.producer_depth, pool=wp,
                slot_bytes=slot_mb << 20, obs_registry=self.obs)
        else:
            pool = OrderedProducerPool(
                len(stream_parts), lambda i: make_iter(stream_parts[i]),
                n_workers=n_workers, depth=p.producer_depth, pool=wp,
                obs_registry=self.obs)
        pending: list = []
        cur_part = stream_parts[0] if stream_parts else 0
        before = Progress(nrows=prog.nrows, loss=prog.loss, auc=prog.auc)
        # process mode: an item's arrays VIEW its ring slot, and on the
        # CPU the staged tensors alias them too. Of the pool's
        # HELD_LEASES, one is the staged lookahead batch's; the newest
        # others are held past their steps' dispatch, and a lease is
        # released only after the step that read its views has finished
        # (a CUDA event recorded after the step is its fence; a CPU step
        # has finished when its dispatch returns)
        inflight: collections.deque = collections.deque()
        dev_is_cuda = self.store.device.type == "cuda"

        def retire(keep: int) -> None:
            while len(inflight) > keep:
                lease, fence = inflight.popleft()
                if fence is not None:
                    fence.synchronize()
                lease.release()

        # a ready batch's buffers go to the device when it arrives, its
        # step one iteration later (part, item, lease)
        lookahead: collections.deque = collections.deque()

        def dispatch_entry(entry) -> None:
            e_part, e_item, e_lease = entry
            with trace.span("consumer.dispatch", part=e_part):
                self._dispatch_item(job_type, e_item, push_cnt, pending,
                                    cache, e_part)
            if e_lease is not None:
                fence = None
                if dev_is_cuda:
                    fence = torch.cuda.Event()
                    fence.record()
                inflight.append((e_lease, fence))
                retire(keep=HELD_LEASES - 1)

        items = iter(pool)
        try:
            for i, item in items:
                part = stream_parts[i]
                if part != cur_part:
                    # drain the lookahead so the part's row counts all
                    # of its batches
                    while lookahead:
                        dispatch_entry(lookahead.popleft())
                    cur_part = part
                    if self._row_due(job_type):
                        self._merge_pending(pending, prog)
                        pending = []
                        self._report_part(job_type, before, prog)
                        before = Progress(nrows=prog.nrows, loss=prog.loss,
                                          auc=prog.auc)
                lease = pool.pop_lease() if use_process else None
                if item[0] == "ready":
                    if use_process:
                        self._absorb_payload_caps(job, item[2])
                    staged = ("ready", item[1],
                              self._stage_payload(item[2]))
                    lookahead.append((part, staged, lease))
                    while len(lookahead) > 1:
                        dispatch_entry(lookahead.popleft())
                else:
                    # the dictionary maps on this thread, in receive order
                    while lookahead:
                        dispatch_entry(lookahead.popleft())
                    dispatch_entry((part, item, lease))
                if len(pending) >= self._MERGE_CAP:
                    self._merge_pending(pending, prog)
                    pending = []
            while lookahead:
                dispatch_entry(lookahead.popleft())
            if is_train and self._wal is not None:
                # seal the epoch with a boundary segment, even an empty
                # one: replay reads it as "this epoch completed"
                self._wal_flush(boundary=True)
            self._final_merge(job_type, pending, prog)
            retire(keep=0)
        finally:
            items.close()
        self._report_part(job_type, before, prog)
        if cache is not None:
            cache.finish_pass()

    def _stage_payload(self, payload: Payload) -> _DevPayload:
        """Copy a packed payload's buffers to the device (the transfer
        stage); the returned payload holds device tensors. On the CPU they
        alias the host arrays.

        The cold tier's one routing point: the host payload's logical
        slots become device rows here (capacity/tier.route_payload,
        promoting and demoting on this thread, timed into
        ``tier_route_s``/``tier_routes``) before the copy. With the WAL on,
        the batch's slot section is kept on the host (``host_slots``) for
        the touched-row window."""
        t0 = time.perf_counter()
        dev = self.store.device
        if self.store.tier is not None:
            from ..capacity.tier import route_payload
            payload = route_payload(self.store.tier, payload)
            self.tier_route_s += time.perf_counter() - t0
            self.tier_routes += 1
        off = payload.b_cap * payload.d2 if payload.layout == "panel" \
            else 2 * payload.d2
        if self._wal is not None and payload.layout in ("panel", "coo"):
            payload = payload._replace(
                host_slots=payload.i32[off:off + payload.u_cap].copy())

        def to_dev(a):
            return None if a is None else torch.from_numpy(a).to(dev)

        route = None
        if self.mesh is not None and payload.layout in ("panel", "coo"):
            # the slot vector's shard runs, from its host copy: the fs + 1
            # offsets stay on the host, the local slots ride to the card
            from ..parallel.sharded import plan_slots
            offsets, local = plan_slots(
                payload.i32[off:off + payload.u_cap],
                self.store.state.capacity, self.store.fs_count)
            route = (offsets, to_dev(local))
        out = _DevPayload(*payload._replace(
            i32=to_dev(payload.i32), f32=to_dev(payload.f32),
            chunks=None if payload.chunks is None
            else tuple(to_dev(a) for a in payload.chunks)), route=route)
        self._stage_c["transfer"].inc(time.perf_counter() - t0)
        return out

    def _dispatch_item(self, job_type: int, item, push_cnt: bool,
                       pending: list, cache: Optional[_DeviceBatchCache],
                       part: int) -> None:
        """Run one produced batch: a ready payload (already staged) steps
        as it is; a dictionary block maps its keys here (inserting, and so
        growing the table, before this batch is padded), packs the same
        layouts and steps."""
        kind, blk, payload = item
        if kind == "compact":
            cblk, uniq, cnts = payload
            slots, remap, cnts = self.store.map_keys_dedup(uniq, cnts)
            if remap is not None:
                cblk = dataclasses.replace(
                    cblk, index=remap[cblk.index].astype(np.uint32))
            job = "train" if job_type == K_TRAINING else "eval"
            payload = self._stage_payload(pack_mapped(
                self._shapes, blk, cblk, slots, cnts,
                self.store.state.capacity, self._dim_min, job))
        self._dispatch_prepared(job_type, blk, payload, push_cnt, pending,
                                cache, part)

    def _dispatch_prepared(self, job_type: int, blk, payload: Payload,
                           push_cnt: bool, pending: list,
                           cache: Optional[_DeviceBatchCache],
                           part: int) -> None:
        """Run the step of one staged payload; while the cache stages, a
        panel training batch first gets its chunked-run layout (built on
        the device) and takes the chunked backward, and the batch is kept,
        its counts section zeroed so that a replay never counts again."""
        is_train = job_type == K_TRAINING
        if is_train and self._wal is not None and self._wal_skip > 0:
            # recovery fast-forward: WAL replay already applied this
            # batch's effects, and the data order is deterministic, so the
            # skipped prefix is exactly the replayed one
            self._wal_skip -= 1
            self._wal_step += 1
            self._wal_lo = self._wal_step
            return
        i32, f32 = payload.i32, payload.f32
        staging = cache is not None and cache.staging
        chunks = payload.chunks
        if staging and is_train and payload.layout == "panel" \
                and chunks is None:
            cells = payload.b_cap * payload.d2
            chunks = panel_chunk_tokens_flat(
                i32[:cells], None if payload.binary else f32[:cells],
                payload.u_cap, payload.b_cap, payload.d2,
                dp_div=self.param.mesh_dp if self.mesh is not None else 1)
        staged = _Staged(payload.layout, i32, f32, payload.b_cap,
                         payload.d2, payload.u_cap, payload.row_cap,
                         payload.binary, blk.size, chunks, payload.route)
        self._dispatch_staged(job_type, staged, push_cnt, pending)
        if is_train and self._wal is not None:
            self._wal_touch(payload)
        if staging:
            if push_cnt:
                f32[f32.shape[0] - payload.u_cap:] = 0.0
            # what the card really holds for the batch: its buffers, its
            # chunk layout and, under a mesh, its local slots (one copy:
            # a batch is not replicated across the mesh's devices)
            nbytes = i32.nbytes + f32.nbytes + sum(
                t.nbytes for t in chunks or () if t is not None)
            if payload.route is not None:
                nbytes += payload.route[1].nbytes
            cache.add(part, staged, nbytes,
                      capacity=self.store.state.capacity)

    def _wal_touch(self, payload: Payload) -> None:
        """Record the slots a dispatched training batch touched, from the
        host copy of its slot section (no device read); OOB pad lanes are
        dropped. Seals the window every ``wal_flush_batches`` steps."""
        if payload.host_slots is None:
            raise RuntimeError(
                f"WAL cannot observe layout {payload.layout!r}: no host "
                "slots section")
        sl = payload.host_slots
        self._wal_touched.append(sl[sl < self.store.state.capacity])
        self._wal_step += 1
        if self._wal_step - self._wal_lo >= self.param.wal_flush_batches:
            self._wal_flush()

    def _wal_flush(self, boundary: bool = False) -> None:
        """Seal the open window as one segment: gather the touched rows'
        current values (the log stores values, not deltas) and append. A
        failed append keeps the window, so the next flush logs its slots
        at that window's end: a transient failure widens the loss bound
        and never breaks the chain."""
        if self._wal is None \
                or (self._wal_step == self._wal_lo and not boundary):
            return
        if self._wal_touched:
            touched = np.unique(np.concatenate(self._wal_touched))
            arrays = self.store.wal_touched_rows(touched)
        else:
            touched = np.zeros(0, np.int32)
            arrays = {}
        try:
            path = self._wal.append(touched, arrays, self._wal_epoch,
                                    self._wal_lo, self._wal_step,
                                    boundary=boundary)
        except OSError as e:   # FaultInjected is an OSError
            self._wal_fail_c.inc()
            log.warning("wal append failed (%s); window retained to the "
                        "next flush", e)
            return
        self._wal_lo = self._wal_step
        self._wal_touched = []
        if path is not None and self._replica is not None:
            self._replica.push([path], generation=self._wal.generation,
                               epoch=self._wal.base_epoch)

    def _dispatch_staged(self, job_type: int, st: _Staged, push_cnt: bool,
                         pending: list) -> None:
        """Run the step of one batch already on the device, timed into the
        step stage and ``train_step_seconds``; its table row traffic goes
        to ``store_gather_bytes_total``."""
        per_dir = gather_bytes(self.store.param, self.store.state.capacity,
                               st.u_cap)
        is_train = job_type == K_TRAINING
        self._gather_c.inc(per_dir * (2 if is_train else 1))
        t0 = time.perf_counter()
        try:
            self._dispatch_step(job_type, st, push_cnt, pending)
        finally:
            dt = time.perf_counter() - t0
            self._stage_c["step"].inc(dt)
            self._step_h.observe(dt)

    def _dispatch_step(self, job_type: int, st: _Staged, push_cnt: bool,
                       pending: list) -> None:
        """The step: the epoch-0 count push goes first, as in the JAX step
        program (sgd.py:651-654); a raw-token panel (device_dedup) derives
        its slot vector and inverse map on the device first, as JAX's
        ``packed_panel_train_raw`` (sgd.py:704-722). The step reads the
        staged buffers and writes only the table. It traverses the
        ``step.device`` fault point first (step.fire_step_fault)."""
        fire_step_fault()
        if st.layout == "panel_raw":
            cells = st.b_cap * st.d2
            batch = unpack_panel_raw(st.i32, st.f32, st.b_cap, st.d2,
                                     binary=st.binary)
            slots, inverse, n = dedup_tokens(st.i32[:cells], st.u_cap,
                                             self.store.state.capacity)
            batch = batch._replace(idx=inverse.view(st.b_cap, st.d2),
                                   num_uniq=n)
            counts = None
        elif st.layout == "panel":
            batch, slots, counts = unpack_panel(
                st.i32, st.f32, st.b_cap, st.d2, st.u_cap,
                has_counts=push_cnt, binary=st.binary)
            if st.chunks is not None:
                ci, cl, cv = st.chunks
                batch = batch._replace(chunk_idx=ci, chunk_lane=cl,
                                       chunk_vals=cv)
        else:
            batch, slots, counts = unpack_batch(
                st.i32, st.f32, st.b_cap, st.d2, st.u_cap, st.row_cap,
                binary=st.binary, has_counts=push_cnt)
        if st.route is not None:
            slots = ShardedSlots(slots, st.route[1], st.route[0])
        if job_type == K_TRAINING:
            if counts is not None:
                self.store.state = self.store.fns.apply_count(
                    self.store.state, slots, counts)
            self.store.state, objv, auc = self._train_step(
                self.store.state, batch, slots)
        else:
            _, objv, auc = self._eval_step(self.store.state, batch, slots)
        pending.append((st.nrows, objv, auc))

    def _replay_cached(self, job_type: int, epoch: int,
                       cache: _DeviceBatchCache, prog: Progress) -> None:
        """A replayed epoch: the staged batches, each part's in a
        ``RandomState(epoch)`` permutation when training shuffles, with
        no host-to-device copy and no count push."""
        p = self.param
        is_train = job_type == K_TRAINING
        pending: list = []
        cur_part = 0
        before = Progress(nrows=prog.nrows, loss=prog.loss, auc=prog.auc)
        for part, staged in cache.iter_parts(is_train and p.shuffle > 0,
                                             seed=epoch):
            if part != cur_part:
                cur_part = part
                if self._row_due(job_type):
                    self._merge_pending(pending, prog)
                    pending = []
                    self._report_part(job_type, before, prog)
                    before = Progress(nrows=prog.nrows, loss=prog.loss,
                                      auc=prog.auc)
            self._dispatch_staged(job_type, staged, False, pending)
            if len(pending) >= self._MERGE_CAP:
                self._merge_pending(pending, prog)
                pending = []
        if cache.partial:
            # streamed parts follow: the epoch's (penalty, nnz) belong to
            # its end
            self._merge_pending(pending, prog)
        else:
            self._final_merge(job_type, pending, prog)
        self._report_part(job_type, before, prog)

    def _repad_cache(self, cache: _DeviceBatchCache) -> None:
        """Rewrite each staged batch's out-of-bounds slot pads for the live
        capacity. Dictionary slots never move when the table grows, but
        the pads ``capacity-at-pack-time + i`` fall in bounds after a
        growth and would alias real rows (and repeat slots the kernels
        take as unique). ``num_uniq`` rides the batch's meta lanes, so the
        rewrite stays on the device; the sizes and the budget are
        unchanged."""
        cap = self.store.state.capacity
        for items in cache.entries.values():
            for st in items:
                off, u = st.slots_offset, st.u_cap
                nu = st.i32[off + u + 1]
                j = torch.arange(u, dtype=torch.int32, device=st.i32.device)
                seg = st.i32[off:off + u]
                seg.copy_(torch.where(j < nu, seg, cap + j - nu))
        cache.capacity = cap
        cache.stale_pads = False
        log.info("device cache repadded to capacity %d", cap)

    def _final_merge(self, job_type: int, pending: list,
                     prog: Progress) -> None:
        """The epoch-final metric fetch; a training epoch fetches the
        store's (penalty, nnz) in the same transfer."""
        extra = self.store.evaluate_dev() if job_type == K_TRAINING else ()
        vals = self._merge_pending(pending, prog, extra=extra)
        if extra:
            self._eval_scalars = (vals[0], vals[1])

    def _merge_pending(self, pending: list, prog: Progress,
                       extra=()) -> list:
        """Fetch the held metric scalars (and ``extra`` device scalars) in
        ONE transfer and merge them; returns the extras' values."""
        extra = list(extra)
        if not pending and not extra:
            return []
        t0 = time.perf_counter()
        vals = torch.stack([s.to(torch.float32) for _, o, a in pending
                            for s in (o, a)]
                           + [e.to(torch.float32) for e in extra]).cpu()
        vals = vals.tolist()
        self._stage_c["step"].inc(time.perf_counter() - t0)
        for i, (nrows, _, _) in enumerate(pending):
            self._rows_c.inc(nrows)
            prog.merge(Progress(nrows=nrows, loss=vals[2 * i],
                                auc=vals[2 * i + 1]))
        return vals[2 * len(pending):]

    def _report_part(self, job_type: int, before: Progress,
                     prog: Progress) -> None:
        """A progress row after a part (sgd_learner.cc:242-247), with the
        store's nnz(w) delta folded in."""
        if not self._part_reports(job_type):
            return
        self._last_row_t = time.monotonic()
        delta = Progress(nrows=prog.nrows - before.nrows,
                         loss=prog.loss - before.loss,
                         auc=prog.auc - before.auc)
        _, nnz = self.store.evaluate()
        delta.nnz_w = nnz - self._last_nnz
        self._last_nnz = nnz
        elapsed = time.monotonic() - self._start_time
        self._report.prog.merge(delta)
        print(f"{elapsed:5.0f}  {self._report.print_str()}", flush=True)
