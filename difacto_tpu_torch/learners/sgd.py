"""SGD learner: the minibatch FM trainer (counterpart of
difacto_tpu/learners/sgd.py; the reference's SGDLearner,
src/sgd/sgd_learner.{h,cc}).

Per batch: host read + hash + dedup + pack (data/pack_stream.py), one copy
of the two packed buffers to the device, on epoch 0 the count push, then
the train step (step.py: one gather kernel, FM forward and backward, one
scatter kernel with the FTRL/AdaGrad epilogue, in place on the table).
Metric scalars stay on the device and are fetched in one transfer at part
boundaries when a progress row is due, every ``_MERGE_CAP`` batches, and
at epoch end together with the store's (penalty, nnz).

The scheduler is the JAX package's (RunScheduler, sgd_learner.cc:52-122):
epoch loop with training and validation jobs, relative-objective and
validation-AUC early stopping, model load and save, epoch-end callbacks,
progress rows. Parts are read in a plain serial loop: this port has no
producer pool, so the knobs that only set its speed are accepted and
logged, and the knobs that change what is computed raise when set.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import KWArgs, Param
from ..data.batch_reader import BatchReader
from ..data.pack_stream import Payload, ShapeSchedule, prepare_hashed
from ..data.reader import Reader
from ..losses import create as create_loss
from ..ops.batch import bucket, unpack_batch, unpack_panel
from ..step import make_step_fns
from ..store.local import SlotStore
from ..updaters.sgd_updater import SGDUpdaterParam
from ..utils.progress import Progress, ReportProg
from .base import Learner

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


# knobs that only set the speed of the JAX package's producer pool and
# replay cache: accepted, and the port streams every epoch serially
_SPEED_ONLY = ("device_cache_mb", "num_producers", "producer_mode",
               "producer_depth", "ring_slot_mb", "straggler_timeout")
# knobs that change what is computed, with the ROADMAP.md item that ports
# them; a non-default value raises
_NOT_PORTED = {
    "stream_chunks": "Queue 1: stream_chunks",
    "device_dedup": "Queue 1: device_dedup",
    "ckpt_interval": "Queue 1: interval checkpoints and auto_resume",
    "auto_resume": "Queue 1: interval checkpoints and auto_resume",
    "wal_flush_batches": "Queue 1: durability",
    "replica_peers": "Queue 1: durability",
    "mesh_force": "Queue 1: sharding",
    "metrics_path": "Queue 1: observability",
}


class SGDLearner(Learner):
    # dispatched batches whose metrics are held on the device before a
    # merge fetches them
    _MERGE_CAP = 256

    def __init__(self, device="cuda") -> None:
        super().__init__()
        self.device = device
        self.param: Optional[SGDLearnerParam] = None
        self.store: Optional[SlotStore] = None

    # ----------------------------------------------------------- init
    def init(self, kwargs: KWArgs) -> KWArgs:
        self.param, remain = SGDLearnerParam.init_allow_unknown(kwargs)
        uparam, remain = SGDUpdaterParam.init_allow_unknown(remain)
        p = self.param
        defaults = SGDLearnerParam()
        for knob, item in _NOT_PORTED.items():
            if getattr(p, knob) != getattr(defaults, knob):
                raise NotImplementedError(
                    f"{knob}={getattr(p, knob)!r} is not ported yet "
                    f"(ROADMAP.md, {item})")
        if p.bounded_delay > 0:
            raise NotImplementedError(
                "bounded_delay > 0 is not ported yet (ROADMAP.md, Queue 1: "
                "sharding)")
        if p.task != 0:
            raise NotImplementedError(
                "the learner's prediction job is task=pred on the CLI "
                "(difacto_tpu_torch.__main__.run_pred)")
        self.loss = create_loss(p.loss, uparam.V_dim)
        if self.loss.V_dim == 0:
            raise NotImplementedError(
                "loss=logit / V_dim=0 (the flat table's push) is not ported "
                "yet (ROADMAP.md, Queue 1: loss=logit)")
        log.info("%s: not ported, streams every epoch", ", ".join(
            f"{k}={getattr(p, k)}" for k in _SPEED_ONLY))
        if p.mesh_fs * p.mesh_dp > 1:
            log.info("mesh_dp=%d mesh_fs=%d ignored: the port trains on one "
                     "card", p.mesh_dp, p.mesh_fs)
        self.store = SlotStore(uparam, device=self.device)
        self._shapes = ShapeSchedule()
        _, self._train_step, self._eval_step = make_step_fns(
            self.store.fns, self.loss, train_auc=p.train_auc)
        return remain

    # -------------------------------------------------------------- run
    def run(self) -> None:
        """RunScheduler (sgd_learner.cc:52-122)."""
        p = self.param
        self._start_time = time.monotonic()
        self._report = ReportProg()
        self._last_nnz = 0.0
        self._last_row_t = time.monotonic()
        pre_loss, pre_val_auc = 0.0, 0.0
        k = 0
        if p.model_in:
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
            val_prog = Progress()
            if p.data_val:
                self._run_epoch(k, K_VALIDATION, val_prog)
                log.info("epoch[%d] validation: %s", k, val_prog.text())
            for cb in self.epoch_end_callbacks:
                cb(k, train_prog, val_prog)
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
            self.store.save(self._model_name(p.model_out, -1), p.has_aux)
        self.stop()

    @staticmethod
    def _model_name(prefix: str, it: int) -> str:
        """``<prefix>[_iter-k]_part-0`` (ModelName, sgd_learner.h:65-69)."""
        return prefix + (f"_iter-{it}" if it >= 0 else "") + "_part-0"

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

    def _part_reports(self, job_type: int) -> bool:
        return job_type == K_TRAINING and self.param.report_interval > 0

    def _row_due(self, job_type: int) -> bool:
        """A part boundary prints a progress row once ``report_interval``
        seconds have passed since the last one."""
        return (self._part_reports(job_type)
                and time.monotonic() - self._last_row_t
                >= self.param.report_interval)

    def _iterate_parts(self, job_type: int, epoch: int, n_jobs: int,
                       prog: Progress) -> None:
        """IterateData (sgd_learner.cc:201-317) over this epoch's parts in
        order, one batch at a time."""
        p = self.param
        is_train = job_type == K_TRAINING
        push_cnt = is_train and epoch == 0
        job = "train" if is_train else "eval"
        b_cap = bucket(p.batch_size, 8) if is_train else None
        C = self.store.param.hash_capacity
        pending: list = []
        before = Progress(nrows=prog.nrows, loss=prog.loss, auc=prog.auc)
        for part in range(n_jobs):
            if part and self._row_due(job_type):
                self._merge_pending(pending, prog)
                pending = []
                self._report_part(job_type, before, prog)
                before = Progress(nrows=prog.nrows, loss=prog.loss,
                                  auc=prog.auc)
            for blk in self._make_reader(job_type, epoch, part, n_jobs):
                payload = prepare_hashed(self._shapes, C, blk, push_cnt,
                                         push_cnt, 8, job, b_cap)
                self._dispatch_prepared(job_type, blk, payload, push_cnt,
                                        pending)
                if len(pending) >= self._MERGE_CAP:
                    self._merge_pending(pending, prog)
                    pending = []
        extra = self.store.evaluate_dev() if is_train else ()
        vals = self._merge_pending(pending, prog, extra=extra)
        if is_train:
            self._eval_scalars = (vals[0], vals[1])
        self._report_part(job_type, before, prog)

    def _dispatch_prepared(self, job_type: int, blk, payload: Payload,
                           push_cnt: bool, pending: list) -> None:
        """Copy one packed batch to the device and run its step; the
        epoch-0 count push goes first, as in the JAX step program
        (sgd.py:651-654)."""
        dev = self.store.device
        i32 = torch.from_numpy(payload.i32).to(dev)
        f32 = torch.from_numpy(payload.f32).to(dev)
        if payload.layout == "panel":
            batch, slots, counts = unpack_panel(
                i32, f32, payload.b_cap, payload.d2, payload.u_cap,
                has_counts=push_cnt, binary=payload.binary)
        else:
            batch, slots, counts = unpack_batch(
                i32, f32, payload.b_cap, payload.d2, payload.u_cap,
                payload.row_cap, binary=payload.binary, has_counts=push_cnt)
        if job_type == K_TRAINING:
            if counts is not None:
                self.store.state = self.store.fns.apply_count(
                    self.store.state, slots, counts)
            self.store.state, objv, auc = self._train_step(
                self.store.state, batch, slots)
        else:
            _, objv, auc = self._eval_step(self.store.state, batch, slots)
        pending.append((blk.size, objv, auc))

    def _merge_pending(self, pending: list, prog: Progress,
                       extra=()) -> list:
        """Fetch the held metric scalars (and ``extra`` device scalars) in
        ONE transfer and merge them; returns the extras' values."""
        extra = list(extra)
        if not pending and not extra:
            return []
        vals = torch.stack([s.to(torch.float32) for _, o, a in pending
                            for s in (o, a)]
                           + [e.to(torch.float32) for e in extra]).cpu()
        vals = vals.tolist()
        for i, (nrows, _, _) in enumerate(pending):
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
