"""The train, eval and predict steps (counterpart of difacto_tpu/step.py).

A train step is the JAX package's fused dataflow written out as torch
ops: ONE gather of the batch's fused rows (the CUDA gather kernel on the
card), FM forward, objective, training AUC, backward, and the
FTRL/AdaGrad push of those same gathered rows through the CUDA scatter
kernel, in place on the table. The gather is never repeated: the rows go
from the pull to the push. On the card the next step's gather is queued
after this step's push on the same stream. The flat ``V_dim=0`` table
(loss=logit) has no fused row: its step pulls w with a plain gather and
pushes FTRL through plain scatters of the w/z/sqrt_g columns, as the
JAX package's "off" backend does for it.

``task=pred`` and ``task=serve`` run :func:`make_predict_fn` through
serve/executor.py, which is what makes their scores bit-identical for the
same rows.

Under a ``(dp, fs)`` mesh (parallel/mesh.py) the same functions run: a
``slots`` argument that is a parallel.sharded.ShardedSlots makes the pull
and the push one kernel launch per non-empty key-range shard run
(updaters/sgd_updater.make_fns), and a loss with ``dp > 1`` sums the
backward's per-slot partials over dp blocks of the batch in dp order
(losses/fm.dp_reduce) before the one push per shard. The JAX step's
``state_constrainer`` (pinning the returned state to its fs layout
inside the jitted program) has no counterpart beyond that placement: the
push writes each shard in place, so the table never leaves its layout.
"""

from __future__ import annotations

import torch

from .losses import FMParams, LossSpec
from .losses.metrics import auc_times_n, auc_times_n_binned


def make_step_fns(fns, loss: LossSpec, train_auc: str = "binned"):
    """(forward, train_step, eval_step) over (state, batch, slots).
    ``train_auc`` picks the training metric: "binned" (histogram),
    "exact" (sort), "none". Validation always takes the exact AUC."""

    def pull(state, slots):
        if not fns.has_V:
            w, _, _ = fns.get_rows(state, slots)
            return FMParams(w=w), None
        rows = fns.pull_rows(state, slots)
        w, V, vmask = fns.rows_to_params(state, rows)
        return FMParams(w=w, V=V, v_mask=vmask), rows

    def forward(state, batch, slots):
        params, _ = pull(state, slots)
        pred = loss.predict(params, batch)
        objv = loss.evaluate(pred, batch)
        auc = auc_times_n(batch.labels, pred, batch.row_mask)
        return params, pred, objv, auc

    def train_step(state, batch, slots):
        params, rows = pull(state, slots)
        pred, xv = loss.predict_xv(params, batch)
        objv = loss.evaluate(pred, batch)
        if train_auc == "binned":
            auc = auc_times_n_binned(batch.labels, pred, batch.row_mask)
        elif train_auc == "exact":
            auc = auc_times_n(batch.labels, pred, batch.row_mask)
        else:
            auc = torch.zeros((), dtype=torch.float32, device=pred.device)
        gw, gV = loss.calc_grad(params, batch, pred, xv)
        if gV is None:
            state = fns.apply_grad(state, slots, gw, None, None)
        else:
            state = fns.apply_grad_rows(state, slots, rows, gw.contiguous(),
                                        gV.contiguous(), params.v_mask)
        return state, objv, auc

    def eval_step(state, batch, slots):
        _, pred, objv, auc = forward(state, batch, slots)
        return pred, objv, auc

    return forward, train_step, eval_step


def fire_step_fault() -> None:
    """The ``step.device`` fault point (utils/faultinject.py), traversed
    on the host once per dispatched step, before its kernels launch.
    ``err`` stands for a poisoned program or a lost device surfacing at
    dispatch: it raises the OSError-derived ``FaultInjected`` the IO
    paths use, and every armed fire counts into
    ``faults_fired_total{point,kind}``."""
    from .utils import faultinject
    faultinject.act_default(faultinject.fire("step.device"))


def make_predict_fn(fns, loss: LossSpec):
    """(state, batch, slots) -> (pred, objv, auc), all device tensors."""

    def predict_step(state, batch, slots):
        w, V, vmask = fns.get_rows(state, slots)
        params = FMParams(w=w, V=V, v_mask=vmask)
        pred = loss.predict(params, batch)
        objv = loss.evaluate(pred, batch)
        auc = auc_times_n(batch.labels, pred, batch.row_mask)
        return pred, objv, auc

    return predict_step
