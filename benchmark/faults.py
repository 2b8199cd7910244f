"""Faults planted under the timed path, to show that the check catches
them: each takes the built learner and breaks the program underneath it
for the whole run. Also the flat table's lower-precision control, which
the program has no switch for."""

from __future__ import annotations

import torch


def unchanged_state(learner) -> None:
    """Every push returns the table as it was: the fused rows' push and
    the flat table's."""
    fns = learner.store.fns
    fns.apply_grad_rows = lambda state, *a, **kw: state
    fns.apply_grad = lambda state, *a, **kw: state


def half_batch(learner) -> None:
    """Half of each batch's real rows left out, the rest weighted twice:
    the mean taken over what is left."""
    step = learner._train_step

    def broken(state, batch, slots):
        b = batch.row_mask.shape[0]
        keep = torch.arange(b, device=batch.row_mask.device) \
            < batch.num_rows // 2
        return step(state, batch._replace(
            row_mask=batch.row_mask * keep, rweight=batch.rweight * 2),
            slots)

    learner._train_step = broken


def altered_loss(learner) -> None:
    """Each step's objective altered by 1% where it is produced."""
    step = learner._train_step

    def broken(state, batch, slots):
        state, objv, auc = step(state, batch, slots)
        return state, objv * 1.01, auc

    learner._train_step = broken


def bf16_flat(learner) -> None:
    """The flat V_dim 0 table held in bfloat16: after every gradient push
    its columns w, z and sqrt_g are rounded to bf16 in place."""
    fns = learner.store.fns
    if fns.has_V:
        raise ValueError("bf16_flat rounds the flat V_dim 0 table; the "
                         "fused rows' control is slot_dtype bf16")
    push = fns.apply_grad

    def rounded(state, *a, **kw):
        state = push(state, *a, **kw)
        for col in (state.w, state.z, state.sqrt_g):
            col.copy_(col.to(torch.bfloat16))
        return state

    fns.apply_grad = rounded


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_loss": altered_loss}


def control(conf: dict):
    """(name, overrides, planted) of the lower-precision control of a
    configuration as run: the program's own bf16 fused rows where
    ``V_dim`` > 0, the planted bf16 rounding of the flat table at 0."""
    if int(conf["V_dim"]) > 0:
        return "control_bf16", {"slot_dtype": "bf16"}, None
    return "control_bf16_flat", None, bf16_flat
