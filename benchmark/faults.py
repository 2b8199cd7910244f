"""Faults planted under the timed path, to show that the check catches
them: each takes the built learner and breaks the program underneath it
for the whole run."""

from __future__ import annotations

import torch


def unchanged_state(learner) -> None:
    """Every push returns the table as it was."""
    fns = learner.store.fns
    fns.apply_grad_rows = lambda state, *a, **kw: state


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


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_loss": altered_loss}
