"""Loss factory (counterpart of difacto_tpu/losses/__init__.py; the
reference's Loss::Create, src/loss/loss.cc:13-26). ``create("fm" |
"logit", V_dim)``; "logit" forces V_dim = 0."""

from __future__ import annotations

from dataclasses import dataclass

from . import metrics
from ..ops.batch import PanelBatch
from .fm import (FMParams, fm_grad, fm_grad_panel, fm_predict,
                 fm_predict_panel, fm_predict_panel_xv, fm_predict_xv,
                 logit_objv)


@dataclass(frozen=True)
class LossSpec:
    """Loss dispatch on the batch layout: PanelBatch takes the panel
    forward/backward, DeviceBatch the COO ones. ``chunks_sorted`` says
    that a chunked panel's ``chunk_lane`` ascends (true of every layout
    on one card; a data-parallel batch concatenated from per-rank blocks
    would not be). ``dp`` > 1 (a mesh's data-parallel degree) sums the
    backward's per-slot partials over dp blocks of the batch's leading
    axes (losses/fm.dp_reduce)."""
    name: str
    V_dim: int
    chunks_sorted: bool = True
    dp: int = 1

    def predict(self, params: FMParams, batch):
        if isinstance(batch, PanelBatch):
            return fm_predict_panel(params, batch)
        return fm_predict(params, batch)

    def predict_xv(self, params: FMParams, batch):
        """(pred, XV or None): the forward and its X·V, which calc_grad
        reuses so the train step gathers the token rows once."""
        if isinstance(batch, PanelBatch):
            return fm_predict_panel_xv(params, batch)
        return fm_predict_xv(params, batch)

    def calc_grad(self, params: FMParams, batch, pred, xv=None):
        if isinstance(batch, PanelBatch):
            return fm_grad_panel(params, batch, pred, xv,
                                 self.chunks_sorted, self.dp)
        return fm_grad(params, batch, pred, xv, self.dp)

    def evaluate(self, pred, batch):
        return logit_objv(pred, batch)


def create(name: str, V_dim: int = 0) -> LossSpec:
    name = name.lower()
    if name == "logit":
        return LossSpec("logit", 0)
    if name == "fm":
        return LossSpec("fm", V_dim)
    raise ValueError(f"unknown loss type: {name!r}")


__all__ = ["FMParams", "fm_predict", "fm_predict_xv", "fm_grad",
           "fm_predict_panel", "fm_predict_panel_xv", "fm_grad_panel",
           "logit_objv", "LossSpec", "create", "metrics"]
