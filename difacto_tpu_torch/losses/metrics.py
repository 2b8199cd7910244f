"""Binary classification metrics (counterpart of
difacto_tpu/losses/metrics.py): the device AUCs (exact for validation and
serving, binned for the training step) and the host (numpy) helpers of
the BCD learner's progress.

The reference's conventions (src/loss/bin_class_metric.h:35-57): AUC is
returned as area * n with the < 0.5 flip, not divided by the example
count (progress merging sums it across jobs).

Names: the JAX package calls its numpy AUC ``auc_times_n`` and its device
one ``auc_times_n_jnp``. Here the device (torch) AUC has held the name
``auc_times_n`` since the serving slice, so the numpy one is
``auc_times_n_np``, beside ``logit_objv_np``; ``accuracy_times_n`` keeps
its name.
"""

from __future__ import annotations

import numpy as np
import torch


def auc_times_n(label: torch.Tensor, pred: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Exact rank-sum AUC x n over masked rows; padding rows must have
    mask == 0 (they sort to the end and are excluded from the counts)."""
    key = torch.where(mask > 0, pred, torch.full_like(pred, float("inf")))
    order = torch.argsort(key, stable=True)
    lab_o, mask_o = label[order], mask[order] > 0
    lab = (lab_o > 0) & mask_o
    neg = (lab_o <= 0) & mask_o
    cum_tp = torch.cumsum(lab.to(torch.int32), dim=0)
    npos = cum_tp[-1].to(torch.float32)
    n = torch.sum(mask)
    nneg = n - npos
    area = torch.sum(torch.where(neg, cum_tp.to(torch.float32),
                                 torch.zeros_like(pred)))
    area = area / torch.clamp(npos * nneg, min=1.0)
    area = torch.where(area < 0.5, 1.0 - area, area) * n
    return torch.where((npos == 0) | (nneg == 0),
                       torch.ones_like(area), area)


def auc_times_n_binned(label: torch.Tensor, pred: torch.Tensor,
                       mask: torch.Tensor, bins: int = 4096) -> torch.Tensor:
    """Histogram AUC x n, O(B + bins): predictions (clamped to +-20 by
    every loss) fall into linear bins over [-20.5, 20.5]; pairs in one bin
    count half. The bin counts are sums of 0/1 values, exact in f32 in any
    order, so the scatter-adds here are deterministic."""
    lo, hi = -20.5, 20.5
    dev = pred.device
    # a fill, not a copy from the host: the train step makes no
    # host-to-device copy of its own
    scale = torch.full((), bins / (hi - lo), dtype=torch.float32, device=dev)
    b = torch.clamp(((pred - lo) * scale).to(torch.int32), 0, bins - 1)
    is_pos = ((label > 0) & (mask > 0)).to(torch.float32)
    is_neg = ((label <= 0) & (mask > 0)).to(torch.float32)
    pos = torch.zeros(bins, dtype=torch.float32, device=dev).index_add_(
        0, b, is_pos)
    neg = torch.zeros(bins, dtype=torch.float32, device=dev).index_add_(
        0, b, is_neg)
    npos, nneg = torch.sum(pos), torch.sum(neg)
    cum_pos_below = torch.cumsum(pos, dim=0) - pos
    area = torch.sum(neg * (cum_pos_below + 0.5 * pos))
    area = area / torch.clamp(npos * nneg, min=1.0)
    n = npos + nneg
    area = torch.where(area < 0.5, 1.0 - area, area) * n
    return torch.where((npos == 0) | (nneg == 0), torch.ones_like(area),
                       area)


def auc_times_n_np(label: np.ndarray, pred: np.ndarray) -> float:
    """Rank-sum AUC x n on the host (the JAX package's numpy
    ``auc_times_n``)."""
    n = len(label)
    if n == 0:
        return 0.0
    order = np.argsort(pred, kind="stable")
    lab = label[order] > 0
    cum_tp = np.cumsum(lab)
    npos = cum_tp[-1]
    if npos == 0 or npos == n:
        return 1.0
    area = float(cum_tp[~lab].sum())
    area /= npos * (n - npos)
    return (1.0 - area if area < 0.5 else area) * n


def accuracy_times_n(label: np.ndarray, pred: np.ndarray,
                     threshold: float = 0.0) -> float:
    """Correct predictions at ``threshold``, with the reference's flip
    when fewer than half are right."""
    correct = float(np.sum((label > 0) == (pred > threshold)))
    n = len(label)
    return correct if correct > 0.5 * n else n - correct


def logit_objv_np(label: np.ndarray, pred: np.ndarray) -> float:
    """sum log(1 + exp(-y pred)) in float64."""
    y = np.where(label > 0, 1.0, -1.0)
    return float(np.sum(np.log1p(np.exp(-y * pred.astype(np.float64)))))
