"""Binary classification metrics (counterpart of
difacto_tpu/losses/metrics.py, the device AUCs: exact for validation and
serving, binned for the training step).

The reference's conventions (src/loss/bin_class_metric.h:35-57): AUC is
returned as area * n with the < 0.5 flip, not divided by the example
count (progress merging sums it across jobs).
"""

from __future__ import annotations

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
