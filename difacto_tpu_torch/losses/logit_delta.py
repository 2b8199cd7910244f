"""Delta-form logistic loss for block coordinate descent (counterpart of
difacto_tpu/losses/logit_delta.py; the reference's LogitLossDelta,
src/loss/logit_loss_delta.h), over feature-major data and per-block
delta weights.

- :func:`delta_grad`: the first-order gradient g = X'p with
  p = -y/(1+exp(y·pred)) and the diagonal Hessian h = (X∘X)'(τ(1-τ))
  (logit_loss_delta.h:90-151, compute_hession=1), as two block-local
  columns of one [nf_cap, 2] tensor;
- :func:`delta_pred_update`: pred += X·Δw (logit_loss_delta.h:63-72).

A slice's COO rows are ascending over its real entries and padded with
row 0, column 0 and value 0 at the tail, so they are not ascending as a
whole, and ops/segment.segment_sum (which relies on that) does not
apply. Both reductions go through ops/segment.lane_sum instead, with no
atomics, in the order of XLA's CPU scatter-add as the JAX learner jits
them: ``delta_grad`` sums each feature's entries in ascending entry
order from 0; in ``delta_pred_update`` XLA scatters straight into
``pred``, so each row's sum starts from its ``pred`` (passed as the
row's first entry) and adds its entries in order. On the CPU
``delta_pred_update`` equals the jitted JAX function bit for bit, and
``delta_grad`` differs from it only by the ulps of ``exp``; on the card
two runs give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.segment import lane_sum


class BlockSlice(NamedTuple):
    """COO slice of one row tile restricted to one feature block; cols
    are block-local feature indices, padding has vals == 0."""
    rows: torch.Tensor  # i32[nnz_cap]
    cols: torch.Tensor  # i32[nnz_cap]
    vals: torch.Tensor  # f32[nnz_cap]


def delta_grad(pred: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               blk: BlockSlice, nf_cap: int) -> torch.Tensor:
    """[nf_cap, 2]: (g, h) over the block's features."""
    y = torch.where(labels > 0, 1.0, -1.0)
    p = -y / (1.0 + torch.exp(y * pred)) * mask
    p2 = -p * (y * mask + p)          # tau(1-tau), zero on padding rows
    rows = blk.rows.long()
    return lane_sum(torch.stack([blk.vals * p[rows],
                                 blk.vals ** 2 * p2[rows]], dim=1),
                    blk.cols, nf_cap)


def delta_pred_update(pred: torch.Tensor, blk: BlockSlice,
                      d: torch.Tensor) -> torch.Tensor:
    """pred + X_blk Δw, each row summed from its pred."""
    b = pred.shape[0]
    lanes = torch.cat([torch.arange(b, dtype=blk.rows.dtype,
                                    device=pred.device), blk.rows])
    data = torch.cat([pred, blk.vals * d[blk.cols.long()]])
    return lane_sum(data[:, None], lanes, b)[:, 0]
