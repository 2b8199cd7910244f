"""Factorization-machine and logistic losses (counterpart of
difacto_tpu/losses/fm.py).

The loss receives the batch's already-gathered parameter rows — w[U] and
V[U, k] for the batch's U distinct features — plus an activation mask
``v_mask`` (1.0 where the embedding exists and is not l1-shrunk away).

Forward (the reference's fm_loss.h:43,67-119):
    pred = X w + 0.5 * sum((X V)^2 - (X.X)(V.V), axis=1), clamped to ±20

Backward (fm_loss.h:124-126,148-203), with p = -y / (1 + exp(y pred)) * rw:
    gw = X' p
    gV = X' diag(p) X V - diag((X.X)' p) V        (masked by v_mask)

Two batch layouts: COO (:class:`~..ops.batch.DeviceBatch`) and the
fixed-width panel (:class:`~..ops.batch.PanelBatch`). Every sum has a
fixed order, so a step gives the same bits on every run (no atomics):

- the COO forward sums each row left to right over its own entries
  (ops/segment.py), so a row's score does not depend on the other rows of
  its batch;
- the panel forward sums each row's F columns in column order, JAX's
  column loop (``fm.py:144-158``);
- both backwards sum each slot lane's contributions in ascending entry
  order (ops/segment.lane_sum), XLA's CPU scatter-add order;
- the chunked-run panel backward (batches the replay cache staged with
  ops/batch.panel_chunk_tokens) sums each chunk's L tokens, then each
  lane's chunk partials in chunk order (ops/segment.chunk_sum).

The row reductions over the k embedding columns take their own order, and
``exp`` is torch's, so the port agrees with the JAX package within a
float32 tolerance. Logistic loss is the V_dim=0 case (V=None).

Under a mesh's ``dp`` axis (``dp > 1``) the backward's per-slot sums are
the data-parallel part: the per-entry (COO), per-cell (panel) or
per-chunk (chunked panel) contributions are computed as on one device,
cut into ``dp`` equal blocks along that leading axis (the JAX package's
``batch_sharding``, ``P('dp')``), each block reduced to per-lane partials
and the partials summed in dp order (:func:`dp_reduce`: a fixed order, no
atomics, so a run repeats bit for bit). The forward is
per row, so it runs once over the batch: its bits are each block's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.batch import DeviceBatch, PanelBatch
from ..ops.segment import (chunk_sum, lane_sum, row_sum, segment_sum, spmv,
                           spmv_t)

PRED_CLAMP = 20.0


def dp_reduce(reduce, data: torch.Tensor, lanes: torch.Tensor, U: int,
              dp: int = 1) -> torch.Tensor:
    """``reduce(data, lanes, U)`` (ops/segment.lane_sum or chunk_sum) over
    ``dp`` equal leading-axis blocks, the per-lane partials summed in dp
    order. ``dp == 1`` is the plain reduction."""
    if dp == 1:
        return reduce(data, lanes, U)
    n = data.shape[0]
    if n % dp:
        raise ValueError(f"leading axis {n} does not split over dp={dp} "
                         "(size the caps with ops.batch.mesh_dim_min)")
    m = n // dp
    red = None
    for b in range(dp):
        part = reduce(data[b * m:(b + 1) * m], lanes[b * m:(b + 1) * m], U)
        red = part if red is None else red + part
    return red


class FMParams(NamedTuple):
    """Gathered per-batch parameter rows."""
    w: torch.Tensor                     # f32[U]
    V: Optional[torch.Tensor] = None    # [U, k] or None (pure LR)
    v_mask: Optional[torch.Tensor] = None  # f32[U]; None == all active


def fm_predict_xv(params: FMParams, batch: DeviceBatch
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(pred[B], XV[B,k] or None); padding rows produce garbage — mask at
    use sites. With embeddings, the spmv of w and the two spmm's of the
    JAX package share ONE segment sum over the concatenated columns
    [x·w | x·V | x²·V²] (the same per-column sums, a third of the
    launches)."""
    B = batch.batch_cap
    vals, rows, cols = batch.vals, batch.rows, batch.cols
    if params.V is None or params.V.shape[1] == 0:
        pred = spmv(vals, rows, cols, params.w, B, batch.row_cap)
        return torch.clamp(pred, -PRED_CLAMP, PRED_CLAMP), None
    cw = (vals * params.w[cols])[:, None]
    k = params.V.shape[1]
    vm = params.v_mask if params.v_mask is not None \
        else torch.ones_like(params.w)
    Vm = params.V * vm[:, None]
    t = Vm[cols]
    sums = segment_sum(
        torch.cat([cw, vals[:, None] * t, (vals ** 2)[:, None] * (t ** 2)],
                  dim=1), rows, B, batch.row_cap)
    XV, XXVV = sums[:, 1:1 + k], sums[:, 1 + k:]
    pred = sums[:, 0] + 0.5 * row_sum(XV ** 2 - XXVV)
    return torch.clamp(pred, -PRED_CLAMP, PRED_CLAMP), XV


def fm_predict(params: FMParams, batch: DeviceBatch) -> torch.Tensor:
    return fm_predict_xv(params, batch)[0]


def _vmask(params: FMParams) -> torch.Tensor:
    return torch.ones_like(params.w) if params.v_mask is None \
        else params.v_mask


def _p_vector(pred: torch.Tensor, batch) -> torch.Tensor:
    """p = -y/(1+exp(y*pred)) * row_weight, zeroed on padding rows."""
    y = torch.where(batch.labels > 0, 1.0, -1.0)
    p = -y / (1.0 + torch.exp(y * pred))
    return p * batch.rweight * batch.row_mask


def fm_grad(params: FMParams, batch: DeviceBatch, pred: torch.Tensor,
            xv: Optional[torch.Tensor] = None, dp: int = 1
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """COO backward -> (gw[U], gV[U, k] or None). The three transposed
    products share one lane sum over [x p XV | x p | x^2 p]; ``xv`` is the
    forward's X·V (None recomputes it). ``dp`` > 1 sums the entries' lane
    sums over dp blocks of the nonzeros (:func:`dp_reduce`)."""
    U = params.w.shape[0]
    vals, rows, cols = batch.vals, batch.rows, batch.cols
    p = _p_vector(pred, batch)
    if params.V is None or params.V.shape[1] == 0:
        if dp == 1:
            return spmv_t(vals, rows, cols, p, U), None
        return dp_reduce(lane_sum, (vals * p[rows])[:, None], cols, U,
                         dp)[:, 0], None
    k = params.V.shape[1]
    vm = _vmask(params)
    Vm = params.V * vm[:, None]
    XV = xv if xv is not None else segment_sum(
        vals[:, None] * Vm[cols], rows, batch.batch_cap, batch.row_cap)
    pr = p[rows]
    contrib = torch.cat([vals[:, None] * (p[:, None] * XV)[rows],
                         (vals * pr)[:, None], (vals ** 2 * pr)[:, None]],
                        dim=1)
    red = dp_reduce(lane_sum, contrib, cols, U, dp)
    t1, gw, xxp = red[:, :k], red[:, k], red[:, k + 1]
    gV = (t1 - xxp[:, None] * Vm) * vm[:, None]
    return gw, gV


def fm_predict_panel_xv(params: FMParams, pb: PanelBatch
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Panel forward: one gather of combined [w | V] rows (V's container
    dtype, as in JAX: bf16 rows gather w as bf16 too) and, per row, the
    F columns summed in column order into f32 — JAX's column loop, as one
    sequential segment sum. Returns (pred, XV)."""
    B, F = pb.idx.shape
    if params.V is None or params.V.shape[1] == 0:
        wc = params.w[pb.idx]
        if pb.vals is not None:
            wc = wc * pb.vals
        return torch.clamp(_columns_in_order(wc[:, :, None])[:, 0],
                           -PRED_CLAMP, PRED_CLAMP), None
    dt = params.V.dtype
    k = params.V.shape[1]
    Vm = params.V * _vmask(params).to(dt)[:, None]
    wv = torch.cat([params.w.to(dt)[:, None], Vm], dim=1)
    tok = wv[pb.idx]                                   # [B, F, 1+k]
    wc, t = tok[:, :, :1].to(torch.float32), tok[:, :, 1:]
    if pb.vals is not None:
        wc = wc * pb.vals[:, :, None]
        t = t * pb.vals[:, :, None].to(dt)
    t = t.to(torch.float32)
    sums = _columns_in_order(torch.cat([wc, t, t * t], dim=2))
    XV, XXVV = sums[:, 1:1 + k], sums[:, 1 + k:]
    pred = sums[:, 0] + 0.5 * torch.sum(XV * XV - XXVV, dim=1)
    return torch.clamp(pred, -PRED_CLAMP, PRED_CLAMP), XV


def _columns_in_order(cells: torch.Tensor) -> torch.Tensor:
    """[B, F, m] -> [B, m]: 0 + cells[:, 0] + cells[:, 1] + ... ."""
    B, F, m = cells.shape
    lengths = torch.full((B,), F, dtype=torch.int64, device=cells.device)
    return torch.segment_reduce(cells.reshape(B * F, m), "sum",
                                lengths=lengths, axis=0, unsafe=True)


def fm_predict_panel(params: FMParams, pb: PanelBatch) -> torch.Tensor:
    return fm_predict_panel_xv(params, pb)[0]


def _chunk_tokens(rowq: torch.Tensor, chunk_idx: torch.Tensor
                  ) -> torch.Tensor:
    """rowq[chunk_idx] ([B, m] -> [C, L, m]) with the pad slots (row
    ``B``) reading 0, as JAX's gather with mode="fill"."""
    ext = torch.cat([rowq, rowq.new_zeros((1, rowq.shape[1]))])
    return ext[chunk_idx.long()]


def _fm_grad_panel_chunked(params: FMParams, pb: PanelBatch,
                           p: torch.Tensor, xv: Optional[torch.Tensor],
                           sorted_chunks: bool = True, dp: int = 1
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Chunked-run backward (``pb.chunk_*`` set): each chunk's L token
    rows of the row quantities (p XV | p) are gathered and summed to one
    partial, times x (and x^2 for xxp) on valued panels; the partials sum
    per lane in chunk order (ops/segment.chunk_sum). Binary panels share
    one column for gw and xxp (x == x^2). The JAX package's
    ``_fm_grad_panel_chunked``; the sum over a chunk's L tokens is
    torch's reduction, XLA's order may differ, so the two agree within a
    float32 tolerance."""
    U = params.w.shape[0]
    cv = pb.chunk_vals

    def csum(partial, lanes, n):
        return chunk_sum(partial, lanes, n, sorted_chunks)

    if params.V is None or params.V.shape[1] == 0:
        toks = _chunk_tokens(p[:, None], pb.chunk_idx)[:, :, 0]  # [C, L]
        if cv is not None:
            toks = toks * cv
        gw = dp_reduce(csum, torch.sum(toks, dim=1)[:, None],
                       pb.chunk_lane, U, dp)[:, 0]
        return gw, None
    k = params.V.shape[1]
    vm = _vmask(params)
    Vm = (params.V * vm.to(params.V.dtype)[:, None]).to(torch.float32)
    rowq = torch.cat([p[:, None] * xv, p[:, None]], dim=1)     # [B, k+1]
    toks = _chunk_tokens(rowq, pb.chunk_idx)                   # [C, L, k+1]
    if cv is None:
        red = dp_reduce(csum, torch.sum(toks, dim=1), pb.chunk_lane, U, dp)
        t1, gw = red[:, :k], red[:, k]
        xxp = gw
    else:
        v = cv[:, :, None]
        partial = torch.cat([torch.sum(toks * v, dim=1),
                             torch.sum(toks[:, :, k:] * (v * v), dim=1)],
                            dim=1)                             # [C, k+2]
        red = dp_reduce(csum, partial, pb.chunk_lane, U, dp)
        t1, gw, xxp = red[:, :k], red[:, k], red[:, k + 1]
    gV = (t1 - xxp[:, None] * Vm) * vm[:, None]
    return gw, gV


def fm_grad_panel(params: FMParams, pb: PanelBatch, pred: torch.Tensor,
                  xv: Optional[torch.Tensor] = None,
                  sorted_chunks: bool = True, dp: int = 1
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Panel backward: each cell contributes broadcasts of its row's
    (p XV | p | p) times (x | x | x^2), rounded to V's container dtype as
    in JAX, and ONE lane sum in ascending cell order gives (t1 | gw |
    xxp). A batch that carries the chunked-run layout takes
    :func:`_fm_grad_panel_chunked`."""
    U = params.w.shape[0]
    B, F = pb.idx.shape
    p = _p_vector(pred, pb)
    if pb.chunk_lane is not None:
        if params.V is not None and params.V.shape[1] > 0 and xv is None:
            _, xv = fm_predict_panel_xv(params, pb)
        return _fm_grad_panel_chunked(params, pb, p, xv, sorted_chunks, dp)
    flat_idx = pb.idx.reshape(B * F)
    if params.V is None or params.V.shape[1] == 0:
        cell = p[:, None].expand(B, F)
        if pb.vals is not None:
            cell = cell * pb.vals
        return dp_reduce(lane_sum, cell.reshape(B * F, 1), flat_idx, U,
                         dp)[:, 0], None
    k = params.V.shape[1]
    vm = _vmask(params)
    Vm = params.V * vm.to(params.V.dtype)[:, None]
    if xv is None:
        t = Vm[pb.idx]
        if pb.vals is not None:
            t = t * pb.vals[:, :, None].to(t.dtype)
        xv = torch.sum(t.to(torch.float32), dim=1)
    Vm = Vm.to(torch.float32)
    rowq = torch.cat([p[:, None] * xv, p[:, None], p[:, None]], dim=1)
    contrib = rowq[:, None, :].expand(B, F, k + 2)
    if pb.vals is not None:
        v3 = pb.vals[:, :, None]
        contrib = contrib * torch.cat([v3.expand(B, F, k + 1), v3 * v3],
                                      dim=2)
    contrib = contrib.to(params.V.dtype).to(torch.float32)
    red = dp_reduce(lane_sum, contrib.reshape(B * F, k + 2), flat_idx, U,
                    dp)
    t1, gw, xxp = red[:, :k], red[:, k], red[:, k + 1]
    gV = (t1 - xxp[:, None] * Vm) * vm[:, None]
    return gw, gV


def logit_objv(pred: torch.Tensor, batch) -> torch.Tensor:
    """sum log(1 + exp(-y*pred)) over real rows, not averaged
    (include/difacto/loss.h:57-66)."""
    y = torch.where(batch.labels > 0, 1.0, -1.0)
    per_row = torch.log1p(torch.exp(-y * pred))
    return torch.sum(per_row * batch.row_mask)
