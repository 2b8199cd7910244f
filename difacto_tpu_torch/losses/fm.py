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
  lane's chunk partials in chunk order (ops/segment.chunk_sum). On the
  card, with embeddings (up to 510 columns), ``dp == 1`` and no
  ``plane``, it is one hand-written kernel entry
  (``ops/fused.fm_chunk_grad_cuda``, ``ops/csrc/fm_chunk_grad.cu``): a
  chunk's L tokens in slot order, a lane's chunks in chunk order in
  groups of S chunks (32) counted from its first chunk, each group
  summed in order and the group partials in order. A lane of at most S
  chunks keeps the plain order; a longer one is regrouped, so the card's
  sums agree with the plain version's within a float32 tolerance, and
  repeat bit for bit.

The row reductions over the k embedding columns take their own order, and
``exp`` is torch's, so the port agrees with the JAX package within a
float32 tolerance. Logistic loss is the V_dim=0 case (V=None).

Under a mesh's ``dp`` axis (``dp > 1``) the backward's per-slot sums are
the data-parallel part: the per-entry (COO), per-cell (panel) or
per-chunk (chunked panel) contributions are computed as on one device,
cut into ``dp`` blocks along that leading axis (the JAX package's
``batch_sharding``, ``P('dp')``), each block reduced to per-lane partials
and the partials summed in dp order (:func:`dp_reduce`: a fixed order, no
atomics). The blocks are cut from the batch's real rows (its real chunks)
by :func:`dp_blocks`, not at half the padded axis as in JAX: the sticky
caps a batch is padded to depend on which batches the producers packed
before it, so a cut at the cap moved between runs and a run did not
repeat; a cut from the real count does not move, so a run repeats bit
for bit. The forward is
per row, so it runs once over the batch: its bits are each block's.
Across processes (``plane``) each process computes its own blocks'
partials and :func:`dp_reduce` sums every process's, gathered, in global
dp order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import fused
from ..ops.batch import DeviceBatch, PanelBatch
from ..ops.segment import (chunk_sum, lane_sum, row_sum, segment_sum, spmv,
                           spmv_t)

PRED_CLAMP = 20.0


def dp_blocks(pos: torch.Tensor, real: torch.Tensor, dp: int
              ) -> torch.Tensor:
    """Each entry's dp block for :func:`dp_reduce`: ``pos`` is the entry's
    row (a chunked panel's: its chunk) and ``real`` the batch's count of
    real rows (chunks), a device scalar. The real positions are cut into
    ``dp`` runs in order at boundaries set by ``real`` alone, so the cut
    does not move with the caps the batch was padded to; positions past
    ``real`` get block ``dp`` and drop out (their contributions are
    zeros)."""
    n = torch.clamp(real.to(torch.int64), min=1)
    return torch.clamp(pos.to(torch.int64) * dp // n, max=dp)


def dp_reduce(reduce, data: torch.Tensor, lanes: torch.Tensor, U: int,
              dp: int = 1, plane=None,
              blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``reduce(data, lanes, U)`` (ops/segment.lane_sum or chunk_sum) over
    ``dp`` blocks of the leading axis, the per-lane partials summed in dp
    order. ``blocks`` gives each entry's block (:func:`dp_blocks`); by
    default the blocks are equal runs of the leading axis. Each block's
    pass drops the other blocks' entries by lane, so ``reduce`` must take
    unsorted lanes when ``dp > 1``. ``dp == 1`` is the plain reduction.
    Across processes (``plane``, a parallel.multihost.DataPlane) ``dp`` is
    this process's block count: its partials are gathered with every
    process's, and all of them are summed in global dp order
    (host-major), the same order on every rank, so every rank gets the
    same bits."""
    if dp == 1 and plane is None:
        return reduce(data, lanes, U)
    if dp == 1:
        parts = [reduce(data, lanes, U)]
    else:
        if blocks is None:
            n = data.shape[0]
            blocks = torch.arange(n, device=lanes.device) * dp // max(n, 1)
        parts = [reduce(data, lanes.masked_fill(blocks != b, U), U)
                 for b in range(dp)]
    if plane is not None:
        parts = plane.gather(torch.stack(parts)).flatten(0, 1).unbind(0)
    red = None
    for part in parts:
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


def _coo_blocks(batch: DeviceBatch, dp: int) -> Optional[torch.Tensor]:
    """The nonzeros' dp blocks by their rows (pad entries sit in the last
    real row with value 0)."""
    return dp_blocks(batch.rows, batch.num_rows, dp) if dp > 1 else None


def fm_grad(params: FMParams, batch: DeviceBatch, pred: torch.Tensor,
            xv: Optional[torch.Tensor] = None, dp: int = 1, plane=None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """COO backward -> (gw[U], gV[U, k] or None). The three transposed
    products share one lane sum over [x p XV | x p | x^2 p]; ``xv`` is the
    forward's X·V (None recomputes it). ``dp`` > 1 sums the entries' lane
    sums over dp blocks of the nonzeros, and ``plane`` over every
    process's (:func:`dp_reduce`)."""
    U = params.w.shape[0]
    vals, rows, cols = batch.vals, batch.rows, batch.cols
    p = _p_vector(pred, batch)
    if params.V is None or params.V.shape[1] == 0:
        if dp == 1 and plane is None:
            return spmv_t(vals, rows, cols, p, U), None
        return dp_reduce(lane_sum, (vals * p[rows])[:, None], cols, U,
                         dp, plane, _coo_blocks(batch, dp))[:, 0], None
    k = params.V.shape[1]
    vm = _vmask(params)
    Vm = params.V * vm[:, None]
    XV = xv if xv is not None else segment_sum(
        vals[:, None] * Vm[cols], rows, batch.batch_cap, batch.row_cap)
    pr = p[rows]
    contrib = torch.cat([vals[:, None] * (p[:, None] * XV)[rows],
                         (vals * pr)[:, None], (vals ** 2 * pr)[:, None]],
                        dim=1)
    red = dp_reduce(lane_sum, contrib, cols, U, dp, plane,
                    _coo_blocks(batch, dp))
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
                           sorted_chunks: bool = True, dp: int = 1,
                           plane=None
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Chunked-run backward (``pb.chunk_*`` set), the JAX package's
    ``_fm_grad_panel_chunked``. On the card, with embeddings of at most
    ``fused.CHUNK_GRAD_MAX_K`` columns, ``dp == 1`` and no ``plane``, the
    kernel entry ``ops/fused.fm_chunk_grad_cuda``; every other call (the
    CPU, dp blocks, processes, logistic loss, wider V) takes the plain
    version :func:`fm_grad_panel_chunked_ref`, whose dp-block sums need
    another order than the kernel's. A layout whose lanes do not ascend
    (``sorted_chunks`` false, LossSpec.chunks_sorted) comes only with dp
    blocks or a plane."""
    if (p.device.type == "cuda" and params.V is not None
            and 0 < params.V.shape[1] <= fused.CHUNK_GRAD_MAX_K and dp == 1
            and plane is None):
        return fused.fm_chunk_grad_cuda(p, xv, pb.chunk_idx, pb.chunk_lane,
                                        pb.chunk_vals, params.V,
                                        _vmask(params))
    return fm_grad_panel_chunked_ref(params, pb, p, xv, sorted_chunks, dp,
                                     plane)


def fm_grad_panel_chunked_ref(params: FMParams, pb: PanelBatch,
                              p: torch.Tensor, xv: Optional[torch.Tensor],
                              sorted_chunks: bool = True, dp: int = 1,
                              plane=None
                              ) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    """Plain version of the chunked-run backward: each chunk's L token
    rows of the row quantities (p XV | p) are gathered and summed to one
    partial, times x (and x^2 for xxp) on valued panels; the partials sum
    per lane in chunk order (ops/segment.chunk_sum). Binary panels share
    one column for gw and xxp (x == x^2). The sum over a chunk's L tokens
    is torch's reduction, XLA's order may differ, so the two agree within
    a float32 tolerance."""
    U = params.w.shape[0]
    cv = pb.chunk_vals
    blocks = None
    if dp > 1:
        # the real chunks lead, the pad chunks (lane U) trail
        C = pb.chunk_lane.shape[0]
        blocks = dp_blocks(torch.arange(C, device=pb.chunk_lane.device),
                           (pb.chunk_lane < U).sum(), dp)
        sorted_chunks = False

    def csum(partial, lanes, n):
        return chunk_sum(partial, lanes, n, sorted_chunks)

    if params.V is None or params.V.shape[1] == 0:
        toks = _chunk_tokens(p[:, None], pb.chunk_idx)[:, :, 0]  # [C, L]
        if cv is not None:
            toks = toks * cv
        gw = dp_reduce(csum, torch.sum(toks, dim=1)[:, None],
                       pb.chunk_lane, U, dp, plane, blocks)[:, 0]
        return gw, None
    k = params.V.shape[1]
    vm = _vmask(params)
    Vm = (params.V * vm.to(params.V.dtype)[:, None]).to(torch.float32)
    rowq = torch.cat([p[:, None] * xv, p[:, None]], dim=1)     # [B, k+1]
    toks = _chunk_tokens(rowq, pb.chunk_idx)                   # [C, L, k+1]
    if cv is None:
        red = dp_reduce(csum, torch.sum(toks, dim=1), pb.chunk_lane, U, dp,
                        plane, blocks)
        t1, gw = red[:, :k], red[:, k]
        xxp = gw
    else:
        v = cv[:, :, None]
        partial = torch.cat([torch.sum(toks * v, dim=1),
                             torch.sum(toks[:, :, k:] * (v * v), dim=1)],
                            dim=1)                             # [C, k+2]
        red = dp_reduce(csum, partial, pb.chunk_lane, U, dp, plane, blocks)
        t1, gw, xxp = red[:, :k], red[:, k], red[:, k + 1]
    gV = (t1 - xxp[:, None] * Vm) * vm[:, None]
    return gw, gV


def fm_grad_panel(params: FMParams, pb: PanelBatch, pred: torch.Tensor,
                  xv: Optional[torch.Tensor] = None,
                  sorted_chunks: bool = True, dp: int = 1, plane=None
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
        return _fm_grad_panel_chunked(params, pb, p, xv, sorted_chunks, dp,
                                      plane)
    flat_idx = pb.idx.reshape(B * F)
    blocks = None
    if dp > 1:
        cell_row = torch.arange(B * F, device=flat_idx.device) // F
        blocks = dp_blocks(cell_row, pb.num_rows, dp)
    if params.V is None or params.V.shape[1] == 0:
        cell = p[:, None].expand(B, F)
        if pb.vals is not None:
            cell = cell * pb.vals
        return dp_reduce(lane_sum, cell.reshape(B * F, 1), flat_idx, U,
                         dp, plane, blocks)[:, 0], None
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
                    dp, plane, blocks)
    t1, gw, xxp = red[:, :k], red[:, k], red[:, k + 1]
    gV = (t1 - xxp[:, None] * Vm) * vm[:, None]
    return gw, gV


def logit_objv(pred: torch.Tensor, batch) -> torch.Tensor:
    """sum log(1 + exp(-y*pred)) over real rows, not averaged
    (include/difacto/loss.h:57-66)."""
    y = torch.where(batch.labels > 0, 1.0, -1.0)
    per_row = torch.log1p(torch.exp(-y * pred))
    return torch.sum(per_row * batch.row_mask)
