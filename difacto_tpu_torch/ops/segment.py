"""Sparse products as deterministic segment sums (counterpart of
difacto_tpu/ops/segment.py).

- ``spmv`` / ``spmv_t``  <- SpMV::Times / TransTimes (src/common/spmv.h)
- ``spmm`` / ``spmm_t``  <- SpMM::Times / TransTimes (src/common/spmm.h)

The JAX package reduces with ``jax.ops.segment_sum``. On the card the
obvious torch counterpart, ``index_add_``, sums with atomics in an order
that changes from run to run, which would break the contract that
``task=serve`` answers equal ``task=pred``'s file bit for bit. Here every
segment is summed LEFT TO RIGHT over its own entries instead: the COO
``rows`` are ascending (ops/batch.pack_batch), so each row's entries are
one contiguous run. One gather lays the runs out as a [rows, row_cap]
grid (positions past a row's run read an appended zero entry), and a
loop over the grid's columns ``j < row_cap`` adds column ``j`` of every
row at once. A row's sum then depends on its own entries only — not on
the device, the thread schedule or which other rows share the batch.
``row_cap`` (>= the widest row's real entries) is a host-side static of
the batch; the padding entries behind the last real row carry value 0
and fall past it or add zeros.

The transposed products (the backward) sum per COLUMN, where runs are
long and skewed (a common feature appears in most rows of a batch), so a
grid would be mostly padding. :func:`lane_sum` sorts the entries by lane
with a stable sort and sums each lane's run left to right in ascending
entry order, starting from 0, with ``torch.segment_reduce`` over 2-D data
(a sequential loop per output element on the CPU and on the card, no
atomics). That is the order XLA's CPU scatter-add takes, so on the CPU
the sums come out bit-identical to ``jax.ops.segment_sum``.

The chunked-run backward (losses/fm.py, for batches staged by the replay
cache) reduces each chunk of a lane's run to a partial first; its chunk
lanes are already ascending, so :func:`chunk_sum` sums each lane's
partials in chunk order with the same sequential ``segment_reduce`` and
no sort, which is the order of the JAX package's sorted scatter-add.
Neither reduction uses ``index_add_``/``scatter_add_``: their order on
the card is not deterministic.

On the card the chunked backward of an FM with embeddings on one dp
block does not come here: ops/fused.fm_chunk_grad_cuda
(``csrc/fm_chunk_grad.cu``) sums each chunk's tokens in slot order and
each lane's chunks in chunk order in groups of 32 chunks counted from the
lane's first, the groups' partials then in order, so that a skewed lane
is summed by many threads and not walked by one as ``segment_reduce``
walks it. A lane of at most 32 chunks keeps :func:`chunk_sum`'s order.
:func:`chunk_sum` stays the reduction of the CPU, of dp blocks and of
logistic loss.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, rows: torch.Tensor, num_rows: int,
                row_cap: int) -> torch.Tensor:
    """out[r] = data[start_r] + data[start_r + 1] + ... (left to right)
    over the entries with rows == r; ``rows`` ascending."""
    nnz, tail = data.shape[0], tuple(data.shape[1:])
    r = torch.arange(num_rows, dtype=rows.dtype, device=rows.device)
    start = torch.searchsorted(rows, r)
    end = torch.searchsorted(rows, r, right=True)
    pos = start[:, None] + torch.arange(row_cap, device=rows.device)[None, :]
    pos = torch.where(pos < end[:, None], pos, nnz)   # nnz: the zero entry
    grid = torch.cat([data, data.new_zeros((1,) + tail)]).index_select(
        0, pos.reshape(-1)).view((num_rows, row_cap) + tail)
    out = torch.zeros((num_rows,) + tail, dtype=data.dtype,
                      device=data.device)
    for j in range(row_cap):
        out = out + grid[:, j]
    return out


def spmv(vals, rows, cols, x, num_rows: int, row_cap: int):
    """y[r] = sum_k vals[k] * x[cols[k]] over nonzeros with rows[k]==r."""
    return segment_sum(vals * x[cols], rows, num_rows, row_cap)


def spmm(vals, rows, cols, X, num_rows: int, row_cap: int):
    """Y[r, :] = sum_k vals[k] * X[cols[k], :] for an (U, k) dense rhs."""
    return segment_sum(vals[:, None] * X[cols], rows, num_rows, row_cap)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right — the same per-row order on
    every device and at every batch size (a tree reduction's grouping may
    follow the tensor's shape)."""
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def lane_sum(data: torch.Tensor, lanes: torch.Tensor,
             num_lanes: int) -> torch.Tensor:
    """out[u] = 0 + data[i0] + data[i1] + ... over the entries i0 < i1 <
    ... with ``lanes == u`` (data [n, m] -> [num_lanes, m]). Lanes must be
    >= 0 (a negative lane would sort first and shift every segment);
    lanes >= num_lanes are dropped."""
    order = torch.argsort(lanes, stable=True)
    sl = lanes[order]
    bounds = torch.searchsorted(
        sl, torch.arange(num_lanes + 1, dtype=sl.dtype, device=sl.device))
    return torch.segment_reduce(data[order], "sum",
                                lengths=bounds[1:] - bounds[:-1],
                                axis=0, unsafe=True)


def chunk_sum(partials: torch.Tensor, chunk_lane: torch.Tensor,
              num_lanes: int, lanes_sorted: bool = True) -> torch.Tensor:
    """out[u] = 0 + partials[c0] + partials[c1] + ... over the chunks c0 <
    c1 < ... of lane u ([C, m] -> [num_lanes, m]); chunks of lanes >=
    ``num_lanes`` (the pad chunks) are dropped. ``lanes_sorted`` says that
    ``chunk_lane`` ascends, as a single-card layout's does; otherwise the
    chunks are put in lane order first (:func:`lane_sum`)."""
    if not lanes_sorted:
        return lane_sum(partials, chunk_lane, num_lanes)
    bounds = torch.searchsorted(
        chunk_lane, torch.arange(num_lanes + 1, dtype=chunk_lane.dtype,
                                 device=chunk_lane.device))
    return torch.segment_reduce(partials, "sum",
                                lengths=bounds[1:] - bounds[:-1], axis=0,
                                unsafe=True)


def spmv_t(vals, rows, cols, p, num_cols: int):
    """y[c] = sum_k vals[k] * p[rows[k]] — the transpose product."""
    return lane_sum((vals * p[rows])[:, None], cols, num_cols)[:, 0]


def spmm_t(vals, rows, cols, P, num_cols: int):
    """Y[c, :] = sum_k vals[k] * P[rows[k], :]."""
    return lane_sum(vals[:, None] * P[rows], cols, num_cols)
