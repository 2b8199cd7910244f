"""Device batch representations (counterpart of difacto_tpu/ops/batch.py).

A localized row block becomes TWO host buffers, byte for byte the JAX
package's layouts, and on the device a batch of fixed-cap tensors:

- COO (:func:`pack_batch` / :func:`unpack_batch` -> :class:`DeviceBatch`):
  ``rows[NNZ]`` int32 row of each nonzero, ascending (pad: last real row),
  ``cols[NNZ]`` int32 position in the slot vector (pad: 0), ``vals[NNZ]``
  float32 (zero on padding), ``labels/rweight/row_mask [B]``;
- panel (:func:`pack_panel` / :func:`unpack_panel` -> :class:`PanelBatch`):
  a [B, F] matrix of slot-vector positions for near-uniform rows (Criteo's
  39 fields), pad cells position 0 with value 0.

Training buffers carry a counts section (the epoch-0 feature counts of
the slot vector's lanes) at the tail of the f32 buffer. Caps come from
:func:`bucket` rungs, so a stream of batches reuses a few shapes.
``row_cap`` (the widest row's nonzeros, capped on the host) is a static
of a COO batch that the deterministic segment sums need (ops/segment.py).

The device-dedup panel (:func:`pack_panel_raw` / :func:`unpack_panel_raw`)
ships raw hashed tokens in its index cells and no slot vector: the step
derives both on the device (ops/fused.dedup_tokens).

The host packers are numpy only and this module imports torch inside the
functions that build device tensors, so producer worker processes pack
without importing torch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Optional

import numpy as np

from ..base import REAL_DTYPE
from ..data.rowblock import RowBlock

if TYPE_CHECKING:
    import torch


class DeviceBatch(NamedTuple):
    rows: torch.Tensor      # int32[NNZ] row of each nonzero (pad: last row)
    cols: torch.Tensor      # int32[NNZ] slot-vector position (pad: 0)
    vals: torch.Tensor      # f32[NNZ] (pad: 0)
    labels: torch.Tensor    # f32[B]
    rweight: torch.Tensor   # f32[B] per-row example weights (pad: 0)
    row_mask: torch.Tensor  # f32[B] 1 for real rows
    num_rows: torch.Tensor  # i32[] actual batch size
    num_uniq: torch.Tensor  # i32[] actual distinct-feature count
    row_cap: int            # >= nonzeros of the widest real row

    @property
    def batch_cap(self) -> int:
        return self.labels.shape[0]


class PanelBatch(NamedTuple):
    """Fixed-width row panel: idx[B, F] positions into the slot vector,
    vals[B, F] or None (binary rows with no pad cells). A panel staged for
    replay also carries the chunked-run backward layout
    (:func:`panel_chunk_tokens`): each lane's token run cut into chunks of
    ``CHUNK_L`` token rows, so the backward reduces dense [C, L] chunks to
    per-chunk partials and sums those per lane (losses/fm.py)."""
    idx: torch.Tensor              # int32[B, F] (pad cells: 0)
    vals: Optional[torch.Tensor]   # f32[B, F] (pad cells: 0) or None
    labels: torch.Tensor           # f32[B]
    rweight: torch.Tensor          # f32[B]
    row_mask: torch.Tensor         # f32[B] 1 for real rows
    num_rows: torch.Tensor         # i32[]
    num_uniq: torch.Tensor         # i32[]
    chunk_idx: Optional[torch.Tensor] = None   # i32[C, L] token rows
    chunk_lane: Optional[torch.Tensor] = None  # i32[C] ascending lanes
    chunk_vals: Optional[torch.Tensor] = None  # f32[C, L] or None

    @property
    def batch_cap(self) -> int:
        return self.labels.shape[0]

    @property
    def width(self) -> int:
        return self.idx.shape[1]


def bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next rung of {m*2^j, 1.5*m*2^j} (>= minimum)."""
    b = minimum
    while b < n:
        if n <= b + b // 2:
            return b + b // 2
        b *= 2
    return b


def mesh_dim_min(dp: int, floor: int = 8) -> int:
    """Bucket minimum that keeps every rung divisible by ``dp`` (the JAX
    package's ``mesh_dim_min``): the smallest multiple of 2*dp that is
    >= floor, since :func:`bucket`'s 1.5x rungs divide by dp only when
    the minimum carries a factor of 2*dp."""
    base = 2 * dp
    return base * ((max(floor, base) + base - 1) // base)


def max_row_nnz(blk: RowBlock) -> int:
    return int(np.diff(blk.offset).max()) if blk.size else 0


def panel_width(blk: RowBlock, batch_cap: int) -> Optional[int]:
    """Fixed panel width for this block, or None when the COO layout is
    denser: panel when B * F_max stays within 1.5x the COO nnz pad."""
    return panel_width_of(max_row_nnz(blk), blk.nnz, batch_cap)


def panel_width_of(fmax: int, nnz: int, batch_cap: int) -> Optional[int]:
    """:func:`panel_width` from a block's widest row and nonzero count
    (the multi-host step decides on every process's maxima)."""
    if fmax == 0 or batch_cap * fmax > 1.5 * bucket(nnz):
        return None
    return fmax


def _panel_arrays(blk: RowBlock, batch_cap: int, width: int,
                  force_vals: bool = False):
    """Host panel arrays: (idx[B,F], vals[B,F] or None, labels, rweight,
    row_mask). A uniform full block keeps binary rows binary, unless
    ``force_vals``; anything else gets explicit values, zero on pad
    cells."""
    b = blk.size
    counts = np.diff(blk.offset).astype(np.int64)
    if counts.size and counts.max() > width:
        raise ValueError(f"row nnz {counts.max()} exceeds panel width "
                         f"{width}")
    uniform = counts.size and (counts == width).all() and not force_vals
    if uniform and b == batch_cap:
        idx = blk.index.reshape(b, width).astype(np.int32)
        vals = (None if blk.value is None
                else blk.value.reshape(b, width).astype(REAL_DTYPE))
    else:
        idx = np.zeros((batch_cap, width), dtype=np.int32)
        vals = np.zeros((batch_cap, width), dtype=REAL_DTYPE)
        starts = np.asarray(blk.offset[:-1], dtype=np.int64)
        cell = (np.arange(blk.nnz, dtype=np.int64)
                - np.repeat(starts - blk.offset[0], counts))
        rows_coo = np.repeat(np.arange(b, dtype=np.int64), counts)
        idx[rows_coo, cell] = blk.index.astype(np.int32)
        vals[rows_coo, cell] = blk.values_or_ones()
    labels = np.zeros(batch_cap, dtype=REAL_DTYPE)
    labels[:b] = blk.label
    rweight = np.zeros(batch_cap, dtype=REAL_DTYPE)
    rweight[:b] = blk.weight if blk.weight is not None else 1.0
    row_mask = np.zeros(batch_cap, dtype=REAL_DTYPE)
    row_mask[:b] = 1.0
    return idx, vals, labels, rweight, row_mask


def pack_panel(blk: RowBlock, num_uniq: int, slots: np.ndarray,
               batch_cap: int, width: int, u_cap: int,
               counts: Optional[np.ndarray] = None,
               force_vals: bool = False):
    """Panel twin of :func:`pack_batch`:
    i32 = [idx(B*F) | slots(u_cap) | b, num_uniq];
    f32 = [vals(B*F)? | labels(B) | rweight(B) | row_mask(B) | counts(u)?].
    ``force_vals`` keeps the vals section on a uniform binary block."""
    if len(slots) != u_cap:
        raise ValueError(f"slots must arrive pre-padded to u_cap={u_cap}")
    idx, vals, labels, rweight, row_mask = _panel_arrays(
        blk, batch_cap, width, force_vals)
    binary = vals is None
    cells = batch_cap * width
    i32 = np.empty(cells + u_cap + 2, dtype=np.int32)
    i32[:cells] = idx.reshape(-1)
    i32[cells:cells + u_cap] = slots
    i32[cells + u_cap:] = (blk.size, num_uniq)
    vals_n = 0 if binary else cells
    nf32 = vals_n + 3 * batch_cap + (u_cap if counts is not None else 0)
    f32 = np.zeros(max(nf32, 1), dtype=REAL_DTYPE)
    o = 0
    if not binary:
        f32[:cells] = vals.reshape(-1)
        o = cells
    for a in (labels, rweight, row_mask):
        f32[o:o + batch_cap] = a
        o += batch_cap
    if counts is not None:
        f32[o:o + len(counts)] = counts
    return i32, f32, binary


def unpack_panel(i32: torch.Tensor, f32: torch.Tensor, batch_cap: int,
                 width: int, u_cap: int, has_counts: bool = False,
                 binary: bool = False):
    """Inverse of :func:`pack_panel` on device tensors ->
    (PanelBatch, slots, counts or None)."""
    cells = batch_cap * width
    idx = i32[:cells].view(batch_cap, width)
    slots = i32[cells:cells + u_cap]
    meta = i32[cells + u_cap:]
    o, vals = 0, None
    if not binary:
        vals = f32[:cells].view(batch_cap, width)
        o = cells
    labels = f32[o:o + batch_cap]
    rweight = f32[o + batch_cap:o + 2 * batch_cap]
    row_mask = f32[o + 2 * batch_cap:o + 3 * batch_cap]
    o += 3 * batch_cap
    counts = f32[o:o + u_cap] if has_counts else None
    pb = PanelBatch(idx=idx, vals=vals, labels=labels, rweight=rweight,
                    row_mask=row_mask, num_rows=meta[0], num_uniq=meta[1])
    return pb, slots, counts


def pack_panel_raw(blk: RowBlock, num_uniq: int, batch_cap: int,
                   width: int):
    """Device-dedup panel payload: the block's index cells are RAW hashed
    slot tokens (``hash_slots`` output, not positions in a slot vector)
    and there is no slots section — the step derives the sorted-unique
    slot vector and the inverse map on the device
    (ops/fused.dedup_tokens), so the producer skips ``np.unique``.

    i32 = [tok(B*F) | b, num_uniq]; f32 = [vals(B*F)? | labels(B) |
    rweight(B) | row_mask(B)]. ``num_uniq`` is the host's distinct count
    (pack_stream._count_distinct), which sizes the sticky u-cap. Pad
    cells carry token 0 (the trash slot, whose row is all zeros) with
    value 0. No counts section: the raw path runs only past the epoch-0
    count push."""
    idx, vals, labels, rweight, row_mask = _panel_arrays(blk, batch_cap,
                                                         width)
    binary = vals is None
    cells = batch_cap * width
    i32 = np.empty(cells + 2, dtype=np.int32)
    i32[:cells] = idx.reshape(-1)
    i32[cells:] = (blk.size, num_uniq)
    vals_n = 0 if binary else cells
    f32 = np.zeros(max(vals_n + 3 * batch_cap, 1), dtype=REAL_DTYPE)
    o = 0
    if not binary:
        f32[:cells] = vals.reshape(-1)
        o = cells
    for a in (labels, rweight, row_mask):
        f32[o:o + batch_cap] = a
        o += batch_cap
    return i32, f32, binary


def unpack_panel_raw(i32, f32, batch_cap: int, width: int,
                     binary: bool = False) -> PanelBatch:
    """Inverse of :func:`pack_panel_raw` on device tensors -> a PanelBatch
    whose ``idx`` cells are the raw tokens; the caller replaces them with
    the inverse map of :func:`~difacto_tpu_torch.ops.fused.dedup_tokens`."""
    cells = batch_cap * width
    idx = i32[:cells].view(batch_cap, width)
    meta = i32[cells:]
    o, vals = 0, None
    if not binary:
        vals = f32[:cells].view(batch_cap, width)
        o = cells
    labels = f32[o:o + batch_cap]
    rweight = f32[o + batch_cap:o + 2 * batch_cap]
    row_mask = f32[o + 2 * batch_cap:o + 3 * batch_cap]
    return PanelBatch(idx=idx, vals=vals, labels=labels, rweight=rweight,
                      row_mask=row_mask, num_rows=meta[0],
                      num_uniq=meta[1])


# Chunk length of the chunked-run backward layout (the JAX package's
# measured choice for the TPU; kept so that the layouts agree bit for bit).
CHUNK_L = 16


def chunk_cap(u_cap: int, cells: int, L: int = CHUNK_L,
              dp_div: int = 1) -> int:
    """Static chunk-count bound: each of the <= u_cap lane runs wastes
    less than one chunk, plus cells/L full chunks; rounded up to a
    multiple of ``dp_div`` so the [C, L] arrays split evenly over the
    mesh's dp blocks (the JAX learner's ``dp_div``)."""
    C = u_cap + cells // L + 2
    return -(-C // dp_div) * dp_div


def panel_chunk_tokens_flat(flat_idx: torch.Tensor,
                            flat_vals: Optional[torch.Tensor], u_cap: int,
                            b_cap: int, width: int, L: int = CHUNK_L,
                            dp_div: int = 1):
    """Chunked-run backward layout from the flat panel lanes, on the
    tensors' device (built once per batch when the replay cache stages
    it). Tokens are sorted by lane with a stable sort, so within a lane
    they keep ascending flat order; each lane's run is cut into
    ceil(len/L) chunks of exactly L token slots. Returns

      chunk_idx  i32[C, L]  token row per slot (pad: ``b_cap``, a row past
                            the batch that reads as 0),
      chunk_lane i32[C]     ascending lane per chunk (pad: ``u_cap``,
                            dropped by the reduction),
      chunk_vals f32[C, L]  token values (None when ``flat_vals`` is),

    with C = chunk_cap(u_cap, cells, L, dp_div); equal to the JAX
    package's ``panel_chunk_tokens_flat`` bit for bit (at ``dp_div`` 1).
    Chunk numbers are counted from the tokens that open a chunk
    (position in run % L == 0), which gives the same numbering as the
    per-run bases of the JAX version."""
    import torch
    cells = flat_idx.shape[0]
    C = chunk_cap(u_cap, cells, L, dp_div)
    dev = flat_idx.device
    lane, order = torch.sort(flat_idx.to(torch.int32), stable=True)
    rows = torch.div(order, width, rounding_mode="floor").to(torch.int32)
    ari = torch.arange(cells, dtype=torch.int64, device=dev)
    start = torch.ones(cells, dtype=torch.bool, device=dev)
    start[1:] = lane[1:] != lane[:-1]
    run_start = torch.cummax(torch.where(start, ari, 0), dim=0).values
    q = ari - run_start                                   # pos within run
    c = torch.cumsum((q % L == 0).to(torch.int64), dim=0) - 1
    cell = c * L + q % L                                  # ascending unique
    ci = torch.full((C * L,), b_cap, dtype=torch.int32, device=dev)
    ci[cell] = rows
    cl = torch.full((C,), u_cap, dtype=torch.int32, device=dev)
    # every token of a chunk writes the chunk's one lane: equal values
    cl.scatter_(0, c, lane)
    cv = None
    if flat_vals is not None:
        cv = torch.zeros(C * L, dtype=flat_vals.dtype, device=dev)
        cv[cell] = flat_vals[order]
        cv = cv.view(C, L)
    return ci.view(C, L), cl, cv


def panel_chunk_tokens_np(flat_idx: np.ndarray,
                          flat_vals: Optional[np.ndarray], u_cap: int,
                          b_fill: int, width: int, L: int = CHUNK_L,
                          C: Optional[int] = None, row_base: int = 0):
    """Host (numpy) twin of :func:`panel_chunk_tokens_flat`, the JAX
    package's ``panel_chunk_tokens_np``: ``b_fill`` is the pad row,
    ``row_base`` offsets token rows and ``C`` pins the chunk count (its
    mesh callers shard the rows and chunks over data-parallel ranks)."""
    cells = len(flat_idx)
    if C is None:
        C = chunk_cap(u_cap, cells, L)
    order = np.argsort(flat_idx, kind="stable")
    lane = flat_idx[order].astype(np.int32)
    rows = (order // width).astype(np.int32) + row_base
    start = np.empty(cells, dtype=bool)
    if cells:
        start[0] = True
        start[1:] = lane[1:] != lane[:-1]
    rid = np.cumsum(start) - 1
    run_start = np.nonzero(start)[0]
    q = np.arange(cells, dtype=np.int64) - run_start[rid]
    run_len = np.diff(np.append(run_start, cells))
    n_chunks = (run_len + L - 1) // L
    chunk_base = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
    c = chunk_base[rid] + q // L
    cell = c * L + q % L
    if len(c) and c[-1] >= C:
        raise ValueError(f"chunk count {c[-1] + 1} exceeds cap {C}")
    ci = np.full(C * L, b_fill, dtype=np.int32)
    ci[cell] = rows
    cl = np.full(C, u_cap, dtype=np.int32)
    cl[c] = lane
    cv = None
    if flat_vals is not None:
        cv = np.zeros(C * L, dtype=flat_vals.dtype)
        cv[cell] = flat_vals[order]
        cv = cv.reshape(C, L)
    return ci.reshape(C, L), cl, cv


def panel_chunk_tokens(pb: PanelBatch, u_cap: int,
                       L: int = CHUNK_L) -> PanelBatch:
    """Attach the chunked-run backward layout to a panel batch; ``u_cap``
    is the length of its slot vector."""
    B, F = pb.idx.shape
    fv = None if pb.vals is None else pb.vals.reshape(B * F)
    ci, cl, cv = panel_chunk_tokens_flat(pb.idx.reshape(B * F), fv, u_cap,
                                         B, F, L)
    return pb._replace(chunk_idx=ci, chunk_lane=cl, chunk_vals=cv)


def pack_batch(blk: RowBlock, num_uniq: int, slots: np.ndarray,
               batch_cap: int, nnz_cap: int, u_cap: int,
               counts: Optional[np.ndarray] = None):
    """Pack a localized block + OOB-padded slot vector into
    i32 = [rows(nnz) | cols(nnz) | slots(u) | b, num_uniq, nnz] and
    f32 = [vals(nnz)? | labels(B) | rweight(B) | row_mask(B) | counts(u)?]
    — the JAX package's layout. Binary blocks omit the vals section."""
    b, nnz = blk.size, blk.nnz
    if b > batch_cap or nnz > nnz_cap:
        raise ValueError("batch exceeds caps")
    if len(slots) != u_cap:
        raise ValueError(
            f"slots must arrive pre-padded to u_cap={u_cap} "
            f"(got {len(slots)}); use pad_slots_oob")
    binary = blk.value is None
    i32 = np.zeros(2 * nnz_cap + u_cap + 3, dtype=np.int32)
    i32[:nnz] = blk.row_ids()
    i32[nnz:nnz_cap] = max(b - 1, 0)  # pad rows -> a real segment, vals 0
    i32[nnz_cap:nnz_cap + nnz] = blk.index.astype(np.int32)
    i32[2 * nnz_cap:2 * nnz_cap + u_cap] = slots
    i32[2 * nnz_cap + u_cap:] = (b, num_uniq, nnz)

    vals_n = 0 if binary else nnz_cap
    nf32 = vals_n + 3 * batch_cap + (u_cap if counts is not None else 0)
    f32 = np.zeros(max(nf32, 1), dtype=REAL_DTYPE)
    o = 0
    if not binary:
        f32[:nnz] = blk.value
        o = nnz_cap
    f32[o:o + b] = blk.label
    o += batch_cap
    f32[o:o + b] = blk.weight if blk.weight is not None else 1.0
    o += batch_cap
    f32[o:o + b] = 1.0
    o += batch_cap
    if counts is not None:
        f32[o:o + len(counts)] = counts
    return i32, f32, binary


def unpack_batch(i32: torch.Tensor, f32: torch.Tensor, batch_cap: int,
                 nnz_cap: int, u_cap: int, row_cap: int,
                 binary: bool = False, has_counts: bool = False):
    """Inverse of :func:`pack_batch` on device tensors ->
    (DeviceBatch, slots, counts or None)."""
    import torch
    rows = i32[:nnz_cap]
    cols = i32[nnz_cap:2 * nnz_cap]
    slots = i32[2 * nnz_cap:2 * nnz_cap + u_cap]
    meta = i32[2 * nnz_cap + u_cap:]  # [b, num_uniq, nnz]
    if binary:
        # all-ones values, zero on padding entries
        iota = torch.arange(nnz_cap, dtype=torch.int32, device=i32.device)
        vals = (iota < meta[2]).to(torch.float32)
        o = 0
    else:
        vals = f32[:nnz_cap]
        o = nnz_cap
    labels = f32[o:o + batch_cap]
    o += batch_cap
    rweight = f32[o:o + batch_cap]
    o += batch_cap
    row_mask = f32[o:o + batch_cap]
    o += batch_cap
    counts = f32[o:o + u_cap] if has_counts else None
    batch = DeviceBatch(rows=rows, cols=cols, vals=vals, labels=labels,
                        rweight=rweight, row_mask=row_mask,
                        num_rows=meta[0], num_uniq=meta[1], row_cap=row_cap)
    return batch, slots, counts


def pad_batch(blk: RowBlock, num_uniq: int,
              batch_cap: Optional[int] = None,
              nnz_cap: Optional[int] = None,
              device="cpu") -> DeviceBatch:
    """A *localized* row block (uint32 indices) as a DeviceBatch on
    ``device``: the JAX package's ``pad_batch`` field for field. Pad
    entries point at row ``b - 1`` with value 0, so the rows stay
    ascending for ops/segment.segment_sum; ``row_cap`` is the widest
    row's nonzeros."""
    import torch
    b, nnz = blk.size, blk.nnz
    bc = batch_cap or bucket(b)
    nc = nnz_cap or bucket(nnz)
    if b > bc or nnz > nc:
        raise ValueError(f"batch ({b},{nnz}) exceeds caps ({bc},{nc})")
    rows = np.zeros(nc, dtype=np.int32)
    rows[:nnz] = blk.row_ids()
    rows[nnz:] = max(b - 1, 0)
    cols = np.zeros(nc, dtype=np.int32)
    cols[:nnz] = blk.index.astype(np.int32)
    vals = np.zeros(nc, dtype=REAL_DTYPE)
    vals[:nnz] = blk.values_or_ones()
    rowf = np.zeros((3, bc), dtype=REAL_DTYPE)   # labels, rweight, mask
    rowf[0, :b] = blk.label
    rowf[1, :b] = blk.weight if blk.weight is not None else 1.0
    rowf[2, :b] = 1.0
    i32 = torch.from_numpy(np.concatenate(
        [rows, cols, np.array([b, num_uniq], dtype=np.int32)])).to(device)
    f32 = torch.from_numpy(np.concatenate(
        [vals, rowf.reshape(-1)])).to(device)
    return DeviceBatch(rows=i32[:nc], cols=i32[nc:2 * nc], vals=f32[:nc],
                       labels=f32[nc:nc + bc],
                       rweight=f32[nc + bc:nc + 2 * bc],
                       row_mask=f32[nc + 2 * bc:], num_rows=i32[2 * nc],
                       num_uniq=i32[2 * nc + 1], row_cap=max_row_nnz(blk))
