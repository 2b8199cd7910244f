"""Host batch preparation for the hashed store (counterpart of
difacto_tpu/data/pack_stream.py, the thread-transport half).

- :class:`ShapeSchedule`: every batch pads each dimension to the largest
  bucket seen so far for its key, so a steady stream of batches reuses one
  set of padded shapes (and, on the card, one set of allocator blocks).
  Caps only grow; thread-safe.
- :func:`prepare_hashed`: hash the raw ids, ONE ``np.unique`` (with counts
  on epoch 0) collapses localization, slot mapping and collision dedup,
  the slot vector is padded with ascending out-of-bounds lanes, and
  :func:`pack_payload` packs the panel layout for near-uniform rows, COO
  otherwise — the JAX package's buffers byte for byte.
- :func:`pack_mapped`: the same payloads for a block the dictionary store
  has already mapped (the JAX learner's ``_pack_mapped``), padded at the
  table's capacity after this block's inserts.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple, Optional

import numpy as np


class ShapeSchedule:
    def __init__(self) -> None:
        self._caps: dict = {}
        self._lock = threading.Lock()

    def cap(self, key: str, n: int, minimum: int = 8,
            exact: bool = False) -> int:
        """``exact`` keeps a plain sticky max instead of bucketing."""
        from ..ops.batch import bucket
        with self._lock:
            c = self._caps.get(key, 0)
            if n > c or c == 0:
                # floor degenerate dims like bucket(0) == minimum: empty
                # batches still need non-zero-sized shapes
                c = max(n, 1) if exact else bucket(n, minimum)
                self._caps[key] = c
            return c

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._caps)


class Payload(NamedTuple):
    """A packed batch: ``layout`` "panel" or "coo", the two host buffers,
    and the statics to unpack them. ``d2`` is the panel width or the COO
    nnz cap; ``row_cap`` (COO only) the widest row's cap."""
    layout: str
    i32: np.ndarray
    f32: np.ndarray
    binary: bool
    b_cap: int
    d2: int
    u_cap: int
    row_cap: int = 0


def pack_payload(shapes: ShapeSchedule, cblk, n_lanes: int,
                 padded: np.ndarray, b_cap: int, dim_min: int, job: str,
                 counts: Optional[np.ndarray] = None) -> Payload:
    """Panel layout when rows are near-uniform, COO otherwise; caps from
    the sticky schedule keyed by ``job``. ``padded`` is the OOB-padded
    slot vector (its length is u_cap); ``cblk.index`` already addresses
    its lanes."""
    from ..ops.batch import max_row_nnz, pack_batch, pack_panel, panel_width
    u_cap = len(padded)
    width = panel_width(cblk, b_cap)
    if width is not None:
        width = shapes.cap(job + ".w", width, exact=True)
        i32, f32, binary = pack_panel(cblk, n_lanes, padded, b_cap, width,
                                      u_cap, counts=counts)
        return Payload("panel", i32, f32, binary, b_cap, width, u_cap)
    nnz_cap = shapes.cap(job + ".nnz", cblk.nnz, dim_min)
    row_cap = shapes.cap(job + ".row", max_row_nnz(cblk))
    i32, f32, binary = pack_batch(cblk, n_lanes, padded, b_cap, nnz_cap,
                                  u_cap, counts=counts)
    return Payload("coo", i32, f32, binary, b_cap, nnz_cap, u_cap, row_cap)


def pack_mapped(shapes: ShapeSchedule, blk, cblk, slots: np.ndarray,
                counts: Optional[np.ndarray], capacity: int, dim_min: int,
                job: str) -> Payload:
    """Pack a block whose ids the dictionary store mapped: ``slots`` are
    sorted unique (``SlotStore.map_keys_dedup``) and ``cblk.index``
    addresses them; ``counts`` (epoch 0) fill the counts section. The
    batch cap is the sticky bucket of the block sizes, as in the JAX
    learner."""
    from ..store.local import pad_slots_oob
    n_uniq = len(slots)
    u_cap = shapes.cap(job + ".u", n_uniq)
    b_cap = shapes.cap(job + ".b", blk.size, dim_min)
    padded = pad_slots_oob(slots.astype(np.int32), u_cap, capacity)
    return pack_payload(shapes, cblk, n_uniq, padded, b_cap, dim_min, job,
                        counts=counts)


def prepare_hashed(shapes: ShapeSchedule, hash_capacity: int, blk,
                   want_counts: bool, fill_counts: bool, dim_min: int,
                   job: str, b_cap: Optional[int] = None) -> Payload:
    """Pack one raw-id block for the hashed store. ``want_counts`` keeps
    the counts section for the whole run; ``fill_counts`` (epoch 0)
    fills it with each lane's occurrence count, later epochs ship
    zeros."""
    from ..base import reverse_bytes
    from ..store.local import hash_slots, pad_slots_oob
    tok = hash_slots(reverse_bytes(blk.index), hash_capacity)
    if fill_counts:
        slots, inverse, counts = np.unique(tok, return_inverse=True,
                                           return_counts=True)
        counts = counts.astype(np.float32)
    else:
        slots, inverse = np.unique(tok, return_inverse=True)
        counts = np.zeros(0, np.float32) if want_counts else None
    cblk = dataclasses.replace(blk, index=inverse.astype(np.uint32))
    n_uniq = len(slots)
    u_cap = shapes.cap(job + ".u", n_uniq)
    b_cap = b_cap or shapes.cap(job + ".b", blk.size, dim_min)
    padded = pad_slots_oob(slots.astype(np.int32), u_cap, hash_capacity)
    return pack_payload(shapes, cblk, n_uniq, padded, b_cap, dim_min, job,
                        counts=counts)
