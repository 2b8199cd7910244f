"""CSR row-block container (counterpart of difacto_tpu/data/rowblock.py).

Layout: ``offset[n+1]`` int64 row pointers, ``label[n]`` float32, optional
``weight[n]``, ``index[nnz]`` uint64 feature ids (or uint32 after
localization), optional ``value[nnz]`` float32 (None == all ones, the
reference's binary-value elision, src/reader/batch_reader.cc:71-73).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..base import FEAID_DTYPE, REAL_DTYPE


@dataclass
class RowBlock:
    offset: np.ndarray                 # int64[n+1]
    label: np.ndarray                  # float32[n]
    index: np.ndarray                  # uint64[nnz] (or uint32 localized)
    value: Optional[np.ndarray] = None  # float32[nnz] or None (binary)
    weight: Optional[np.ndarray] = None  # float32[n] or None

    @property
    def size(self) -> int:
        return len(self.offset) - 1

    @property
    def nnz(self) -> int:
        return int(self.offset[-1] - self.offset[0])

    def __len__(self) -> int:
        return self.size

    def slice(self, begin: int, end: int) -> "RowBlock":
        """Zero-copy row range [begin, end)."""
        off = self.offset[begin:end + 1]
        lo, hi = off[0], off[-1]
        return RowBlock(
            offset=off - lo,
            label=self.label[begin:end],
            index=self.index[lo:hi],
            value=None if self.value is None else self.value[lo:hi],
            weight=None if self.weight is None else self.weight[begin:end],
        )

    def values_or_ones(self) -> np.ndarray:
        if self.value is not None:
            return self.value
        return np.ones(self.nnz, dtype=REAL_DTYPE)

    def row_ids(self) -> np.ndarray:
        """int32[nnz] row index of each nonzero (COO expansion of offset)."""
        counts = np.diff(self.offset)
        return np.repeat(np.arange(self.size, dtype=np.int32), counts)

    def drop_binary_values(self) -> "RowBlock":
        """If every value == 1, drop the value array
        (batch_reader.cc:71-73)."""
        if self.value is not None and (self.value == 1).all():
            return RowBlock(self.offset, self.label, self.index, None,
                            self.weight)
        return self

    @staticmethod
    def concat(blocks: List["RowBlock"]) -> "RowBlock":
        if not blocks:
            return empty_block()
        offs = [np.asarray(b.offset) - b.offset[0] for b in blocks]
        out_off = [offs[0]]
        base = offs[0][-1]
        for o in offs[1:]:
            out_off.append(o[1:] + base)
            base += o[-1]
        any_val = any(b.value is not None for b in blocks)
        any_wt = any(b.weight is not None for b in blocks)
        return RowBlock(
            offset=np.concatenate(out_off),
            label=np.concatenate([b.label for b in blocks]),
            index=np.concatenate([b.index for b in blocks]),
            value=(np.concatenate([b.values_or_ones() for b in blocks])
                   if any_val else None),
            weight=(np.concatenate([
                b.weight if b.weight is not None
                else np.ones(b.size, dtype=REAL_DTYPE) for b in blocks])
                if any_wt else None),
        )


def empty_block() -> RowBlock:
    return RowBlock(
        offset=np.zeros(1, dtype=np.int64),
        label=np.zeros(0, dtype=REAL_DTYPE),
        index=np.zeros(0, dtype=FEAID_DTYPE),
    )


class RowBlockBuilder:
    """Incremental builder (dmlc::data::RowBlockContainer::Push)."""

    def __init__(self) -> None:
        self._rows: List[RowBlock] = []

    def push_rows(self, blk: RowBlock, rows: np.ndarray) -> None:
        """Push a subset/permutation of ``blk``'s rows, in that order."""
        if len(rows) == 0:
            return
        counts = np.diff(blk.offset)[rows]
        starts = np.asarray(blk.offset[rows], dtype=np.int64)
        off = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        nnz_idx = (np.repeat(starts - off[:-1], counts)
                   + np.arange(int(off[-1]), dtype=np.int64))
        self._rows.append(RowBlock(
            offset=off,
            label=blk.label[rows],
            index=blk.index[nnz_idx],
            value=None if blk.value is None else blk.value[nnz_idx],
            weight=None if blk.weight is None else blk.weight[rows],
        ))

    @property
    def num_rows(self) -> int:
        return sum(b.size for b in self._rows)

    def build(self) -> RowBlock:
        return RowBlock.concat(self._rows)

    def clear(self) -> None:
        self._rows.clear()
