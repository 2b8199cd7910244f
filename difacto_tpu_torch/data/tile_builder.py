"""Shared tile ingestion of the batch learners, L-BFGS and BCD
(counterpart of difacto_tpu/data/tile_builder.py; the reference's
TileBuilder, src/data/tile_builder.h:17-183). Host numpy only.

- :meth:`add` compacts a raw block (Localizer::Compact, data/localizer.py)
  and folds its (id, count) pairs into the global dictionary (kv_union);
- :meth:`filter_tail` drops features with count <= threshold
  (RemoveTailFeatures, src/lbfgs/lbfgs_utils.h:104-120 / BuildFeatureMap,
  src/bcd/bcd_learner.cc:141-155);
- :meth:`colmap` maps a tile's uniq ids to positions in the filtered
  dictionary, -1 where filtered (BuildColmap, tile_builder.h:115-183).

The learner-specific layouts (L-BFGS's flat [w, V...] positions, BCD's
per-block column slices) stay with the learners.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..base import FEAID_DTYPE
from ..ops.kv import find_position, kv_union
from .localizer import compact


class TileBuilder:
    def __init__(self) -> None:
        self.ids = np.empty(0, dtype=FEAID_DTYPE)
        self.cnts = np.empty(0, dtype=np.float32)
        # (compact block, sorted uniq ids, is_train) per ingested tile
        self.tiles: List[Tuple] = []
        self.nrows_train = 0
        self.nrows_val = 0
        self.nnz_train = 0

    def add(self, blk, is_train: bool = True):
        """Ingest one raw row block; returns the compact block."""
        cblk, uniq, cnt = compact(blk, need_counts=is_train)
        self.tiles.append((cblk, uniq, is_train))
        if is_train:
            self.ids, self.cnts = kv_union(self.ids, self.cnts, uniq,
                                           cnt.astype(np.float32))
            self.nrows_train += blk.size
            self.nnz_train += blk.nnz
        else:
            self.nrows_val += blk.size
        return cblk

    def filter_tail(self, threshold: float) -> np.ndarray:
        """Keep the features with count > threshold; returns the filtered
        ids (also kept as ``self.ids``/``self.cnts``)."""
        if threshold > 0:
            keep = self.cnts > threshold
            self.ids = self.ids[keep]
            self.cnts = self.cnts[keep]
        return self.ids

    def colmap(self, t: int) -> np.ndarray:
        """Tile t's uniq ids -> positions in the filtered dictionary
        (-1 = filtered away)."""
        return find_position(self.ids, self.tiles[t][1])
