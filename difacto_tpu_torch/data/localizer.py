"""Feature-id localization (counterpart of difacto_tpu/data/localizer.py).

Maps a batch's raw uint64 feature ids to a dense [0, n) range: the batch's
distinct byte-REVERSED ids sorted ascending (the reference's Localizer,
src/data/localizer.cc:22-107) plus a compacted RowBlock whose ``index`` is
uint32 positions into them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..base import reverse_bytes
from .rowblock import RowBlock


def compact(blk: RowBlock, need_counts: bool = False
            ) -> Tuple[RowBlock, np.ndarray, Optional[np.ndarray]]:
    """Returns (compacted block, uniq reversed ids sorted ascending, each
    id's occurrence count as f32 when ``need_counts``, else None)."""
    uniq, inverse, counts = np.unique(reverse_bytes(blk.index),
                                      return_inverse=True,
                                      return_counts=True)
    out = RowBlock(
        offset=blk.offset.copy(),
        label=blk.label,
        index=inverse.astype(np.uint32),
        value=blk.value,
        weight=blk.weight,
    )
    return out, uniq, (counts.astype(np.float32) if need_counts else None)
