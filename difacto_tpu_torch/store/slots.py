"""The hashed store's slot rules, on the host and without torch (the JAX
package keeps them in difacto_tpu/store/local.py): producer worker
processes hash and pad with these and never import torch.
"""

from __future__ import annotations

import numpy as np

from ..base import FEAID_DTYPE


def pad_slots_oob(slots: np.ndarray, cap: int, capacity: int) -> np.ndarray:
    """int32[cap]: sorted unique ``slots`` followed by ascending
    out-of-bounds padding (capacity, capacity+1, ...)."""
    out = np.arange(capacity, capacity + cap, dtype=np.int64)
    out[:len(slots)] = slots
    return out.astype(np.int32)


def hash_slots(rev_ids: np.ndarray, hash_capacity: int) -> np.ndarray:
    """Byte-REVERSED uint64 ids -> int32 slots in [1, capacity)."""
    cap = np.uint64(hash_capacity - 1)
    return (np.asarray(rev_ids, FEAID_DTYPE) % cap
            + np.uint64(1)).astype(np.int32)
