"""Frozen copy of the learner's batch order on the hashed store's one
part: epoch 0 reads the rows in file order in shuffle buffers of
``batch_size * shuffle`` rows, each buffer permuted by one
``RandomState(0)`` stream, and cuts the permuted rows into batches of
``batch_size`` (the last may be short); every later epoch replays those
batches in ``RandomState(epoch).permutation``."""

from __future__ import annotations

from typing import List

import numpy as np


def epoch0_batches(n_rows: int, batch_size: int, shuffle: int
                   ) -> List[np.ndarray]:
    """Row indices of each batch of epoch 0, in dispatch order."""
    buf = batch_size * shuffle if shuffle else 0
    rng = np.random.RandomState(0)
    order = []
    for lo in range(0, n_rows, buf or n_rows):
        rows = np.arange(lo, min(lo + (buf or n_rows), n_rows))
        if buf:
            perm = np.arange(len(rows))
            rng.shuffle(perm)
            rows = rows[perm]
        order.append(rows)
    rows = np.concatenate(order)
    return [rows[i:i + batch_size] for i in range(0, n_rows, batch_size)]


def replay_order(n_batches: int, epoch: int, shuffle: int) -> np.ndarray:
    """Which staged batch each step of a replayed epoch runs."""
    if not shuffle:
        return np.arange(n_batches)
    return np.random.RandomState(epoch).permutation(n_batches)
