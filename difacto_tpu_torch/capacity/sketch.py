"""Count-min sketch admission over the hashed token stream (counterpart of
difacto_tpu/capacity/sketch.py; the same hashes, seeds and mix, so both
packages admit the same tokens).

Every training batch's hashed tokens update a count-min sketch on the
producer, and only tokens whose (over-)estimate has reached
``admit_min_count`` are admitted to the slot table; the rest are remapped
to an out-of-bounds sentinel lane, which gathers zeros and scatters to
nowhere (the ``pad_slots_oob`` contract), so a rare feature costs neither
a table row nor a branch in the step.

The sketch is made per part iterator, seeded by ``(seed, epoch, part)``
(:func:`make_admission`), and sees exactly that part's token stream in
order: producer threads and producer worker processes build identical
sketches and admit identical token sets. A count-min estimate never
undercounts, so admission can only err toward admitting early.

Nothing here imports torch: worker processes run it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class CountMinSketch:
    """``depth`` rows of ``width`` uint32 counters (width rounded up to a
    power of two), per-row multiply-shift hashes with odd multipliers
    drawn from a seeded PCG64 stream: numpy only, deterministic, no
    per-token Python loop."""

    def __init__(self, width: int = 1 << 16, depth: int = 2,
                 seed: int = 0) -> None:
        self.log2w = max(int(width - 1).bit_length(), 1)
        self.width = 1 << self.log2w
        self.depth = depth
        self.counts = np.zeros((depth, self.width), dtype=np.uint32)
        rng = np.random.Generator(np.random.PCG64(seed))
        # odd 64-bit multipliers: multiply-shift h(x) = (a*x) >> (64-l)
        self._mult = (rng.integers(1, 1 << 63, size=depth,
                                   dtype=np.uint64) << np.uint64(1)) \
            | np.uint64(1)

    def _idx(self, tok: np.ndarray) -> np.ndarray:
        """[depth, n] counter indices of each token."""
        t = np.asarray(tok, dtype=np.uint64)
        sh = np.uint64(64 - self.log2w)
        return ((self._mult[:, None] * t[None, :]) >> sh).astype(np.int64)

    def add(self, tok: np.ndarray) -> np.ndarray:
        """Count one occurrence of every element of ``tok`` (duplicates in
        the batch each count), then return each element's estimate after
        the update."""
        idx = self._idx(tok)
        est = np.full(len(tok), np.iinfo(np.uint32).max, dtype=np.uint64)
        for d in range(self.depth):
            np.add.at(self.counts[d], idx[d], 1)
            np.minimum(est, self.counts[d][idx[d]], out=est,
                       casting="unsafe")
        return est

    def estimate(self, tok: np.ndarray) -> np.ndarray:
        """Point estimate (>= the true count) without updating."""
        idx = self._idx(tok)
        est = np.full(len(tok), np.iinfo(np.uint32).max, dtype=np.uint64)
        for d in range(self.depth):
            np.minimum(est, self.counts[d][idx[d]], out=est,
                       casting="unsafe")
        return est


class AdmissionFilter:
    """The producer-side admission gate (data/pack_stream.prepare_hashed).

    Tokens whose estimate is below ``min_count`` become the sentinel
    ``hash_capacity``: out of bounds for the table, and sorting between
    the real slots (< hash_capacity) and the producer pads (>=
    hash_capacity), so the sorted-unique slot vector survives. Dropped
    occurrences are counted into ``store_admit_drops_total``."""

    def __init__(self, hash_capacity: int, min_count: int,
                 seed: int = 0, width: int = 1 << 16,
                 depth: int = 2) -> None:
        self.sentinel = np.int32(hash_capacity)
        self.min_count = int(min_count)
        self.sketch = CountMinSketch(width=width, depth=depth, seed=seed)
        self._drops = None  # the registry is looked up at the first drop

    def filter(self, tok: np.ndarray) -> np.ndarray:
        """Hashed int32 tokens -> the same tokens with the unadmitted
        occurrences remapped to the sentinel. The sketch updates first, so
        the occurrence that crosses the threshold is itself admitted."""
        est = self.sketch.add(tok)
        keep = est >= self.min_count
        n_drop = int(len(tok) - keep.sum())
        if n_drop:
            if self._drops is None:
                from ..obs import REGISTRY
                self._drops = REGISTRY.counter(
                    "store_admit_drops_total",
                    "token occurrences below admit_min_count routed to "
                    "the OOB lane instead of a table slot")
            self._drops.inc(n_drop)
            tok = np.where(keep, tok, self.sentinel)
        return tok


def make_admission(hash_capacity: int, admit_min_count: int,
                   seed: int, epoch: int, part: int
                   ) -> Optional[AdmissionFilter]:
    """The filter of one part's training stream, or None when the knob is
    off: one definition of the (seed, epoch, part) -> sketch seed mix for
    the producer threads (learners/sgd.py) and the worker processes
    (data/pack_stream.spec_iter)."""
    if admit_min_count <= 0:
        return None
    mix = (int(seed) * 0x9E3779B97F4A7C15
           + int(epoch) * 0xBF58476D1CE4E5B9
           + int(part)) & ((1 << 63) - 1)
    return AdmissionFilter(hash_capacity, admit_min_count, seed=mix)
