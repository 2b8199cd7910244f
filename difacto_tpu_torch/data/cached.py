"""Pre-localized batches over a ``.rec`` cache (counterpart of
difacto_tpu/data/cached.py; the reference's CRB flow,
src/reader/crb_parser.h:16-47, over the cache task=convert writes).

Members store compacted CSR (uint32 positions into a sorted reversed-id
``uniq``, rec.py), so an epoch skips the parse and the sort/unique of
the localizer: each batch costs an O(uniq) slot map and the packing.

Batches never span members (each member has its own uniq space); the
converter aligns members to the training batch size, so only a part's
tail batch runs short. Shuffle is a seeded member order plus a row
permutation within each member; negative downsampling keeps the
reference's arithmetic (batch_reader.cc:58-64). A batch that covers only
part of its member is compacted again, so it ships only its own
features.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from .reader import expand_uri
from .rec import part_members, read_rec_block_ex, rec_members
from .rowblock import RowBlock, RowBlockBuilder


def cache_is_localized(uri: str) -> bool:
    """True if the first member of the cache carries ``uniq``."""
    return cache_probe(uri)[0]


def cache_probe(uri: str) -> Tuple[bool, int]:
    """(is_localized, first member's rows), in one member read; the
    learner warns when members dwarf the training batch."""
    pairs = rec_members(*expand_uri(uri, with_sizes=True))
    if not pairs:
        return False, 0
    blk, uniq = read_rec_block_ex(pairs[0][0])
    return uniq is not None, blk.size


class CachedBatchReader:
    """Yields ``(localized_block, uniq, counts)`` per batch: ``uniq`` the
    member's (or the batch's) sorted reversed ids, the block's ``index``
    uint32 positions into it, and with ``need_counts`` each uniq lane's
    occurrence count over the batch's rows (the epoch-0 count push)."""

    def __init__(self, uri: str, part_idx: int = 0, num_parts: int = 1,
                 batch_size: int = 100, shuffle: bool = False,
                 neg_sampling: float = 1.0, seed: int = 0,
                 need_counts: bool = False):
        pairs = rec_members(*expand_uri(uri, with_sizes=True))
        if not pairs:
            raise FileNotFoundError(f"empty rec cache: {uri!r}")
        self._members = part_members(pairs, part_idx, num_parts)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.neg_sampling = neg_sampling
        self.seed = seed
        self.need_counts = need_counts

    def __iter__(self) -> Iterator[Tuple[RowBlock, np.ndarray,
                                         Optional[np.ndarray]]]:
        rng = np.random.RandomState(self.seed)
        order = np.arange(len(self._members))
        if self.shuffle:
            rng.shuffle(order)
        for mi in order:
            blk, uniq = read_rec_block_ex(self._members[mi])
            if uniq is None:
                raise ValueError(
                    f"cache member {self._members[mi]!r} is not "
                    "pre-localized; re-convert with rec_localize=1")
            rows = np.arange(blk.size)
            if self.shuffle:
                rng.shuffle(rows)
            if self.neg_sampling < 1.0:
                # keep a negative iff p <= 1 - neg_sampling
                keep = (blk.label[rows] > 0) | (
                    rng.random_sample(len(rows)) <= 1.0 - self.neg_sampling)
                rows = rows[keep]
            whole = (len(rows) == blk.size and blk.size <= self.batch_size
                     and not self.shuffle)
            for s in range(0, len(rows), self.batch_size):
                sel = rows[s:s + self.batch_size]
                if whole:
                    sub = blk
                else:
                    b = RowBlockBuilder()
                    b.push_rows(blk, sel)
                    sub = b.build()
                u = uniq
                if len(sel) < blk.size:
                    # a part of the member: ship only its own features
                    # (uniq is sorted, so the subset stays sorted)
                    loc, inv = np.unique(sub.index, return_inverse=True)
                    sub = dataclasses.replace(
                        sub, index=inv.astype(np.uint32))
                    u = uniq[loc]
                counts = None
                if self.need_counts:
                    counts = np.bincount(
                        sub.index.astype(np.int64),
                        minlength=len(u)).astype(np.float32)
                yield sub, u, counts
