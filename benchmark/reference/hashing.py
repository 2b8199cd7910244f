"""Frozen copy of the hashed store's rule from a Criteo field to a table
slot: the field's text hashed with MurmurHash64A (seed 0), its column in
the low 12 bits of the feature id, the id's nibbles reversed, and the
slot ``rev_id mod (capacity - 1) + 1`` (row 0 is the trash row).

Worked from the generator's values, not from the text: every distinct
(field, value) pair is hashed once. A CPU test holds this copy equal to
the program's parser and hash on the same rows.
"""

from __future__ import annotations

import numpy as np

_M64 = np.uint64(0xC6A4A7935BD1E995)
_R = np.uint64(47)
_GROUP_BITS = np.uint64(12)


def murmur64a_short(words: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """MurmurHash64A (seed 0) of byte strings of at most 8 bytes, given as
    their little-endian uint64 words and lengths."""
    words = words.astype(np.uint64)
    lens = lens.astype(np.uint64)
    h = lens * _M64
    full = lens == 8
    k = words * _M64
    k ^= k >> _R
    k *= _M64
    h = np.where(full, (h ^ k) * _M64, h)
    tail = (lens > 0) & ~full
    h = np.where(tail, (h ^ words) * _M64, h)
    h ^= h >> _R
    h *= _M64
    h ^= h >> _R
    return h


def text_words(values: np.ndarray, hex8: bool):
    """(word, length) of each value's text: 8 lower-case hex digits, or a
    decimal without leading zeros."""
    v = values.astype(np.int64)
    if hex8:
        digits = [(v >> (28 - 4 * j)) & 15 for j in range(8)]
        chars = [np.where(d < 10, 48 + d, 87 + d) for d in digits]
        lens = np.full(v.shape, 8, np.int64)
    else:
        lens = np.ones(v.shape, np.int64)
        for p in range(1, 8):
            lens += v >= 10 ** p
        chars = [np.where(j < lens, 48 + (v // 10 ** np.maximum(
            lens - 1 - j, 0)) % 10, 0) for j in range(8)]
    word = np.zeros(v.shape, np.uint64)
    for j, c in enumerate(chars):
        word |= c.astype(np.uint64) << np.uint64(8 * j)
    return word, lens


def reverse_nibbles(x: np.ndarray) -> np.ndarray:
    """Reverse the 16 nibbles of uint64 ids."""
    x = np.asarray(x, np.uint64)
    x = (x << np.uint64(32)) | (x >> np.uint64(32))
    x = ((x & np.uint64(0x0000FFFF0000FFFF)) << np.uint64(16)) | \
        ((x & np.uint64(0xFFFF0000FFFF0000)) >> np.uint64(16))
    x = ((x & np.uint64(0x00FF00FF00FF00FF)) << np.uint64(8)) | \
        ((x & np.uint64(0xFF00FF00FF00FF00)) >> np.uint64(8))
    x = ((x & np.uint64(0x0F0F0F0F0F0F0F0F)) << np.uint64(4)) | \
        ((x & np.uint64(0xF0F0F0F0F0F0F0F0)) >> np.uint64(4))
    return x


def field_slots(values: np.ndarray, group: int, hex8: bool,
                capacity: int) -> np.ndarray:
    """Slots of one field's values (int64 in [1, capacity))."""
    word, lens = text_words(values, hex8)
    ids = (murmur64a_short(word, lens) << _GROUP_BITS) | np.uint64(group)
    rev = reverse_nibbles(ids)
    return (rev % np.uint64(capacity - 1) + np.uint64(1)).astype(np.int64)
