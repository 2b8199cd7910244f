"""Sorted key->value list algebra on the host (counterpart of
difacto_tpu/ops/kv.py, numpy only).

- ``find_position``  <- FindPosition (src/common/find_position.h:15-58)
- ``kv_match``       <- KVMatch, fixed and variable length
  (src/common/kv_match.h:77-163, kv_match-inl.h:22-123)
- ``kv_union``       <- KVUnion (src/common/kv_union.h:34-94)
- ``expand_ranges``  the ragged-gather expansion the three share

Each is one searchsorted/merge pass. Keys must be sorted and unique (the
ps-lite requirement, kvstore_dist.h:95), which is checked. Ops: "assign"
and "add" (the reference's ASSIGN/PLUS, kv_match.h:23-30).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _check_sorted_unique(keys: np.ndarray, name: str) -> None:
    if len(keys) > 1 and not (keys[1:] > keys[:-1]).all():
        raise ValueError(f"{name} keys must be sorted and unique")


def expand_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat indices covering each [starts[i], starts[i]+lens[i]) range,
    concatenated. Empty-safe."""
    lens = np.asarray(lens, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out_starts = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(lens[:-1], out=out_starts[1:])
    return (np.repeat(starts - out_starts, lens)
            + np.arange(total, dtype=np.int64))


def find_position(src_keys: np.ndarray, dst_keys: np.ndarray) -> np.ndarray:
    """int32 position of each dst key within src (-1 if absent)."""
    _check_sorted_unique(src_keys, "src")
    _check_sorted_unique(dst_keys, "dst")
    n = len(src_keys)
    pos = np.searchsorted(src_keys, dst_keys).astype(np.int64)
    hit = pos < n
    if n:
        hit &= src_keys[np.minimum(pos, n - 1)] == dst_keys
    return np.where(hit, pos, -1).astype(np.int32)


def _apply(dst_vals: np.ndarray, d_idx, src_vals: np.ndarray, s_idx,
           op: str) -> None:
    if op == "assign":
        dst_vals[d_idx] = src_vals[s_idx]
    elif op == "add":
        dst_vals[d_idx] += src_vals[s_idx]
    else:
        raise ValueError(f"unknown op {op!r}")


def kv_match(src_keys: np.ndarray, src_vals: np.ndarray,
             dst_keys: np.ndarray, dst_vals: np.ndarray,
             op: str = "assign", val_len: int = 1) -> int:
    """dst_vals[i] op= src_vals[j] where dst_keys[i] == src_keys[j],
    ``val_len`` values per key (kv_match.h:77-118). Mutates dst_vals in
    place; returns the number of matched values."""
    if dst_vals.ndim != 1 or src_vals.ndim != 1:
        raise ValueError("kv_match expects flat value arrays")
    pos = find_position(src_keys, dst_keys)
    hit = np.nonzero(pos >= 0)[0]
    k = np.arange(val_len, dtype=np.int64)
    s_idx = (pos[hit].astype(np.int64)[:, None] * val_len + k).ravel()
    d_idx = (hit[:, None].astype(np.int64) * val_len + k).ravel()
    _apply(dst_vals, d_idx, src_vals, s_idx, op)
    return int(len(hit)) * val_len


def kv_match_varlen(src_keys: np.ndarray, src_vals: np.ndarray,
                    src_lens: np.ndarray,
                    dst_keys: np.ndarray, dst_vals: np.ndarray,
                    dst_lens: np.ndarray, op: str = "assign") -> int:
    """Variable-length KVMatch (kv_match.h:120-163): key i owns
    ``lens[i]`` consecutive values, and matched keys must agree on their
    length (kv_match-inl.h:100). Mutates dst_vals; returns the matched
    value count."""
    pos = find_position(src_keys, dst_keys)
    hit = pos >= 0
    if not hit.any():
        return 0
    src_rows = pos[hit].astype(np.int64)
    if not (src_lens[src_rows] == dst_lens[hit]).all():
        raise ValueError("matched keys disagree on value lengths")
    src_off = np.zeros(len(src_keys) + 1, dtype=np.int64)
    np.cumsum(src_lens, out=src_off[1:])
    dst_off = np.zeros(len(dst_keys) + 1, dtype=np.int64)
    np.cumsum(dst_lens, out=dst_off[1:])
    lens = np.asarray(dst_lens)[hit].astype(np.int64)
    _apply(dst_vals, expand_ranges(dst_off[:-1][hit], lens), src_vals,
           expand_ranges(src_off[src_rows], lens), op)
    return int(lens.sum())


def kv_union(keys_a: np.ndarray, vals_a: np.ndarray,
             keys_b: np.ndarray, vals_b: np.ndarray,
             op: str = "add", val_len: int = 1
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Merged sorted union of two KV lists; duplicate keys combine by
    ``op`` (kv_union.h:34-94). Returns (keys, vals)."""
    _check_sorted_unique(keys_a, "a")
    _check_sorted_unique(keys_b, "b")
    keys = np.union1d(keys_a, keys_b)
    va = vals_a.reshape(len(keys_a), val_len)
    vb = vals_b.reshape(len(keys_b), val_len)
    out = np.zeros((len(keys), val_len), dtype=va.dtype)
    out[np.searchsorted(keys, keys_a)] = va
    pb = np.searchsorted(keys, keys_b)
    if op == "add":
        np.add.at(out, pb, vb)
    elif op == "assign":
        out[pb] = vb
    else:
        raise ValueError(f"unknown op {op!r}")
    return keys, out.reshape(-1) if val_len == 1 else out
