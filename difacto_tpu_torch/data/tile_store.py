"""Keyed host array store and tile cache for blocked training data
(counterpart of difacto_tpu/data/tile_store.py).

- :class:`DataStore` <- DataStore/DataStoreMemory (src/data/data_store.h:
  24-163): keyed typed arrays with range fetch; with ``max_mem_bytes``
  the least recently used entries spill to ``spill_dir`` as .npy files
  and reload on demand.
- :class:`TileCache` <- TileStore (src/data/tile_store.h:32-168): an LRU
  cache of *built* tiles (device tensors here) keyed by (rowblk, colblk),
  bounded by count and by bytes, so the batch learners cap device memory
  and rebuild evicted tiles on demand.

A tile's bytes are its tensors' (and numpy arrays') bytes, found through
NamedTuples, tuples, lists and dicts; plain ints count nothing. The port's
tiles hold the same arrays at the same sizes as the JAX package's, so a
byte budget evicts the same tiles in both.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch


class DataStore:
    """Host store of named numpy arrays with optional LRU disk spill."""

    def __init__(self, max_mem_bytes: int = 0,
                 spill_dir: Optional[str] = None):
        self._mem: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._meta: Dict[str, Tuple[tuple, np.dtype]] = {}
        self._spilled: Dict[str, str] = {}
        self._spill_seq = 0
        self.max_mem_bytes = max_mem_bytes
        self.spill_dir = spill_dir
        if max_mem_bytes and not spill_dir:
            raise ValueError("max_mem_bytes requires spill_dir")

    def store(self, key: str, data: np.ndarray) -> None:
        data = np.asarray(data)
        self._meta[key] = (data.shape, data.dtype)
        self._drop_spill(key)
        self._mem[key] = data
        self._mem.move_to_end(key)
        self._maybe_spill()

    def fetch(self, key: str, begin: int = 0,
              end: Optional[int] = None) -> np.ndarray:
        """The [begin, end) row range of key (Fetch, data_store.h:77-96)."""
        if key not in self._meta:
            raise KeyError(key)
        arr = self._mem.get(key)
        if arr is None:
            arr = np.load(self._spilled[key])
            self._mem[key] = arr
            self._drop_spill(key)
            self._maybe_spill()
        self._mem.move_to_end(key)
        return arr[begin:end] if (begin or end is not None) else arr

    def remove(self, key: str) -> None:
        self._meta.pop(key, None)
        self._mem.pop(key, None)
        self._drop_spill(key)

    def size(self, key: str) -> int:
        shape, _ = self._meta[key]
        return int(np.prod(shape)) if shape else 1

    def keys(self):
        return list(self._meta)

    def _mem_bytes(self) -> int:
        return sum(a.nbytes for a in self._mem.values())

    def _drop_spill(self, key: str) -> None:
        path = self._spilled.pop(key, None)
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _maybe_spill(self) -> None:
        if not self.max_mem_bytes:
            return
        os.makedirs(self.spill_dir, exist_ok=True)
        while self._mem_bytes() > self.max_mem_bytes and len(self._mem) > 1:
            key, arr = self._mem.popitem(last=False)  # least recently used
            self._spill_seq += 1
            path = os.path.join(self.spill_dir,
                                f"spill-{self._spill_seq:08d}.npy")
            np.save(path, arr)
            self._spilled[key] = path


def tensor_nbytes(tile: Any) -> int:
    """Bytes of the tensors and numpy arrays in ``tile``, through
    NamedTuples, tuples, lists and dicts (``None`` counts nothing)."""
    if isinstance(tile, torch.Tensor):
        return tile.numel() * tile.element_size()
    if isinstance(tile, np.ndarray):
        return int(tile.nbytes)
    if isinstance(tile, (tuple, list)):
        return sum(tensor_nbytes(x) for x in tile)
    if isinstance(tile, dict):
        return sum(tensor_nbytes(x) for x in tile.values())
    return 0


class TileCache:
    """LRU cache of built tiles keyed by (rowblk_id, colblk_id).

    ``build(rowblk_id, colblk_id)`` constructs a tile. Two bounds, each 0
    = none: ``max_items`` (count) and ``max_bytes`` (the sum of
    ``sizeof`` over the entries, :func:`tensor_nbytes` by default). At
    least one entry always stays. ``None`` results (empty tiles) are
    cached too, at no bytes.
    """

    def __init__(self, build: Callable[[Hashable, Hashable], Any],
                 max_items: int = 0, max_bytes: int = 0,
                 sizeof: Optional[Callable[[Any], int]] = None):
        self._build = build
        self._cache: "OrderedDict[Tuple[Hashable, Hashable], " \
            "Tuple[Any, int]]" = OrderedDict()
        self.max_items = max_items
        self.max_bytes = max_bytes
        self._sizeof = sizeof or tensor_nbytes
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def fetch(self, rowblk_id: Hashable, colblk_id: Hashable) -> Any:
        key = (rowblk_id, colblk_id)
        if key in self._cache:
            self._cache.move_to_end(key)
            self.hits += 1
            return self._cache[key][0]
        self.misses += 1
        tile = self._build(rowblk_id, colblk_id)
        sz = self._sizeof(tile)
        self._cache[key] = (tile, sz)
        self._bytes += sz
        while len(self._cache) > 1 and (
                (self.max_items and len(self._cache) > self.max_items)
                or (self.max_bytes and self._bytes > self.max_bytes)):
            _, (_, esz) = self._cache.popitem(last=False)
            self._bytes -= esz
        return tile

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._cache)
