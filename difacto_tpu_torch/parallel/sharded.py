"""The table kernels over key-range shards (port-own, like ops/build.py).

Under an ``fs``-sharded mesh the slot table is ``fs`` plain ``[C/fs, W]``
tables, one per key range (parallel/mesh.py). A batch's slot vector is
sorted: its real slots ascend and its out-of-bounds pads (``C + j``) come
last, so the lanes of each shard are one contiguous run of it. The host
finds the ``fs + 1`` split offsets with ``np.searchsorted`` when it packs
or stages the batch (:func:`plan_slots`) and writes the shard-local slots
beside the global ones; the pad tail goes to the last shard's run, where
its local slots are ``>= C/fs``, so the kernel zeroes them on the gather
and drops them on the push. The kernels are the flat path's, unchanged:

- :func:`sharded_gather`: one ``gather_rows`` launch per non-empty shard
  run, each writing its own lanes of one output (so every lane is written
  exactly once, by the kernel, and the pull equals the flat gather bit
  for bit, -0.0 and NaN payloads included);
- :func:`sharded_push`: one ``fm_update_rows`` launch per non-empty run
  (the FTRL/AdaGrad push), :func:`sharded_scatter` one ``scatter_rows``
  launch (the epoch-0 count push, the epilogue off).

A shard with an empty run launches nothing. On a CPU table the wrappers
run their plain versions (ops/fused.py); :func:`sharded_gather_ref` and
:func:`sharded_push_ref` are the loops over the shards with those plain
versions, which the tests hold the routing against.

The mesh lies on one physical device (parallel/mesh.make_mesh), so the
table stays one tensor there and each shard is a view of its rows
(parallel/mesh.state_sharding): the fs key ranges cost no memory beyond the
table. Placing shards on several cards, each holding only its own rows,
is a ROADMAP.md follow-up.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import fused

class ShardedSlots(NamedTuple):
    """A batch's slot vector with its shard routing: the global sorted
    slots (OOB pads last), the shard-local slots of the same lanes and
    the ``fs + 1`` host offsets (lanes ``[offsets[i], offsets[i+1])``
    belong to shard ``i``)."""
    slots: torch.Tensor
    local: torch.Tensor
    offsets: Tuple[int, ...]

    @property
    def shape(self):
        return self.slots.shape

    @property
    def device(self) -> torch.device:
        return self.slots.device


def plan_slots(slots: np.ndarray, capacity: int, fs: int
               ) -> Tuple[Tuple[int, ...], np.ndarray]:
    """(offsets, local int32) of a sorted slot vector over ``fs`` equal key
    ranges of a ``capacity``-row table, on the host: lanes below each
    shard's upper bound by ``np.searchsorted``, the pad tail in the last
    shard's run, each run rebased to its shard's first row."""
    slots = np.asarray(slots)
    rows = capacity // fs
    cut = np.searchsorted(slots, np.arange(1, fs, dtype=np.int64) * rows)
    offsets = (0, *(int(c) for c in cut), len(slots))
    base = np.repeat(np.arange(fs, dtype=np.int64) * rows,
                     np.diff(np.asarray(offsets)))
    return offsets, (slots.astype(np.int64) - base).astype(np.int32)


def route(slots: torch.Tensor, host_slots: np.ndarray, capacity: int,
          fs: int) -> ShardedSlots:
    """:class:`ShardedSlots` of a device slot vector whose host copy is
    ``host_slots``: the local slots go to the device in one copy."""
    offsets, local = plan_slots(host_slots, capacity, fs)
    return ShardedSlots(slots, torch.from_numpy(local).to(slots.device),
                        offsets)


def _runs(ss: ShardedSlots):
    o = ss.offsets
    for i in range(len(o) - 1):
        if o[i + 1] > o[i]:
            yield i, o[i], o[i + 1]


def sharded_gather(shards: Sequence[torch.Tensor], ss: ShardedSlots
                   ) -> torch.Tensor:
    """The pull over key-range shards (``shards[i]`` is shard ``i``'s
    table): each non-empty run is gathered by the kernel (the plain
    version on the CPU) into its lanes of one ``[u, W]`` output."""
    t0 = shards[0]
    out = torch.empty((ss.slots.shape[0], t0.shape[1]), dtype=t0.dtype,
                      device=t0.device)
    for i, a, b in _runs(ss):
        fused.gather_rows(shards[i], ss.local[a:b], out=out[a:b])
    return out


def sharded_push(shards: Sequence[torch.Tensor], ss: ShardedSlots,
                 rows: torch.Tensor, gw: torch.Tensor, gV: torch.Tensor,
                 vmask: torch.Tensor, epi: fused.Epilogue,
                 epilogue: Callable) -> None:
    """The fused FTRL/AdaGrad push over key-range shards, in place: each
    non-empty run's rows go through ``fm_update_rows`` on its shard."""
    for i, a, b in _runs(ss):
        fused.fm_update_rows(shards[i], ss.local[a:b], rows[a:b], gw[a:b],
                             gV[a:b], vmask[a:b], epi, epilogue)


def sharded_scatter(shards: Sequence[torch.Tensor], ss: ShardedSlots,
                    rows: torch.Tensor) -> None:
    """Rows written at their slots over key-range shards, in place (the
    scatter with its epilogue off): one launch per non-empty run."""
    for i, a, b in _runs(ss):
        fused.scatter_rows(shards[i], ss.local[a:b], rows[a:b])


# --------------------------------------------------------- plain versions
def sharded_gather_ref(shards: Sequence[torch.Tensor], ss: ShardedSlots
                       ) -> torch.Tensor:
    """Plain version of :func:`sharded_gather`: every shard's run through
    ``gather_rows_ref``, concatenated in shard order."""
    parts: List[torch.Tensor] = []
    for i, a, b in _runs(ss):
        parts.append(fused.gather_rows_ref(shards[i], ss.local[a:b]))
    if not parts:
        return shards[0].new_zeros((0, shards[0].shape[1]))
    return torch.cat(parts)


def sharded_push_ref(shards: Sequence[torch.Tensor], ss: ShardedSlots,
                     rows: torch.Tensor, gw: Optional[torch.Tensor],
                     gV: Optional[torch.Tensor],
                     vmask: Optional[torch.Tensor],
                     epilogue: Optional[Callable]) -> None:
    """Plain version of :func:`sharded_push` (``epilogue`` set) and of
    :func:`sharded_scatter` (``epilogue`` None): every run through
    ``fm_update_rows_ref`` / ``scatter_rows_ref``."""
    for i, a, b in _runs(ss):
        if epilogue is None:
            fused.scatter_rows_ref(shards[i], ss.local[a:b], rows[a:b])
        else:
            fused.fm_update_rows_ref(shards[i], ss.local[a:b], rows[a:b],
                                     gw[a:b], gV[a:b], vmask[a:b],
                                     epilogue)
