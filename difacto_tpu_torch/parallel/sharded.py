"""The table kernels over key-range shards (port-own, like ops/build.py).

Under an ``fs``-sharded mesh the slot table is ``fs`` plain tables of
``C/fs`` rows, shard ``f`` an allocation of its own on the mesh's
``devices[0][f]`` (:class:`ShardedState`; parallel/mesh.py). A batch's
slot vector is sorted: its real slots ascend and its out-of-bounds pads
(``C + j``) come last, so the lanes of each shard are one contiguous run
of it. The host finds the ``fs + 1`` split offsets with
``np.searchsorted`` when it packs or stages the batch (:func:`plan_slots`)
and sends each shard the local slots of its run, to the shard's device;
the pad tail goes to the last shard's run, where its local slots are
``>= C/fs``, so the kernel zeroes them on the gather and drops them on the
push. The kernels are the flat path's, unchanged, launched on the shard's
device:

- :func:`sharded_gather`: one ``gather_rows`` launch per non-empty shard
  run, on the shard's device; shard 0's run (on the home device) is
  written straight into its lanes of the one ``[u, W]`` output on the
  home device, every other run into a buffer on its shard's device that
  parallel/mesh.device_copy copies into its lanes. Every lane is written
  exactly once, by the kernel or by a copy of the kernel's bytes, so the
  pull equals the flat gather bit for bit, -0.0 and NaN payloads
  included;
- :func:`sharded_push`: each non-empty run's rows, gradients and mask
  copied to its shard's device and one ``fm_update_rows`` launch there
  (the FTRL/AdaGrad push), :func:`sharded_scatter` one ``scatter_rows``
  launch (the epoch-0 count push, the epilogue off).

A shard with an empty run launches nothing and moves nothing. On CPU
tables the wrappers run their plain versions (ops/fused.py);
:func:`sharded_gather_ref` and :func:`sharded_push_ref` are the loops
over the shards with those plain versions, which the tests hold the
routing against. :func:`shard_runs` hands any per-shard update its run's
lanes on the shard's device (the flat ``V_dim = 0`` columns' pulls and
pushes go through it).
"""

from __future__ import annotations

from typing import (Callable, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..ops import fused
from .mesh import device_copy


class ShardedState:
    """A slot-table state cut into ``fs`` key-range shards: ``shards[f]``
    is an ``SGDState`` of ``C/fs`` rows whose leaves are allocations of
    their own on shard ``f``'s device; no tensor holds the whole table.
    ``capacity`` is the logical table's (the row layout follows it, not a
    shard's row count). Iterating yields every leaf, shard by shard."""

    __slots__ = ("shards",)

    def __init__(self, shards: Sequence):
        self.shards = tuple(shards)

    @property
    def fs(self) -> int:
        return len(self.shards)

    @property
    def rows(self) -> int:
        """Rows per shard."""
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.rows * self.fs

    @property
    def devices(self) -> List[torch.device]:
        return [s.VVg.device for s in self.shards]

    def bounds(self) -> List[Tuple[int, int]]:
        """[(lo, hi)] global rows of each shard."""
        r = self.rows
        return [(f * r, (f + 1) * r) for f in range(self.fs)]

    def __iter__(self):
        for s in self.shards:
            yield from s

    def __repr__(self) -> str:
        return (f"ShardedState(fs={self.fs}, rows={self.rows}, on "
                f"{', '.join(str(d) for d in self.devices)})")


def shard_states(state) -> list:
    """[(shard state, lo, hi)] of a :class:`ShardedState`, or the one
    ``(state, 0, capacity)`` of a whole table."""
    if isinstance(state, ShardedState):
        return [(s, lo, hi) for s, (lo, hi) in zip(state.shards,
                                                   state.bounds())]
    return [(state, 0, state.capacity)]


def host_state(state):
    """The whole table on the host CPU, for inspection (tests, reports;
    a cold path): a ShardedState's leaves copied shard by shard and
    concatenated in shard order, a whole table's leaves copied."""
    parts = [s for s, _, _ in shard_states(state)]
    return type(parts[0])(*(torch.cat([p[i].cpu() for p in parts])
                            for i in range(len(parts[0]))))


class ShardedSlots(NamedTuple):
    """A batch's slot vector with its shard routing: the global sorted
    slots (OOB pads last) on the home device, the shard-local slots of
    each shard's run on that shard's device (``local[f]``, empty for an
    empty run) and the ``fs + 1`` host offsets (lanes ``[offsets[f],
    offsets[f+1])`` belong to shard ``f``)."""
    slots: torch.Tensor
    local: Tuple[torch.Tensor, ...]
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


def place_local(offsets: Sequence[int], local: np.ndarray,
                devices: Sequence[torch.device],
                to_device: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, ...]:
    """Each shard's run of the host local slots on its shard's device
    (``to_device(array, device)``, default ``torch.from_numpy(a).to``); an
    empty run is an empty tensor there, with no copy."""
    put = to_device or (lambda a, d: torch.from_numpy(a).to(d))
    out = []
    for f, dev in enumerate(devices):
        a, b = offsets[f], offsets[f + 1]
        out.append(put(np.ascontiguousarray(local[a:b]), dev) if b > a
                   else torch.empty(0, dtype=torch.int32, device=dev))
    return tuple(out)


def route(slots: torch.Tensor, host_slots: np.ndarray, capacity: int,
          fs: int, devices: Optional[Sequence[torch.device]] = None
          ) -> ShardedSlots:
    """:class:`ShardedSlots` of a device slot vector whose host copy is
    ``host_slots``: each shard's local slots go from the host to its
    device (``devices``, default all ``slots.device``)."""
    offsets, local = plan_slots(host_slots, capacity, fs)
    devices = list(devices) if devices is not None else [slots.device] * fs
    return ShardedSlots(slots, place_local(offsets, local, devices),
                        offsets)


def _runs(ss: ShardedSlots):
    o = ss.offsets
    for i in range(len(o) - 1):
        if o[i + 1] > o[i]:
            yield i, o[i], o[i + 1]


def shard_runs(ss: ShardedSlots, devices: Sequence[torch.device],
               *lanes: Optional[torch.Tensor]
               ) -> Iterator[Tuple[int, torch.Tensor, tuple]]:
    """``(f, local slots, parts)`` of each non-empty run: ``parts`` are
    the run's lanes of each home tensor in ``lanes`` (None stays None),
    copied to shard ``f``'s device (parallel/mesh.device_copy) unless the
    shard is the home's own, shard 0."""
    for i, a, b in _runs(ss):
        parts = tuple(
            None if t is None else t[a:b] if i == 0
            else device_copy(t[a:b], devices[i]) for t in lanes)
        yield i, ss.local[i], parts


def gather_home(ss: ShardedSlots, out: torch.Tensor,
                gather: Callable) -> torch.Tensor:
    """Fill ``out`` (home, one lane per slot) run by run: shard 0's run
    through ``gather(0, local, out_lanes)`` in place, every other run's
    ``gather(f, local, None)`` (computed on shard ``f``'s device) copied
    into its lanes."""
    for i, a, b in _runs(ss):
        if i == 0:
            gather(0, ss.local[0], out[a:b])
        else:
            device_copy(gather(i, ss.local[i], None), out=out[a:b])
    return out


def sharded_gather(shards: Sequence[torch.Tensor], ss: ShardedSlots
                   ) -> torch.Tensor:
    """The pull over key-range shards (``shards[f]`` is shard ``f``'s
    table, on its device; shard 0 on the home device): each non-empty run
    is gathered by the kernel (the plain version on the CPU) on its
    shard's device, into one ``[u, W]`` output on the home device."""
    t0 = shards[0]
    out = torch.empty((ss.slots.shape[0], t0.shape[1]), dtype=t0.dtype,
                      device=t0.device)
    return gather_home(ss, out, lambda f, local, o: fused.gather_rows(
        shards[f], local, out=o))


def sharded_push(shards: Sequence[torch.Tensor], ss: ShardedSlots,
                 rows: torch.Tensor, gw: torch.Tensor, gV: torch.Tensor,
                 vmask: torch.Tensor, epi: fused.Epilogue,
                 epilogue: Callable) -> None:
    """The fused FTRL/AdaGrad push over key-range shards, in place: each
    non-empty run's rows go to its shard's device and through
    ``fm_update_rows`` there."""
    for f, local, (r, g, v, m) in shard_runs(
            ss, [t.device for t in shards], rows, gw, gV, vmask):
        fused.fm_update_rows(shards[f], local, r, g, v, m, epi, epilogue)


def sharded_scatter(shards: Sequence[torch.Tensor], ss: ShardedSlots,
                    rows: torch.Tensor) -> None:
    """Rows written at their slots over key-range shards, in place (the
    scatter with its epilogue off): one launch per non-empty run, on its
    shard's device."""
    for f, local, (r,) in shard_runs(ss, [t.device for t in shards], rows):
        fused.scatter_rows(shards[f], local, r)


# --------------------------------------------------------- plain versions
def sharded_gather_ref(shards: Sequence[torch.Tensor], ss: ShardedSlots
                       ) -> torch.Tensor:
    """Plain version of :func:`sharded_gather`: every shard's run through
    ``gather_rows_ref`` on its device, brought home and concatenated in
    shard order."""
    home = shards[0].device
    parts: List[torch.Tensor] = []
    for i, a, b in _runs(ss):
        part = fused.gather_rows_ref(shards[i], ss.local[i])
        parts.append(part if i == 0 else device_copy(part, home))
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
    ``fm_update_rows_ref`` / ``scatter_rows_ref`` on its shard's
    device."""
    for f, local, (r, g, v, m) in shard_runs(
            ss, [t.device for t in shards], rows, gw, gV, vmask):
        if epilogue is None:
            fused.scatter_rows_ref(shards[f], local, r)
        else:
            fused.fm_update_rows_ref(shards[f], local, r, g, v, m,
                                     epilogue)
