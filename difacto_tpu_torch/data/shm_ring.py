"""Fixed-capacity ring of shared-memory slots for cross-process batches
(counterpart of difacto_tpu/data/shm_ring.py).

The transport half of the process producer pipeline
(data/producer_pool.py ProcessProducerPool): worker processes run the
host pipeline (read -> parse -> hash -> dedup -> pack) and write each
packed payload's numpy arrays straight into a slot of one preallocated
``multiprocessing.shared_memory`` segment; the consumer wraps the slot
with ``np.frombuffer`` views, with no copy of its own. Threads cannot
give this overlap: the producer thread and the dispatch loop take turns
on the GIL.

Slot layout (one slot = ``slot_bytes`` of the segment)::

    [array 0 bytes | pad to 64 | array 1 bytes | ...]   from offset 0
    [pickled meta][ meta_len u32 | part u32 | seq u32 |
                    gen u32 | span u32 | payload u64 ]  tail header

The tail header carries the item identity (part id, seq no of the FIRST
item, attempt generation), an item COUNT (a producer may coalesce
several small consecutive items of one part into a single slot — the
multi-part-per-slot packing that amortizes slot leases and ring_wait
when payloads run far below slot_bytes; the items then occupy seq ..
seq+count-1), the PRODUCER'S trace span id (``span`` — the obs/trace.py
span that packed this item, so the consumer's unpack/step spans can
point at the exact producer span that built their batch across the
process boundary) and the pickled meta — the item's structure with every array
replaced by a (shape, dtype, offset) placeholder — so a slot is fully
self-describing: the consumer rebuilds the exact item object (for
count > 1: the list of items) from the slot alone.

Lease/release + backpressure: free slot ids travel through per-owner
multiprocessing queues (one queue per worker, slots pre-partitioned), so
a worker blocks when all of ITS slots are leased — bounded memory, and no
cross-part starvation: the worker producing the part the consumer is
draining always has its own slots coming back.

Robust cleanup: the owning (consumer) process registers an ``atexit``
unlink for every live ring, ``unlink`` is idempotent, and attaching
workers leave the owner's resource-tracker registration alone — no
leaked ``/dev/shm`` segments on clean teardown, consumer
early-exit, or a worker raising or dying.
"""

from __future__ import annotations

import atexit
import itertools
import os
import pickle
import struct
from dataclasses import fields, is_dataclass
from multiprocessing import shared_memory
from typing import Any, List, Optional, Tuple

import numpy as np

from ..utils.locktrace import mutex

# meta_len, part, seq, gen, item count, producer span id, payload_bytes
_HEADER = struct.Struct("<IIIIIIQ")
# segment names: the prefix, the owner's pid, a sequence number
RING_PREFIX = "difacto_torch_ring_"
_ALIGN = 64

# live rings created by THIS process, for the atexit safety net
_live_rings: dict = {}
# segments whose close() found live views: pinned so __del__ never runs
# mid-process (the views' owner may be an in-flight device transfer)
_pinned_maps: list = []
_ring_seq = itertools.count()


class SlotOverflow(Exception):
    """The encoded item does not fit in one slot (caller falls back to a
    plain pickled transport for this item)."""


def _cleanup_live_rings() -> None:  # pragma: no cover - process teardown
    for ring in list(_live_rings.values()):
        ring.unlink()


atexit.register(_cleanup_live_rings)


# ------------------------------------------------------------ encoding
# Item -> (spec tree, [ndarray leaves]). The spec tree mirrors the item's
# structure with arrays replaced by placeholders; everything non-array,
# non-container rides the pickled meta as-is. Dataclasses (RowBlock, the
# pack_stream.BlkInfo) reconstruct via their field dict.

def encode_item(obj: Any, arrays: List[np.ndarray]):
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        arrays.append(a)
        return ("nd", len(arrays) - 1, a.shape, a.dtype.str)
    if isinstance(obj, tuple):
        kids = [encode_item(v, arrays) for v in obj]
        if hasattr(obj, "_fields"):  # NamedTuple
            return ("ntu", type(obj), kids)
        return ("tu", kids)
    if isinstance(obj, list):
        return ("li", [encode_item(v, arrays) for v in obj])
    if isinstance(obj, dict):
        return ("di", [(k, encode_item(v, arrays)) for k, v in obj.items()])
    if is_dataclass(obj) and not isinstance(obj, type):
        return ("dc", type(obj),
                [(f.name, encode_item(getattr(obj, f.name), arrays))
                 for f in fields(obj)])
    return ("py", obj)


def decode_item(spec, arrays: List[np.ndarray]):
    tag = spec[0]
    if tag == "nd":
        return arrays[spec[1]]
    if tag == "tu":
        return tuple(decode_item(s, arrays) for s in spec[1])
    if tag == "ntu":
        return spec[1](*(decode_item(s, arrays) for s in spec[2]))
    if tag == "li":
        return [decode_item(s, arrays) for s in spec[1]]
    if tag == "di":
        return {k: decode_item(s, arrays) for k, s in spec[1]}
    if tag == "dc":
        return spec[1](**{k: decode_item(s, arrays) for k, s in spec[2]})
    return spec[1]


def materialize_item(item: Any) -> Any:
    """Deep-copy an item's arrays out of shared memory (same structure,
    private buffers). The consumer uses this to EVICT buffered items from
    their ring slots when a re-queued part needs slots back but every
    live worker is backpressure-blocked on a future part — the copy costs
    one memcpy, the alternative is a stall."""
    arrays: List[np.ndarray] = []
    spec = encode_item(item, arrays)
    return decode_item(spec, [np.array(a) for a in arrays])


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class SlotLease:
    """Consumer-side handle on a leased slot: the reconstructed item's
    arrays VIEW the slot's shared memory, so the slot must not return to
    the ring until the consumer is done with them (for the learner: until
    the device transfer/step consuming the views has completed).
    ``release`` is idempotent.

    A multi-item slot (header count > 1) is shared by every item it
    carries: ``split(k)`` hands out k child handles, each independently
    idempotent, and the slot returns to the ring when the LAST child
    releases."""

    __slots__ = ("_ring", "slot", "_refs", "_mu", "_released")

    def __init__(self, ring: "ShmRing", slot: int):
        self._ring = ring
        self.slot = slot
        self._refs = 1
        self._released = False
        self._mu = mutex()

    def split(self, k: int):
        """k per-item child handles sharing this slot (k >= 1). The
        parent's own reference transfers to the children — callers
        release only the children afterwards."""
        with self._mu:
            self._refs += k - 1
        self._released = True  # the children own the slot now
        return [_LeaseShare(self) for _ in range(k)]

    def _dec(self) -> None:
        with self._mu:
            self._refs -= 1
            last = self._refs == 0
        if last:
            self._ring.release(self.slot)

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._dec()


class _LeaseShare:
    """One item's handle on a shared multi-item slot (idempotent)."""

    __slots__ = ("_parent", "_released")

    def __init__(self, parent: SlotLease):
        self._parent = parent
        self._released = False

    @property
    def slot(self) -> int:
        return self._parent.slot

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._parent._dec()


class ShmRing:
    """One shared-memory segment carved into ``n_slots`` slots of
    ``slot_bytes``, with free-slot queues partitioned over ``n_queues``
    owners (contiguous blocks: slot s belongs to queue s // (n_slots //
    n_queues))."""

    def __init__(self, n_slots: int, slot_bytes: int, n_queues: int = 1,
                 ctx=None):
        if n_slots % max(n_queues, 1):
            raise ValueError(f"n_slots={n_slots} must divide evenly over "
                             f"n_queues={n_queues}")
        import multiprocessing as mp
        ctx = ctx or mp.get_context("spawn")
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self.n_queues = max(n_queues, 1)
        self._per_q = n_slots // self.n_queues
        self.name = f"{RING_PREFIX}{os.getpid()}_{next(_ring_seq)}"
        self._shm = shared_memory.SharedMemory(
            name=self.name, create=True, size=n_slots * slot_bytes)
        self._owner = True
        self._unlinked = False
        self._mu = mutex()
        self.free_qs = [ctx.Queue() for _ in range(self.n_queues)]
        for s in range(n_slots):
            self.free_qs[s // self._per_q].put(s)
        _live_rings[self.name] = self

    # ---------------------------------------------------------- attach
    def descriptor(self) -> Tuple[str, int, int, int]:
        """Picklable handle for workers (queues travel separately through
        the Process args — they are not picklable by value)."""
        return (self.name, self.n_slots, self.slot_bytes, self.n_queues)

    @classmethod
    def attach(cls, desc: Tuple[str, int, int, int]) -> "ShmRing":
        name, n_slots, slot_bytes, n_queues = desc
        ring = cls.__new__(cls)
        ring.n_slots = n_slots
        ring.slot_bytes = slot_bytes
        ring.n_queues = n_queues
        ring._per_q = n_slots // max(n_queues, 1)
        ring.name = name
        ring._shm = shared_memory.SharedMemory(name=name)
        ring._owner = False
        ring._unlinked = False
        ring._mu = mutex()
        # workers lease through the queue handed to them at spawn, not
        # through the ring object (mp queues are not picklable by value)
        ring.free_qs = []
        # NOTE on the resource tracker: spawn children share the parent's
        # tracker process, and its per-type name cache is a SET — the
        # attach-time re-register of the same name is a no-op, and the
        # owner's unlink unregisters it exactly once. (Do NOT unregister
        # here: that would strip the owner's registration and break its
        # unlink bookkeeping.)
        return ring

    # ----------------------------------------------------------- write
    def write(self, slot: int, item: Any, part: int, seq: int,
              gen: int, span: int = 0, count: int = 1) -> None:
        """Encode ``item`` into ``slot``. ``span`` is the producer-side
        trace span id riding the header (0 = tracing off); ``count`` > 1
        marks a multi-item slot (``item`` is then the LIST of coalesced
        items, occupying seq .. seq+count-1). Raises
        :class:`SlotOverflow` (leaving the slot reusable) when it does
        not fit."""
        arrays: List[np.ndarray] = []
        spec = encode_item(item, arrays)
        offs = []
        off = 0
        for a in arrays:
            offs.append(off)
            off = _align(off + a.nbytes)
        meta = pickle.dumps((spec, [(o, a.shape, a.dtype.str)
                                    for o, a in zip(offs, arrays)]),
                            protocol=pickle.HIGHEST_PROTOCOL)
        need = off + len(meta) + _HEADER.size
        if need > self.slot_bytes:
            raise SlotOverflow(
                f"item needs {need} bytes > slot_bytes={self.slot_bytes}")
        base = slot * self.slot_bytes
        buf = self._shm.buf
        for o, a in zip(offs, arrays):
            dst = np.frombuffer(buf, dtype=a.dtype, count=a.size,
                                offset=base + o).reshape(a.shape)
            np.copyto(dst, a)
        end = base + self.slot_bytes
        buf[end - _HEADER.size - len(meta):end - _HEADER.size] = meta
        _HEADER.pack_into(buf, end - _HEADER.size, len(meta), part, seq,
                          gen, count, span & 0xFFFFFFFF, off)

    # ------------------------------------------------------------ read
    def read_header(self, slot: int) -> Tuple[int, int, int, int, int]:
        """(part, seq, gen, producer_span, count) without decoding the
        item — the consumer's cross-process span linkage (obs/trace.py)
        plus the multi-item count."""
        end = (slot + 1) * self.slot_bytes
        _, part, seq, gen, count, span, _ = _HEADER.unpack_from(
            self._shm.buf, end - _HEADER.size)
        return part, seq, gen, span, count

    def read(self, slot: int) -> Tuple[Any, int, int, int]:
        """(item, part, seq, gen) — the item's arrays are zero-copy views
        into the slot; hold the lease until done with them. For a
        multi-item slot (header count > 1) ``item`` is the list of
        items."""
        base = slot * self.slot_bytes
        end = base + self.slot_bytes
        buf = self._shm.buf
        meta_len, part, seq, gen, _count, _span, _ = _HEADER.unpack_from(
            buf, end - _HEADER.size)
        spec, placements = pickle.loads(
            bytes(buf[end - _HEADER.size - meta_len:end - _HEADER.size]))
        arrays = [
            np.frombuffer(buf, dtype=np.dtype(dt),
                          count=int(np.prod(shape)) if shape else 1,
                          offset=base + o).reshape(shape)
            for o, shape, dt in placements
        ]
        return decode_item(spec, arrays), part, seq, gen

    # --------------------------------------------------- lease/release
    def lease(self, qidx: int, timeout: float = 0.1) -> Optional[int]:
        """Take a free slot from queue ``qidx``; None on timeout (callers
        loop, checking their stop flag — this is the backpressure point
        when all of the owner's slots are leased)."""
        import queue as _q
        try:
            return self.free_qs[qidx].get(timeout=timeout)
        except _q.Empty:
            return None

    def release(self, slot: int) -> None:
        """Return a slot to its home queue (consumer side)."""
        if self._unlinked or not self.free_qs:
            return
        try:
            self.free_qs[slot // self._per_q].put_nowait(slot)
        except (ValueError, OSError):  # pragma: no cover - queue closed
            pass

    # --------------------------------------------------------- cleanup
    def close(self) -> None:
        try:
            self._shm.close()
        except BufferError:
            # np.frombuffer views still alive (e.g. the learner's last
            # staged batch): pin the SharedMemory object so a later
            # GC-time __del__ can't re-raise; the mapping frees with the
            # process — what matters for leak-freedom is unlink()
            if self._shm not in _pinned_maps:
                _pinned_maps.append(self._shm)
        except FileNotFoundError:  # pragma: no cover
            pass

    def unlink(self) -> None:
        """Remove the segment name (idempotent; owner only). Safe to call
        with worker processes still attached — their mappings survive
        until they close, but no /dev/shm entry outlives the ring."""
        with self._mu:
            if self._unlinked:
                return
            # lint: ok(data-race) the second root is native.get_lib,
            # whose temp-file unlink() resolves to this method by name;
            # only the ring's owner unlinks it
            self._unlinked = True
        _live_rings.pop(self.name, None)
        self.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass
