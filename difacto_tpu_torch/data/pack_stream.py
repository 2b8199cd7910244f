"""Host batch preparation for the hashed store, shared by producer threads
and producer worker processes (counterpart of
difacto_tpu/data/pack_stream.py).

- :class:`ShapeSchedule`: every batch pads each dimension to the largest
  bucket seen so far for its key, so a steady stream of batches reuses one
  set of padded shapes (and, on the card, one set of allocator blocks).
  Caps only grow; thread-safe. ``snapshot``/``absorb`` carry the caps
  across the process boundary.
- :func:`prepare_hashed`: hash the raw ids, ONE ``np.unique`` (with counts
  on epoch 0) collapses localization, slot mapping and collision dedup,
  the slot vector is padded with ascending out-of-bounds lanes, and
  :func:`pack_payload` packs the panel layout for near-uniform rows, COO
  otherwise — the JAX package's buffers byte for byte. Two opt-in arms:
  ``stream_chunk`` adds the chunked-run backward layout built on the
  host (:func:`chunk_host`), ``device_dedup`` ships the raw hashed tokens
  (``ops/batch.pack_panel_raw``) and leaves the dedup to the step;
  ``admit`` sends the tokens count-min admission refuses to an
  out-of-bounds lane (capacity/sketch.py).
- :func:`prepare_from_uniq`: the same payload for a block the rec cache
  already localized (data/cached.py), from its sorted reversed ids.
- :func:`pack_mapped`: the same payloads for a block the dictionary store
  has already mapped (the JAX learner's ``_pack_mapped``), padded at the
  table's capacity after this block's inserts.
- :class:`StreamSpec` / :func:`spec_iter`: the picklable recipe a spawned
  worker rebuilds the hashed training stream from, yielding the same
  items the learner's producer threads yield, from text or from a
  pre-localized cache (``cached_uri``); :func:`timed_reader`
  accounts the read + parse half in both transports.

Nothing here imports torch: worker processes run this module alone.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..utils.locktrace import mutex


class ShapeSchedule:
    def __init__(self) -> None:
        self._caps: dict = {}
        self._lock = mutex()

    def cap(self, key: str, n: int, minimum: int = 8,
            exact: bool = False) -> int:
        """``exact`` keeps a plain sticky max instead of bucketing."""
        from ..ops.batch import bucket
        with self._lock:
            c = self._caps.get(key, 0)
            if n > c or c == 0:
                # floor degenerate dims like bucket(0) == minimum: empty
                # batches still need non-zero-sized shapes
                c = max(n, 1) if exact else bucket(n, minimum)
                self._caps[key] = c
            return c

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._caps)

    def absorb(self, caps: dict) -> None:
        """Merge already-resolved cap values (no re-bucketing)."""
        with self._lock:
            for k, v in caps.items():
                if v > self._caps.get(k, 0):
                    self._caps[k] = v


@dataclass
class BlkInfo:
    """What the consumer still needs of a row block once its payload is
    packed: shipping the block itself across the process boundary would
    send the raw arrays the payload already encodes."""
    size: int
    label: Optional[np.ndarray] = None


class Payload(NamedTuple):
    """A packed batch: ``layout`` "panel", "coo" or "panel_raw" (raw
    hashed tokens, no slot vector), the two host buffers, and the statics
    to unpack them. ``d2`` is the panel width or the COO nnz cap;
    ``row_cap`` (COO only) the widest row's cap; ``chunks`` the host-built
    chunked-run layout (ci, cl, cv) of a ``stream_chunk`` panel;
    ``host_slots`` a host copy of the slot section, which the learner
    keeps for the write-ahead log once the buffers are on the device."""
    layout: str
    i32: np.ndarray
    f32: np.ndarray
    binary: bool
    b_cap: int
    d2: int
    u_cap: int
    row_cap: int = 0
    chunks: Optional[tuple] = None
    host_slots: Optional[np.ndarray] = None


def pack_payload(shapes: ShapeSchedule, cblk, n_lanes: int,
                 padded: np.ndarray, b_cap: int, dim_min: int, job: str,
                 counts: Optional[np.ndarray] = None,
                 stream_chunk: bool = False,
                 agreed: Optional[Tuple[int, int]] = None,
                 force_vals: bool = False) -> Payload:
    """Panel layout when rows are near-uniform, COO otherwise; caps from
    the sticky schedule keyed by ``job``. ``padded`` is the OOB-padded
    slot vector (its length is u_cap); ``cblk.index`` already addresses
    its lanes. ``stream_chunk`` attaches the chunked-run layout to a
    panel. ``agreed`` = (widest row, nonzeros): the maxima over every
    process of a multi-host step, which the layout and the caps then
    follow instead of the block's own, so every process packs the same
    shapes; ``force_vals`` keeps a uniform binary panel's values (every
    process's backward partials then have one width)."""
    from ..ops.batch import (max_row_nnz, pack_batch, pack_panel,
                             panel_width_of)
    u_cap = len(padded)
    fmax, nnz = agreed if agreed is not None \
        else (max_row_nnz(cblk), cblk.nnz)
    width = panel_width_of(fmax, nnz, b_cap)
    if width is not None:
        width = shapes.cap(job + ".w", width, exact=True)
        i32, f32, binary = pack_panel(cblk, n_lanes, padded, b_cap, width,
                                      u_cap, counts=counts,
                                      force_vals=force_vals)
        chunks = (chunk_host(i32, f32, b_cap, width, u_cap, binary)
                  if stream_chunk else None)
        return Payload("panel", i32, f32, binary, b_cap, width, u_cap,
                       chunks=chunks)
    nnz_cap = shapes.cap(job + ".nnz", nnz, dim_min)
    row_cap = shapes.cap(job + ".row", fmax)
    i32, f32, binary = pack_batch(cblk, n_lanes, padded, b_cap, nnz_cap,
                                  u_cap, counts=counts)
    return Payload("coo", i32, f32, binary, b_cap, nnz_cap, u_cap, row_cap)


def chunk_host(i32: np.ndarray, f32: np.ndarray, b_cap: int, width: int,
               u_cap: int, binary: bool):
    """Host-built chunked-run layout of a packed panel (the twin of the
    replay cache's staging-time device chunker): streamed steps then take
    the chunked backward instead of the unsorted lane sum. Ragged panels
    carry explicit values (zero on pad cells), so pad tokens add nothing
    through ``chunk_vals``; uniform binary panels have no pad cells."""
    from ..ops.batch import panel_chunk_tokens_np
    cells = b_cap * width
    fv = None if binary else f32[:cells]
    return panel_chunk_tokens_np(i32[:cells], fv, u_cap, b_cap, width)


def _count_distinct(tok: np.ndarray, hash_capacity: int) -> int:
    """Exact distinct-token count without the sort ``np.unique`` pays: an
    O(nnz + capacity) flag pass while the capacity-sized bool array is
    cheap, ``np.unique`` above that. Sizes the device-dedup u-cap."""
    if hash_capacity <= (1 << 24):
        seen = np.zeros(hash_capacity, dtype=bool)
        seen[tok] = True
        return int(seen.sum())
    return len(np.unique(tok))


def pack_mapped(shapes: ShapeSchedule, blk, cblk, slots: np.ndarray,
                counts: Optional[np.ndarray], capacity: int, dim_min: int,
                job: str) -> Payload:
    """Pack a block whose ids the dictionary store mapped: ``slots`` are
    sorted unique (``SlotStore.map_keys_dedup``) and ``cblk.index``
    addresses them; ``counts`` (epoch 0) fill the counts section. The
    batch cap is the sticky bucket of the block sizes, as in the JAX
    learner."""
    from ..store.slots import pad_slots_oob
    n_uniq = len(slots)
    u_cap = shapes.cap(job + ".u", n_uniq)
    b_cap = shapes.cap(job + ".b", blk.size, dim_min)
    padded = pad_slots_oob(slots.astype(np.int32), u_cap, capacity)
    return pack_payload(shapes, cblk, n_uniq, padded, b_cap, dim_min, job,
                        counts=counts)


def prepare_hashed(shapes: ShapeSchedule, hash_capacity: int, blk,
                   want_counts: bool, fill_counts: bool, dim_min: int,
                   job: str, b_cap: Optional[int] = None,
                   stream_chunk: bool = False,
                   device_dedup: bool = False, admit=None) -> Payload:
    """Pack one raw-id block for the hashed store. ``want_counts`` keeps
    the counts section for the whole run; ``fill_counts`` (epoch 0)
    fills it with each lane's occurrence count, later epochs ship
    zeros.

    ``admit`` (capacity/sketch.AdmissionFilter): count-min admission.
    Unadmitted occurrences become the sentinel ``hash_capacity``, which
    sorts last among the unique tokens; its lane is dropped, so the cells
    that referenced it address the first out-of-bounds pad lane (a zero
    gather, a dropped scatter) and the u-cap keeps one lane of margin for
    it. Admission takes the host dedup: the sentinel cannot ride raw
    device lanes.

    ``device_dedup`` ships the raw hashed tokens of a panel-shaped block
    (``pack_panel_raw``) and the step dedups on the device; the host pays
    the hash and :func:`_count_distinct` only. It never engages while
    counts are filled (they need the host inverse), and a COO-shaped
    block falls back to the host dedup. The u-cap has a +1 margin: pad
    cells bring in the trash lane on the device."""
    from ..base import reverse_bytes
    from ..store.slots import hash_slots, pad_slots_oob
    tok = hash_slots(reverse_bytes(blk.index), hash_capacity)
    if admit is not None:
        tok = admit.filter(tok)
    if admit is None and device_dedup and not fill_counts:
        from ..ops.batch import pack_panel_raw, panel_width
        b_cap_raw = b_cap or shapes.cap(job + ".b", blk.size, dim_min)
        cblk = dataclasses.replace(blk, index=tok.astype(np.uint32))
        width = panel_width(cblk, b_cap_raw)
        if width is not None:
            n_uniq = _count_distinct(tok, hash_capacity)
            u_cap = shapes.cap(job + ".u", n_uniq + 1)
            width = shapes.cap(job + ".w", width, exact=True)
            i32, f32, binary = pack_panel_raw(cblk, n_uniq, b_cap_raw,
                                              width)
            return Payload("panel_raw", i32, f32, binary, b_cap_raw,
                           width, u_cap)
    if fill_counts:
        slots, inverse, counts = np.unique(tok, return_inverse=True,
                                           return_counts=True)
        counts = counts.astype(np.float32)
    else:
        slots, inverse = np.unique(tok, return_inverse=True)
        counts = np.zeros(0, np.float32) if want_counts else None
    if admit is not None and len(slots) and slots[-1] == admit.sentinel:
        slots = slots[:-1]
        if fill_counts:
            counts = counts[:-1]
    cblk = dataclasses.replace(blk, index=inverse.astype(np.uint32))
    n_uniq = len(slots)
    u_cap = shapes.cap(job + ".u", n_uniq + (1 if admit is not None else 0))
    b_cap = b_cap or shapes.cap(job + ".b", blk.size, dim_min)
    padded = pad_slots_oob(slots.astype(np.int32), u_cap, hash_capacity)
    return pack_payload(shapes, cblk, n_uniq, padded, b_cap, dim_min, job,
                        counts=counts, stream_chunk=stream_chunk)


def prepare_from_uniq(shapes: ShapeSchedule, hash_capacity: int, cblk,
                      uniq: np.ndarray, counts: Optional[np.ndarray],
                      want_counts: bool, fill_counts: bool, dim_min: int,
                      job: str, b_cap: Optional[int] = None,
                      stream_chunk: bool = False) -> Payload:
    """:func:`prepare_hashed` for a block the rec cache already localized
    (data/cached.py): ``cblk.index`` addresses ``uniq``, the sorted
    reversed ids. The slot map and its dedup are O(uniq); colliding
    lanes merge through ``np.unique``'s inverse, and their ``counts``
    (per uniq lane) add up in slot space. The O(nnz) gather of the index
    through that map runs here, on the producer. The payload equals
    prepare_hashed's for the same rows."""
    from ..store.slots import hash_slots, pad_slots_oob
    slots, remap = np.unique(hash_slots(uniq, hash_capacity),
                             return_inverse=True)
    cblk = dataclasses.replace(
        cblk, index=remap[cblk.index].astype(np.uint32))
    n_lanes = len(slots)
    u_cap = shapes.cap(job + ".u", n_lanes)
    b_cap = b_cap or shapes.cap(job + ".b", cblk.size, dim_min)
    scounts = np.zeros(0, np.float32) if want_counts else None
    if fill_counts and counts is not None:
        scounts = np.bincount(remap, weights=counts,
                              minlength=n_lanes).astype(np.float32)
    padded = pad_slots_oob(slots.astype(np.int32), u_cap, hash_capacity)
    return pack_payload(shapes, cblk, n_lanes, padded, b_cap, dim_min, job,
                        counts=scounts, stream_chunk=stream_chunk)


# ------------------------------------------------------------------ spec
@dataclass
class StreamSpec:
    """Everything a spawned producer worker needs to rebuild the hashed
    streamed-training items of a part — plain picklable values only (no
    learner, no store, no device state)."""
    parts: Sequence[int]        # logical pool index -> actual part id
    n_jobs: int
    data_in: str
    data_format: str
    batch_size: int
    shuffle: int
    neg_sampling: float
    epoch: int
    hash_capacity: int
    want_counts: bool
    fill_counts: bool
    dim_min: int
    job: str
    b_cap: Optional[int]
    stream_chunk: bool = False
    device_dedup: bool = False
    need_label: bool = False
    # count-min admission (capacity/sketch.make_admission): the threshold
    # and the sketch seed's base, so workers build the filter the
    # producer threads build
    admit_min_count: int = 0
    admit_seed: int = 0
    # a pre-localized rec cache to read instead of data_in (cached.py)
    cached_uri: Optional[str] = None
    # the consumer's sticky caps, so workers start from its schedule
    caps: dict = field(default_factory=dict)
    # the consumer's trace id: workers' spans join its timeline
    trace_id: int = 0


def timed_reader(it, parse_c, part: int) -> Iterator:
    """Yield from ``it``, adding each blocking ``next`` to the parse stage
    (a counter of seconds and one trace span per batch): the read +
    parse half of the pipeline, as against the pack half timed around
    the prepare call. One definition for threads and worker processes."""
    from ..obs import trace
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        with trace.span("producer.parse", part=part):
            item = next(it, None)
        parse_c.inc(time.perf_counter() - t0)
        if item is None:
            return
        yield item


def spec_iter(spec: StreamSpec, part_i: int) -> Iterator:
    """The process pool's ``make_iter``: yields the ("ready", BlkInfo,
    Payload) items the learner's producer threads yield for the hashed
    store, deterministically (seeded per (epoch, part), which retries and
    re-issues rely on). Counts parse and pack seconds and the rows and
    batches produced in the worker's process-global registry, which the
    pool ships to the consumer (obs/proc.py)."""
    from ..obs import REGISTRY, trace
    if spec.trace_id:
        trace.set_trace_id(spec.trace_id)
    stage = REGISTRY.counter(
        "stage_seconds_total",
        "seconds spent per streamed-pipeline stage, summed over threads")
    parse_c, pack_c = stage.labels(stage="parse"), stage.labels(stage="pack")
    rows_c = REGISTRY.counter("producer_rows_total",
                              "rows produced by the streamed pipeline")
    batches_c = REGISTRY.counter("producer_batches_total",
                                 "batches produced by the streamed pipeline")
    shapes = ShapeSchedule()
    shapes.absorb(spec.caps)
    part = spec.parts[part_i]
    seed = spec.epoch * max(spec.n_jobs, 1) + part

    def info(blk) -> BlkInfo:
        return BlkInfo(size=blk.size,
                       label=blk.label if spec.need_label else None)

    def packed(fn, *args, **kw) -> Payload:
        t0 = time.perf_counter()
        with trace.span("producer.pack", part=part):
            out = fn(*args, **kw)
        pack_c.inc(time.perf_counter() - t0)
        return out

    if spec.cached_uri is not None:
        from .cached import CachedBatchReader
        rdr = CachedBatchReader(
            spec.cached_uri, part, spec.n_jobs, spec.batch_size,
            shuffle=spec.shuffle > 0, neg_sampling=spec.neg_sampling,
            seed=seed, need_counts=spec.fill_counts)
        for sub, uniq, cnts in timed_reader(rdr, parse_c, part):
            rows_c.inc(sub.size)
            batches_c.inc()
            yield ("ready", info(sub), packed(
                prepare_from_uniq, shapes, spec.hash_capacity, sub, uniq,
                cnts, spec.want_counts, spec.fill_counts, spec.dim_min,
                spec.job, spec.b_cap, stream_chunk=spec.stream_chunk))
        return
    from ..capacity.sketch import make_admission
    from .batch_reader import BatchReader
    admit = make_admission(spec.hash_capacity, spec.admit_min_count,
                           spec.admit_seed, spec.epoch, part)
    reader = BatchReader(spec.data_in, spec.data_format, part, spec.n_jobs,
                         spec.batch_size, spec.batch_size * spec.shuffle,
                         spec.neg_sampling, seed=seed)
    for blk in timed_reader(reader, parse_c, part):
        rows_c.inc(blk.size)
        batches_c.inc()
        yield ("ready", info(blk), packed(
            prepare_hashed, shapes, spec.hash_capacity, blk,
            spec.want_counts, spec.fill_counts, spec.dim_min, spec.job,
            spec.b_cap, stream_chunk=spec.stream_chunk,
            device_dedup=spec.device_dedup, admit=admit))
