"""Write-ahead delta log: CRC'd touched-row segments between checkpoints
(counterpart of difacto_tpu/durability/wal.py; segments are byte-identical
between the two packages, and each reads the other's).

Between full checkpoints the trainer appends the touched fused rows of the
last ``wal_flush_batches`` steps as one CRC'd segment, so recovery = base
generation + ordered deltas, and a crash loses at most one flush window
instead of one ``ckpt_interval``.

Segment format (little-endian)::

    [0]   magic  b"DFWAL1\\0\\0"                     8 bytes
    [8]   u32 version (=1) | u32 n_sections
    [16]  u32 table_crc32 (over the section table) | u32 pad
    [24]  n_sections x section entry (48 bytes each):
              name   16 bytes (ascii, NUL padded)
              dtype  16 bytes (dtype NAME, NUL padded)
              u64    byte offset (64-aligned, from file start)
              u64    nbytes
    [..]  u32 crc32 per section
    [..]  sections, each aligned to 64

Section ``meta`` is a JSON document (uint8) with the chain position
(generation, seq, rank), the covered step window (epoch, step_lo, step_hi,
boundary) and the table's geometry stamp, which replay checks before it
applies anything. ``slots`` holds the sorted unique int32 rows the window
touched; the other sections are the rows exactly as the table stores them:
``VVg`` container rows for the fused layout, or the five flat columns
when ``V_dim == 0``.

A section is a numpy array, or a CPU torch tensor for the dtypes numpy
lacks: a bf16 table's rows are written under the name ``bfloat16`` as
their 16-bit patterns, and a section named ``bfloat16`` or
``float8_e4m3fn`` reads back as a torch tensor of that dtype (through an
int16 or int8 view), the others as numpy arrays.

A torn write is never seen at the final name (tmp + atomic rename), and
:func:`read_segment` raises the typed :class:`WalCorrupt` on truncation,
bit flips or a bad magic; :func:`replay` stops at the first corrupt or
missing segment and never applies bytes past it. Appends traverse the
``wal.append`` fault point, reads ``wal.replay`` (utils/faultinject.py).
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("difacto_tpu_torch")

MAGIC = b"DFWAL1\0\0"
VERSION = 1
SUFFIX = ".dfwal"
ALIGN = 64

_HEAD = struct.Struct("<8sIIII")     # magic, version, n_sections, crc, pad
_SECT = struct.Struct("<16s16sQQ")   # name, dtype name, offset, nbytes
_SEG_RE = re.compile(r"r(\d+)-g(\d+)-s(\d+)\.dfwal$")

# the sections a segment may carry: the chain meta, the touched slots, and
# the rows of either layout (fused VVg container rows, or the five flat
# columns of the V_dim=0 layout)
SECTION_NAMES = ("meta", "slots", "VVg", "w", "z", "sqrt_g", "cnt",
                 "v_live")
# dtype names numpy cannot parse (torch's names too) -> their bits' dtype
_TORCH_ONLY = {"bfloat16": np.int16, "float8_e4m3fn": np.int8}


class WalCorrupt(ValueError):
    """A segment failed structural or checksum validation (torn write,
    truncation, bit flip) or disagrees with the chain it claims to
    extend."""


def wal_dir(model_out: str) -> str:
    """The delta-log directory of a model family: ``<model_out>.wal``."""
    return model_out + ".wal"


def segment_name(rank: int, generation: int, seq: int) -> str:
    return f"r{rank:03d}-g{generation:06d}-s{seq:06d}{SUFFIX}"


def _section_bytes(a) -> Tuple[str, bytes]:
    """(dtype name, raw bytes) of a numpy array or a torch tensor."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
        return a.dtype.name, a.tobytes()
    import torch
    t = a.detach().cpu().contiguous()
    name = str(t.dtype).replace("torch.", "")
    if name in _TORCH_ONLY:
        t = t.view(torch.int16 if t.element_size() == 2 else torch.int8)
    return name, t.numpy().tobytes()


def _from_bytes(view, name: str):
    """Section bytes -> a numpy array, or a torch tensor for a dtype
    numpy lacks."""
    if name in _TORCH_ONLY:
        import torch
        return torch.from_numpy(np.frombuffer(view, _TORCH_ONLY[name]).copy()
                                ).view(getattr(torch, name))
    return np.frombuffer(view, dtype=np.dtype(name))


def _itemsize(name: str, path: str) -> int:
    if name in _TORCH_ONLY:
        return np.dtype(_TORCH_ONLY[name]).itemsize
    try:
        return np.dtype(name).itemsize
    except TypeError as e:
        raise _corrupt(path, f"unknown section dtype {name!r}") from e


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _corrupt(path: str, why: str) -> WalCorrupt:
    return WalCorrupt(f"corrupt WAL segment {path!r}: {why}")


def _encode(meta: dict, arrays: Dict[str, object]) -> bytes:
    sects = {"meta": np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)}
    sects.update(arrays)
    names = list(sects)
    for n in names:
        if n not in SECTION_NAMES:
            raise ValueError(f"unknown WAL section {n!r} "
                             f"(one of {SECTION_NAMES})")
    header_len = _HEAD.size + len(names) * _SECT.size + len(names) * 4
    off = _align(header_len)
    entries, crcs, mats = [], [], []
    for n in names:
        dname, raw = _section_bytes(sects[n])
        mats.append(raw)
        entries.append((n.encode().ljust(16, b"\0"),
                        dname.encode().ljust(16, b"\0"), off, len(raw)))
        crcs.append(zlib.crc32(raw))
        off = _align(off + len(raw))
    table = b"".join(_SECT.pack(*e) for e in entries) \
        + b"".join(struct.pack("<I", c) for c in crcs)
    out = bytearray(_HEAD.pack(MAGIC, VERSION, len(names),
                               zlib.crc32(table), 0))
    out += table
    for (_, _, o, _), raw in zip(entries, mats):
        out += b"\0" * (o - len(out))
        out += raw
    return bytes(out)


def write_segment(path: str, meta: dict, arrays: Dict[str, object]) -> int:
    """Atomically write one segment (tmp + rename); returns its size.
    ``wal.append``: ``err`` raises (the caller keeps its window and
    retries at the next flush), ``truncate`` lands a torn segment at the
    final name (which replay's CRCs must reject), ``kill`` dies before any
    byte lands."""
    from ..utils import faultinject
    kind = faultinject.fire("wal.append")
    if kind is not None and kind != "truncate":
        faultinject.act_default(kind)
    buf = _encode(meta, arrays)
    if kind == "truncate":
        buf = buf[:max(len(buf) // 2, 1)]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)
    return len(buf)


def read_segment(path: str, verify: bool = True) -> Tuple[dict, dict]:
    """One segment -> (meta, {name: array}); the typed
    :class:`WalCorrupt` on any structural or checksum failure.
    ``wal.replay``: ``err`` is a failed read, ``truncate`` a half-length
    view that the CRCs reject."""
    from ..utils import faultinject
    kind = faultinject.fire("wal.replay")
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError as e:
        if isinstance(e, FileNotFoundError):
            raise
        raise _corrupt(path, f"unreadable ({e})") from e
    if kind == "truncate":
        buf = buf[:max(len(buf) // 2, 1)]
    elif kind is not None:
        faultinject.act_default(kind)
    if len(buf) < _HEAD.size:
        raise _corrupt(path, f"file too short ({len(buf)} bytes)")
    magic, version, n_sections, head_crc, _ = _HEAD.unpack_from(buf, 0)
    if magic != MAGIC:
        raise _corrupt(path, f"bad magic {magic!r}")
    if version != VERSION:
        raise _corrupt(path, f"unsupported version {version}")
    if not 0 < n_sections <= len(SECTION_NAMES):
        raise _corrupt(path, f"implausible section count {n_sections}")
    table_len = n_sections * _SECT.size + n_sections * 4
    if len(buf) < _HEAD.size + table_len:
        raise _corrupt(path, "truncated section table")
    table = buf[_HEAD.size:_HEAD.size + table_len]
    if zlib.crc32(table) != head_crc:
        raise _corrupt(path, "section table checksum mismatch")
    crc_base = _HEAD.size + n_sections * _SECT.size
    arrays: Dict[str, object] = {}
    for i in range(n_sections):
        name_b, dtype_b, off, nbytes = _SECT.unpack_from(
            buf, _HEAD.size + i * _SECT.size)
        name = name_b.rstrip(b"\0").decode("ascii", "replace")
        if name not in SECTION_NAMES:
            raise _corrupt(path, f"unknown section {name!r}")
        dname = dtype_b.rstrip(b"\0").decode("ascii", "replace")
        size = _itemsize(dname, path)
        if off % ALIGN or off + nbytes > len(buf):
            raise _corrupt(
                path, f"section {name!r} [{off}, {off + nbytes}) outside "
                f"file of {len(buf)} bytes")
        if size == 0 or nbytes % size:
            raise _corrupt(path, f"section {name!r} nbytes {nbytes} not "
                           f"a multiple of dtype {dname}")
        view = buf[off:off + nbytes]
        if verify:
            want, = struct.unpack_from("<I", buf, crc_base + 4 * i)
            if zlib.crc32(view) != want:
                raise _corrupt(path, f"section {name!r} checksum "
                               "mismatch")
        arrays[name] = _from_bytes(view, dname)
    if "meta" not in arrays or "slots" not in arrays:
        raise _corrupt(path, "meta/slots section missing")
    try:
        meta = json.loads(bytes(arrays.pop("meta")).decode())
    except ValueError as e:
        raise _corrupt(path, f"unreadable meta ({e})") from e
    return meta, arrays


def _listdir(dir_: str) -> List[str]:
    try:
        return os.listdir(dir_)
    except FileNotFoundError:
        return []


def chain_segments(dir_: str, rank: int,
                   generation: int) -> List[Tuple[int, str]]:
    """[(seq, path)] of the chain rooted at ``generation``, in seq order.
    A gap is not resolved here: replay stops at it."""
    out = []
    for name in _listdir(dir_):
        m = _SEG_RE.match(name)
        if m and int(m.group(1)) == rank and int(m.group(2)) == generation:
            out.append((int(m.group(3)), os.path.join(dir_, name)))
    out.sort()
    return out


def chain_generations(dir_: str, rank: int) -> List[int]:
    """Generations with at least one segment of ``rank``, newest first."""
    gens = {int(m.group(2)) for m in map(_SEG_RE.match, _listdir(dir_))
            if m and int(m.group(1)) == rank}
    return sorted(gens, reverse=True)


@dataclass
class ReplayResult:
    """What :func:`replay` applied: the verified contiguous prefix of the
    chain. ``epoch``/``step`` are the batch boundary the state now sits
    at; ``boundary`` marks an epoch-complete head."""
    generation: int
    epoch: int = -1
    step: int = 0
    boundary: bool = True
    batches: int = 0
    segments: int = 0
    next_seq: int = 0
    stopped: str = ""  # "" = clean head; else torn|gap|geometry|chain


def _geom_ok(meta: dict, geom: dict) -> bool:
    return all(meta.get(k) == v for k, v in geom.items())


def _dropped(reason: str, n: int) -> None:
    from ..obs import counter
    counter("wal_replay_dropped_total",
            "WAL segments dropped at replay, by reason"
            ).labels(reason=reason).inc(n)


def replay(store, dir_: str, rank: int, generation: int,
           base_epoch: int = -1) -> ReplayResult:
    """Apply the chain rooted at ``generation`` onto ``store`` (holding
    the base state already), in seq order, stopping at the first gap,
    corrupt segment, geometry or chain mismatch: what came before the stop
    is a consistent batch boundary, and nothing after it is applied.
    Counted into ``wal_replay_batches`` / ``wal_replay_dropped_total``."""
    from ..obs import counter
    geom = store.wal_geometry()
    res = ReplayResult(generation=generation, epoch=base_epoch)
    segs = chain_segments(dir_, rank, generation)
    want_seq = 0
    for seq, path in segs:
        left = len(segs) - res.segments
        if seq != want_seq:
            log.warning("wal replay: seq gap at %s (want seq %d); "
                        "stopping at the verified prefix", path, want_seq)
            _dropped("gap", left)
            res.stopped = "gap"
            return res
        try:
            meta, arrays = read_segment(path)
        except (WalCorrupt, OSError) as e:
            log.warning("wal replay: %s; stopping at the verified "
                        "prefix", e)
            _dropped("torn", left)
            res.stopped = "torn"
            return res
        if not _geom_ok(meta, geom) or meta.get("generation") != generation \
                or meta.get("rank") != rank or meta.get("seq") != seq:
            log.warning("wal replay: %s geometry/chain stamp disagrees "
                        "with the live table; stopping", path)
            _dropped("geometry", left)
            res.stopped = "geometry"
            return res
        epoch, lo, hi = (int(meta["epoch"]), int(meta["step_lo"]),
                         int(meta["step_hi"]))
        contiguous = (
            (epoch == res.epoch and lo == res.step)
            or (res.boundary and epoch == res.epoch + 1 and lo == 0))
        if not contiguous:
            log.warning("wal replay: %s covers (%d, %d..%d) but the head "
                        "is (%d, %d); stopping", path, epoch, lo, hi,
                        res.epoch, res.step)
            _dropped("chain", left)
            res.stopped = "chain"
            return res
        slots = np.asarray(arrays.pop("slots")).astype(np.int32)
        store.apply_wal_rows(slots, arrays)
        res.epoch, res.step = epoch, hi
        res.boundary = bool(meta.get("boundary"))
        res.batches += hi - lo
        res.segments += 1
        res.next_seq = seq + 1
        want_seq = seq + 1
    if res.batches:
        counter("wal_replay_batches",
                "training batches recovered from WAL deltas instead of "
                "re-executed").inc(res.batches)
    return res


@dataclass
class WalWriter:
    """Per-rank append head of the delta log: naming, chain position and
    retention; the learner owns the flush cadence. Every call runs on the
    dispatch thread (appends) or at startup (rebase, adopt)."""
    dir: str
    rank: int
    geom: dict
    generation: int = 0
    seq: int = 0
    # the epoch of the checkpoint the live chain is rooted at (None until
    # the first rebase): ckpt_keep pruning never retires it
    base_epoch: Optional[int] = None
    keep_generations: int = 2
    _bytes_c: object = field(default=None, repr=False)

    def append(self, slots: np.ndarray, arrays: Dict[str, object],
               epoch: int, step_lo: int, step_hi: int,
               boundary: bool = False) -> Optional[str]:
        """Write one segment covering steps [step_lo, step_hi) of
        ``epoch``; returns its path (None for an empty non-boundary
        window). A failed write raises FaultInjected or OSError and the
        chain position does not move."""
        if len(slots) == 0 and not boundary:
            return None
        meta = dict(self.geom)
        meta.update(generation=self.generation, seq=self.seq,
                    rank=self.rank, epoch=int(epoch),
                    step_lo=int(step_lo), step_hi=int(step_hi),
                    boundary=bool(boundary))
        path = os.path.join(
            self.dir, segment_name(self.rank, self.generation, self.seq))
        sects = {"slots": np.asarray(slots, dtype=np.int32)}
        sects.update(arrays)
        nbytes = write_segment(path, meta, sects)
        self.seq += 1
        if self._bytes_c is None:
            from ..obs import counter
            self._bytes_c = counter(
                "wal_bytes_total",
                "bytes appended to the write-ahead delta log")
        self._bytes_c.inc(nbytes)
        return path

    def rebase(self, generation: int, epoch: Optional[int]) -> None:
        """Root the chain at a freshly committed checkpoint generation and
        retire the chains more than ``keep_generations`` bases back (one
        older base is kept, so a corrupt newest generation still walks
        back to a base + chain pair)."""
        self.generation = generation
        self.seq = 0
        self.base_epoch = epoch
        keep = generation - (self.keep_generations - 1)
        for name in _listdir(self.dir):
            m = _SEG_RE.match(name)
            if m and int(m.group(1)) == self.rank \
                    and int(m.group(2)) < keep:
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass

    def adopt(self, generation: int, next_seq: int,
              base_epoch: Optional[int]) -> None:
        """Continue a chain after replay: appends extend the verified
        prefix, and the segments at or past ``next_seq`` (the dead tail
        past a stop) are removed so the chain stays gap-free."""
        self.generation = generation
        self.seq = next_seq
        self.base_epoch = base_epoch
        for seq, path in chain_segments(self.dir, self.rank, generation):
            if seq >= next_seq:
                try:
                    os.remove(path)
                except OSError:
                    pass
