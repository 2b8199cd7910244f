"""rec2: raw page-aligned CSR block framing, the zero-copy rec member
(counterpart of difacto_tpu/data/rec2.py; members are byte-identical
between the two packages, and each reads the other's).

Layout (all little-endian)::

    [0]   magic  b"DFREC2\\0\\0"                      8 bytes
    [8]   u32 version (=1) | u32 n_sections
    [16]  u32 header_crc32 (over the section table) | u32 pad
    [24]  n_sections x section entry (32 bytes each):
              name   8 bytes (ascii, NUL padded)
              dtype  8 bytes (numpy dtype str, e.g. b"<i8")
              u64    byte offset (page-aligned, from file start)
              u64    nbytes
    [..]  u32 crc32 per section (n_sections x 4, the data checksums)
    [..]  sections, each aligned to PAGE (4096)

A reader ``mmap``s a local file (a remote URI is read whole, once) and
wraps each section with ``np.frombuffer``: no copy until the bytes are
consumed, and the mapping lives as long as an array that views it.
Whatever is staged to the device or put in a ring slot is copied out by
the packer first.

Integrity: the header CRC covers the section table and every section
carries its own CRC32. ``read_rec2`` validates the structure and the
section CRCs on every open, raising a typed
:class:`RecCorrupt` on truncation, bit flips or a bad magic — never a
crash or a silent short read. Writes go through tmp + atomic rename (a
remote member: an upload to ``<uri>.tmp``, then a move), so a torn
write is never seen at the final name.

Every read traverses the ``rec.read`` fault-injection point
(utils/faultinject.py): ``err`` raises (a failed disk read),
``truncate`` reads a half-length view, which the CRCs then reject.
"""

from __future__ import annotations

import io
import mmap
import os
import struct
import zlib
from typing import Dict

import numpy as np

from ..utils import faultinject, stream

MAGIC = b"DFREC2\0\0"
VERSION = 1
PAGE = 4096
SUFFIX = ".rec2"

_HEAD = struct.Struct("<8sIIII")       # magic, version, n_sections, crc, pad
_SECT = struct.Struct("<8s8sQQ")       # name, dtype, offset, nbytes

# the only arrays a rec2 member may carry (rec.py's block schema)
SECTION_NAMES = ("offset", "label", "index", "value", "weight", "uniq")


class RecCorrupt(ValueError):
    """A rec2 member failed structural or checksum validation (torn
    write, truncation, bit flip)."""


def _align(n: int) -> int:
    return (n + PAGE - 1) // PAGE * PAGE


def write_rec2(uri: str, arrays: Dict[str, np.ndarray]) -> None:
    """Atomically write ``arrays`` as one rec2 member (tmp + rename)."""
    names = list(arrays)
    for n in names:
        if n not in SECTION_NAMES:
            raise ValueError(f"unknown rec2 section {n!r} "
                             f"(one of {SECTION_NAMES})")
    header_len = _HEAD.size + len(names) * _SECT.size + len(names) * 4
    off = _align(header_len)
    entries, crcs, mats = [], [], []
    for n in names:
        a = np.ascontiguousarray(arrays[n])
        mats.append(a)
        entries.append((n.encode().ljust(8, b"\0"),
                        a.dtype.str.encode().ljust(8, b"\0"),
                        off, a.nbytes))
        crcs.append(zlib.crc32(a.data))
        off = _align(off + a.nbytes)
    table = b"".join(_SECT.pack(*e) for e in entries) \
        + b"".join(struct.pack("<I", c) for c in crcs)
    head = _HEAD.pack(MAGIC, VERSION, len(names), zlib.crc32(table), 0)

    def emit(f) -> None:
        f.write(head)
        f.write(table)
        pos = len(head) + len(table)
        for (_, _, o, _), a in zip(entries, mats):
            f.write(b"\0" * (o - pos))
            f.write(a.data)
            pos = o + a.nbytes

    if stream.is_remote(uri):
        # one upload of the whole member to <uri>.tmp, then a move
        buf = io.BytesIO()
        emit(buf)
        tmp = uri + ".tmp"
        with stream.open_stream(tmp, "wb") as f:
            f.write(buf.getvalue())
        stream.move_remote(tmp, uri)
        return
    path = stream._local(uri)
    stream._ensure_parent(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        emit(f)
    os.replace(tmp, path)


def _corrupt(uri: str, why: str) -> RecCorrupt:
    return RecCorrupt(f"corrupt rec2 member {uri!r}: {why}")


def read_rec2(uri: str) -> Dict[str, np.ndarray]:
    """Read one rec2 member -> {name: array}: zero-copy views of a
    read-only mapping, after the structure and every section's CRC
    check out."""
    kind = faultinject.fire("rec.read")
    if stream.is_remote(uri):
        # a remote member is read whole, once; the arrays view the bytes
        with stream.open_stream(uri, "rb") as f:
            buf = memoryview(f.read())
    else:
        try:
            with open(stream._local(uri), "rb") as f:
                try:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                except ValueError as e:  # zero-length file
                    raise _corrupt(uri, f"unmappable ({e})") from e
        except OSError as e:
            if isinstance(e, FileNotFoundError):
                raise
            raise _corrupt(uri, f"unreadable ({e})") from e
        buf = memoryview(mm)
    if kind == "truncate":
        buf = buf[:max(len(buf) // 2, 1)]
    elif kind is not None:
        faultinject.act_default(kind)
    try:
        return _parse(uri, buf)
    except struct.error as e:
        raise _corrupt(uri, f"short header ({e})") from e


def _parse(uri: str, buf: memoryview) -> Dict[str, np.ndarray]:
    if len(buf) < _HEAD.size:
        raise _corrupt(uri, f"file too short ({len(buf)} bytes)")
    magic, version, n_sections, head_crc, _ = _HEAD.unpack_from(buf, 0)
    if magic != MAGIC:
        raise _corrupt(uri, f"bad magic {magic!r}")
    if version != VERSION:
        raise _corrupt(uri, f"unsupported version {version}")
    if not 0 < n_sections <= len(SECTION_NAMES):
        raise _corrupt(uri, f"implausible section count {n_sections}")
    table_len = n_sections * _SECT.size + n_sections * 4
    if len(buf) < _HEAD.size + table_len:
        raise _corrupt(uri, "truncated section table")
    table = bytes(buf[_HEAD.size:_HEAD.size + table_len])
    if zlib.crc32(table) != head_crc:
        raise _corrupt(uri, "section table checksum mismatch")
    crc_base = _HEAD.size + n_sections * _SECT.size
    out: Dict[str, np.ndarray] = {}
    for i in range(n_sections):
        name_b, dtype_b, off, nbytes = _SECT.unpack_from(
            buf, _HEAD.size + i * _SECT.size)
        name = name_b.rstrip(b"\0").decode("ascii", "replace")
        if name not in SECTION_NAMES:
            raise _corrupt(uri, f"unknown section {name!r}")
        try:
            dt = np.dtype(dtype_b.rstrip(b"\0").decode("ascii", "replace"))
        except TypeError as e:
            raise _corrupt(uri, f"bad dtype for {name!r} ({e})") from e
        if off % PAGE or off + nbytes > len(buf):
            raise _corrupt(
                uri, f"section {name!r} [{off}, {off + nbytes}) outside "
                f"file of {len(buf)} bytes")
        if dt.itemsize == 0 or nbytes % dt.itemsize:
            raise _corrupt(uri, f"section {name!r} nbytes {nbytes} not a "
                           f"multiple of dtype {dt.str}")
        view = buf[off:off + nbytes]
        want, = struct.unpack_from("<I", buf, crc_base + 4 * i)
        if zlib.crc32(view) != want:
            raise _corrupt(uri, f"section {name!r} checksum mismatch")
        out[name] = np.frombuffer(view, dtype=dt)
    return out

