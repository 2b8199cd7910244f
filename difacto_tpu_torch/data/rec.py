"""Binary row-block cache, the ``.rec`` format (counterpart of
difacto_tpu/data/rec.py; the reference's recordio cache of CSR blocks
that ``task=convert`` writes, src/reader/converter.h:41-124).

A cache is a directory (or an explicit file list) of members, one CSR
block each: offset/label/index[/value][/weight]. Two member encodings
coexist, dispatched on the extension:

- ``.rec2`` (the default for new writes): the raw page-aligned framing
  of rec2.py, read as zero-copy ``mmap`` views, typed
  :class:`~.rec2.RecCorrupt` on torn or bit-flipped files;
- ``.npz`` (legacy v1): numpy archives, optionally zlib-compressed.

Parts (part_idx, num_parts) shard by whole members, weighted by on-disk
size: a member belongs to the part holding its first byte.

**Pre-localized members** also carry ``uniq``: the member's sorted
distinct byte-reversed feature ids, with ``index`` already remapped to
uint32 positions into it (the reference's CRB compacted CSR,
crb_parser.h:16-47). Epochs then skip the parse and the sort/unique
(data/cached.py).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils import stream
from .rec2 import SUFFIX as REC2_SUFFIX
from .rec2 import read_rec2, write_rec2
from .rowblock import RowBlock

# member extensions the rec readers accept, in either encoding
MEMBER_SUFFIXES = (REC2_SUFFIX, ".npz")


def write_rec_block(path: str, blk: RowBlock, compress: bool = True,
                    uniq: Optional[np.ndarray] = None) -> None:
    """``uniq`` marks a pre-localized member: ``blk.index`` holds
    positions into uniq (sorted reversed ids). ``.rec2`` paths get the
    raw framing (``compress`` ignored), ``.npz`` the archive."""
    arrays = dict(offset=blk.offset, label=blk.label, index=blk.index)
    if uniq is not None:
        arrays["uniq"] = uniq
        arrays["index"] = blk.index.astype(np.uint32)
    if blk.value is not None:
        arrays["value"] = blk.value
    if blk.weight is not None:
        arrays["weight"] = blk.weight
    if path.endswith(REC2_SUFFIX):
        write_rec2(path, arrays)
        return
    stream.save_npz(path, compress=compress, **arrays)


def read_rec_block_ex(path: str) -> Tuple[RowBlock, Optional[np.ndarray]]:
    """(block, uniq or None); uniq means the index is localized. A rec2
    member's arrays are read-only views of its mapping."""
    if path.endswith(REC2_SUFFIX):
        z = read_rec2(path)
        return RowBlock(offset=z["offset"], label=z["label"],
                        index=z["index"], value=z.get("value"),
                        weight=z.get("weight")), z.get("uniq")
    with stream.load_npz(path) as z:
        blk = RowBlock(
            offset=z["offset"], label=z["label"], index=z["index"],
            value=z["value"] if "value" in z.files else None,
            weight=z["weight"] if "weight" in z.files else None)
        return blk, (z["uniq"] if "uniq" in z.files else None)


def read_rec_block(path: str) -> RowBlock:
    """A member in the ORIGINAL id space: a localized member's index is
    expanded through uniq and un-reversed, so format-agnostic callers
    (eval, pred, the converter) see ordinary uint64 CSR blocks."""
    from ..base import reverse_bytes
    blk, uniq = read_rec_block_ex(path)
    if uniq is not None:
        blk.index = reverse_bytes(uniq)[blk.index]
    return blk


def rec_members(files: List[str], sizes=None) -> List[tuple]:
    """[(member, size)] of the known member encodings only: stray files
    (a writer's ``.tmp``, a README) in a cache directory never reach the
    block readers. ``sizes`` parallel to ``files`` saves a stat each."""
    out: List[tuple] = []
    for i, f in enumerate(files):
        if stream.isdir(f):
            out.extend((m, sz) for m, sz in stream.listdir_files(f)
                       if m.endswith(MEMBER_SUFFIXES))
        elif f.endswith(MEMBER_SUFFIXES):
            sz = sizes[i] if sizes is not None and sizes[i] >= 0 \
                else stream.getsize(f)
            out.append((f, sz))
    return out


def part_members(pairs: List[tuple], part_idx: int,
                 num_parts: int) -> List[str]:
    """The members of part ``part_idx``: each belongs to the part whose
    share of the cumulative on-disk size holds its first byte."""
    total = sum(sz for _, sz in pairs)
    begin = total * part_idx // num_parts
    end = total * (part_idx + 1) // num_parts
    out, base = [], 0
    for m, sz in pairs:
        if begin <= base < end:
            out.append(m)
        base += sz
    return out


def iter_rec_blocks(files: List[str], part_idx: int, num_parts: int,
                    sizes=None) -> Iterator[RowBlock]:
    """This part's members, in the original id space."""
    for m in part_members(rec_members(files, sizes), part_idx, num_parts):
        yield read_rec_block(m)


class RecWriter:
    """Write a stream of RowBlocks into a .rec directory of members
    (rec2 framing by default; ``member_suffix='.npz'`` keeps v1)."""

    def __init__(self, out_dir: str, compress: bool = True,
                 member_suffix: str = REC2_SUFFIX):
        self.out_dir = out_dir
        self.compress = compress
        self.member_suffix = member_suffix
        self._n = 0
        stream.makedirs(out_dir)

    def write(self, blk: RowBlock) -> None:
        path = stream.join(self.out_dir,
                           f"part-{self._n:05d}{self.member_suffix}")
        write_rec_block(path, blk, self.compress)
        self._n += 1

    @property
    def num_blocks(self) -> int:
        return self._n
