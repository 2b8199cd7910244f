"""Sharded text reader (counterpart of difacto_tpu/data/reader.py).

A uri is a file, a directory (all regular files inside, sorted) or a
glob, on local disk. Part ``part_idx`` of ``num_parts`` is a byte range
of the files' concatenation, the JAX package's (and dmlc InputSplit's)
contract: the total span is cut evenly, a part starts at the first line
start at or after its begin offset and ends with the line that straddles
its end, so every line belongs to exactly one part. Records come as
RowBlocks of whole-line chunks of ``chunk_bytes``, the JAX reader's
chunking, so both packages cut the same batches. ``data_format="rec"``
reads a binary cache (rec.py) by whole members, in the original id
space.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

from ..utils import stream
from .parsers import get_parser
from .rowblock import RowBlock


def expand_uri(uri: str, with_sizes: bool = False):
    """Sorted files behind a uri; ';' separates multiple uris.
    ``with_sizes`` returns (files, sizes)."""
    files: List[str] = []
    sizes: List[int] = []
    for part in uri.split(";"):
        part = part.strip()
        if not part:
            continue
        if stream.isdir(part):
            for f, sz in stream.listdir_files(part):
                files.append(f)
                sizes.append(sz)
        elif stream.isfile(part):
            files.append(part)
            sizes.append(stream.getsize(part) if with_sizes else -1)
        else:
            hits = [h for h in stream.glob(part) if stream.isfile(h)]
            if not hits:
                raise FileNotFoundError(f"no files match data uri: {part!r}")
            files.extend(hits)
            sizes.extend(stream.getsize(h) if with_sizes else -1
                         for h in hits)
    if with_sizes:
        return files, sizes
    return files


def _byte_ranges(files: List[str], sizes: List[int], part_idx: int,
                 num_parts: int) -> List[Tuple[str, int, int]]:
    """This part's global byte range [begin, end) cut across the files."""
    total = sum(sizes)
    begin = total * part_idx // num_parts
    end = total * (part_idx + 1) // num_parts
    out, base = [], 0
    for f, sz in zip(files, sizes):
        lo, hi = max(begin, base), min(end, base + sz)
        if lo < hi:
            out.append((f, lo - base, hi - base))
        base += sz
    return out


def _iter_text_chunks(path: str, begin: int, end: int,
                      chunk_bytes: int) -> Iterator[bytes]:
    """Whole-line chunks covering [begin, end) of ``path``: the line that
    straddles ``begin`` belongs to the previous part, the one that
    straddles ``end`` to this one."""
    with stream.open_stream(path, "rb") as f:
        pos = begin
        if begin > 0:
            f.seek(begin - 1)
            pos = begin - 1 + len(f.readline())
        while pos < end:
            data = f.read(max(min(chunk_bytes, end - pos), 1))
            if not data:
                break
            if not data.endswith(b"\n"):
                data += f.readline()
            yield data
            pos += len(data)


class Reader:
    def __init__(self, uri: str, data_format: str = "libsvm",
                 part_idx: int = 0, num_parts: int = 1,
                 chunk_bytes: int = 1 << 26):
        if not 0 <= part_idx < num_parts:
            raise ValueError(f"part_idx {part_idx} out of range of "
                             f"{num_parts}")
        self.data_format = data_format.lower()
        self.part_idx, self.num_parts = part_idx, num_parts
        self.chunk_bytes = chunk_bytes
        self.files, self._sizes = expand_uri(uri, with_sizes=True)
        if not self.files:
            raise FileNotFoundError(f"empty data uri: {uri!r}")

    def __iter__(self) -> Iterator[RowBlock]:
        if self.data_format == "rec":
            from .rec import iter_rec_blocks
            yield from iter_rec_blocks(self.files, self.part_idx,
                                       self.num_parts, sizes=self._sizes)
            return
        parse = get_parser(self.data_format)
        for path, b, e in _byte_ranges(self.files, self._sizes,
                                       self.part_idx, self.num_parts):
            for chunk in _iter_text_chunks(path, b, e, self.chunk_bytes):
                blk = parse(chunk)
                if blk.size:
                    yield blk
