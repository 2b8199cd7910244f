"""Data converter: any input format -> libsvm text or the binary rec cache
(counterpart of difacto_tpu/data/converter.py, with its parameters and
its output byte for byte; the reference's ``task=convert``,
src/reader/converter.h:41-124).

``data_in``/``data_format`` -> ``data_out``/``data_out_format``, read in
``chunk_size`` MB chunks, the output optionally split into ``part_size``
MB parts (-1: one output). The rec output (rec.py):

- ``rec_localize`` (default on) stores members pre-localized (uint32
  index into the sorted reversed-id ``uniq``), so training epochs skip
  the parse and the sort/unique (data/cached.py);
- ``rec_batch_size`` (or the training ``batch_size``) sets the rows per
  member, so cached batches never straddle members;
- text chunks are parsed, localized and written on ``convert_threads``
  threads, or split by byte range over ``convert_procs`` worker
  processes (the learner's ProcessProducerPool), each writing its own
  ``part-PPP-NNNNN`` members. The auto rule starts ``min(cores, 8)``
  workers on a host with 4 or more cores, so the members' row counts,
  and with them the batches a cached epoch cuts, depend on the host's
  core count; pin ``convert_procs`` where a layout must repeat.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ..config import KWArgs, Param
from ..utils import stream
from .localizer import compact
from .rec import write_rec_block
from .rec2 import SUFFIX as REC2_SUFFIX
from .reader import Reader, _byte_ranges, _iter_text_chunks, expand_uri
from .rowblock import RowBlock, RowBlockBuilder
from ..utils.locktrace import mutex

log = logging.getLogger("difacto_tpu_torch")

# rows per member when neither rec_batch_size nor batch_size is given
DEFAULT_MEMBER_ROWS = 8192


@dataclass
class ConverterParam(Param):
    """Every key of the JAX package's ConverterParam, with its default."""
    data_in: str = ""
    data_format: str = ""
    data_out: str = ""
    data_out_format: str = ""
    part_size: int = -1      # MB per output part; -1 = one output
    chunk_size: float = 512  # MB per read chunk
    rec_localize: bool = True
    # rows per rec member: > 0 explicit; 0 = batch_size if given, else
    # DEFAULT_MEMBER_ROWS; -1 = one member per read chunk
    rec_batch_size: int = 0
    batch_size: int = 0      # the training batch size (see rec_batch_size)
    convert_threads: int = 0  # 0 = auto
    # worker processes for the text -> rec convert: 0 = auto (min(cores,
    # 8) on >= 4 cores, else 1), 1 = the threaded path
    convert_procs: int = 0
    rec_encoding: str = "rec2"   # "rec2" (mmap'd) or "npz" (legacy)
    rec_compress: bool = False   # zlib members (npz encoding only)


def _member_blocks(blocks, rows: int):
    """Re-slice parsed blocks into ``rows``-row members, carrying the
    remainder across blocks; ``rows`` <= 0 keeps one member per block."""
    if rows <= 0:
        yield from blocks
        return
    builder = RowBlockBuilder()
    for blk in blocks:
        start = 0
        while start < blk.size:
            take = min(rows - builder.num_rows, blk.size - start)
            builder.push_rows(blk, np.arange(start, start + take))
            start += take
            if builder.num_rows >= rows:
                yield builder.build()
                builder.clear()
    if builder.num_rows:
        yield builder.build()


def _write_member(path: str, blk: RowBlock, localize: bool,
                  compress: bool) -> int:
    """Write one member (localized or raw); returns its size on disk."""
    if localize:
        cblk, uniq, _ = compact(blk)
        write_rec_block(path, cblk, uniq=uniq, compress=compress)
    else:
        write_rec_block(path, blk, compress=compress)
    return stream.getsize(path)


@dataclass
class _ConvertSpec:
    """What a convert worker process needs to convert ITS byte-range part
    of the input into member files: plain picklable values only."""
    data_in: str
    data_format: str
    out_dir: str
    member_suffix: str
    member_rows: int
    rec_localize: bool
    rec_compress: bool
    chunk_bytes: int
    n_parts: int


def convert_part_iter(spec: _ConvertSpec, part: int):
    """The process pool's ``make_iter`` of the parallel text -> rec
    convert: parse this part's byte range, cut it into members, localize
    and write each one from the worker, and yield per-member stats
    ``("member", rows, bytes, parse_s, write_s)``. Deterministic per part
    (fixed byte ranges, fixed member names), so a retried part rewrites
    the same members through atomic renames."""
    if spec.data_format.lower() == "rec":
        src = iter(Reader(spec.data_in, "rec", part, spec.n_parts,
                          chunk_bytes=spec.chunk_bytes))
    else:
        from .parsers import get_parser
        parse = get_parser(spec.data_format)
        files, sizes = expand_uri(spec.data_in, with_sizes=True)
        src = (parse(ch) for path, b, e in
               _byte_ranges(files, sizes, part, spec.n_parts)
               for ch in _iter_text_chunks(path, b, e, spec.chunk_bytes))
    parse_s = [0.0]

    def timed_blocks():
        while True:
            t0 = time.perf_counter()
            blk = next(src, None)
            parse_s[0] += time.perf_counter() - t0
            if blk is None:
                return
            if blk.size:
                yield blk

    for n, blk in enumerate(_member_blocks(timed_blocks(),
                                           spec.member_rows)):
        path = stream.join(spec.out_dir,
                           f"part-{part:03d}-{n:05d}{spec.member_suffix}")
        t0 = time.perf_counter()
        nbytes = _write_member(path, blk, spec.rec_localize,
                               spec.rec_compress)
        yield ("member", blk.size, nbytes, parse_s[0],
               time.perf_counter() - t0)
        parse_s[0] = 0.0


class Converter:
    def __init__(self) -> None:
        self.param: ConverterParam | None = None
        # filled by run(): rows, eps, convert_s, parse_s, write_s and, on
        # the process path, procs, members, out_bytes
        self.stats: dict = {}
        self.num_rows = 0
        self._stage_lock = mutex()

    def init(self, kwargs: KWArgs) -> KWArgs:
        self.param, remain = ConverterParam.init_allow_unknown(kwargs)
        for req in ("data_in", "data_format", "data_out", "data_out_format"):
            if not getattr(self.param, req):
                raise ValueError(f"converter requires {req}")
        if self.param.data_out_format not in ("libsvm", "rec"):
            raise ValueError(
                f"unknown output format: {self.param.data_out_format}")
        if self.param.rec_encoding not in ("rec2", "npz"):
            raise ValueError(
                f"unknown rec_encoding: {self.param.rec_encoding!r} "
                "(rec2|npz)")
        return remain

    def member_rows(self) -> int:
        """Rows per member: explicit > 0 wins; 0 = batch_size if given,
        else DEFAULT_MEMBER_ROWS; -1 = one member per read chunk."""
        p = self.param
        if p.rec_batch_size > 0:
            return p.rec_batch_size
        if p.rec_batch_size == 0:
            return p.batch_size or DEFAULT_MEMBER_ROWS
        return -1

    def member_suffix(self) -> str:
        return REC2_SUFFIX if self.param.rec_encoding == "rec2" else ".npz"

    def resolve_procs(self) -> int:
        """Worker processes for the rec convert: explicit wins; auto (0)
        starts min(cores, 8) on a host with >= 4 cores. part_size
        splitting and the libsvm output stay on one process, and so does
        a ``memory://`` output: that filesystem lives in one process's
        memory, and the members a worker wrote there would die with it
        (the JAX package loses them; ROADMAP.md, Queue 3)."""
        p = self.param
        if (p.part_size > 0 or p.data_out_format != "rec"
                or p.data_out.startswith("memory://")):
            return 1
        if p.convert_procs > 0:
            return p.convert_procs
        ncpu = os.cpu_count() or 1
        return min(ncpu, 8) if ncpu >= 4 else 1

    def _acc_stage(self, key: str, dt: float) -> None:
        with self._stage_lock:
            self.stats[key] = round(self.stats.get(key, 0.0) + dt, 4)

    def run(self) -> None:
        t0 = time.perf_counter()
        if self.param.data_out_format == "rec":
            procs = self.resolve_procs()
            if procs > 1:
                self._run_rec_parallel(procs)
            else:
                self._run_rec()
        else:
            self._run_libsvm()
        self.stats["convert_s"] = round(time.perf_counter() - t0, 3)
        self.stats["rows"] = self.num_rows
        if self.stats["convert_s"] > 0:
            self.stats["eps"] = round(
                self.num_rows / self.stats["convert_s"], 1)

    def _open_rec_part(self, ipart: int, split: bool) -> str:
        path = self.param.data_out + (f"-part_{ipart}" if split else "")
        stream.makedirs(path)
        log.info("writing data to %s in rec format", path)
        return path

    # ------------------------------------------------------------- rec
    def _run_rec_parallel(self, procs: int) -> None:
        """Text -> rec over ``procs`` worker processes, each converting
        one byte-range part into its own members; only each part's tail
        member runs short."""
        from .producer_pool import ProcessProducerPool
        p = self.param
        spec = _ConvertSpec(
            data_in=p.data_in, data_format=p.data_format,
            out_dir=self._open_rec_part(0, False),
            member_suffix=self.member_suffix(),
            member_rows=self.member_rows(),
            rec_localize=p.rec_localize, rec_compress=p.rec_compress,
            chunk_bytes=min(int(p.chunk_size * (1 << 20)), 32 << 20),
            n_parts=procs)
        log.info("reading data from %s in %s format (%d convert workers)",
                 p.data_in, p.data_format, procs)
        pool = ProcessProducerPool(
            procs, functools.partial(convert_part_iter, spec),
            n_workers=procs, depth=8, slot_bytes=1 << 20)
        nrows = members = out_bytes = 0
        parse_s = write_s = 0.0
        for _, (_, rows, nbytes, p_s, w_s) in pool:
            nrows += rows
            members += 1
            out_bytes += nbytes
            parse_s += p_s
            write_s += w_s
        log.info("done. written %d examples", nrows)
        self.num_rows = nrows
        self.stats.update(procs=procs, members=members,
                          out_bytes=out_bytes, parse_s=round(parse_s, 3),
                          write_s=round(write_s, 3))

    def _parsed_blocks(self, threads: int):
        """Text chunks parsed on ``threads`` workers, yielded in read
        order (the native parsers and numpy release the GIL)."""
        p = self.param
        if p.data_format.lower() == "rec":
            yield from Reader(p.data_in, p.data_format, 0, 1,
                              chunk_bytes=int(p.chunk_size * (1 << 20)))
            return
        from .parsers import get_parser
        parse = get_parser(p.data_format)
        files, sizes = expand_uri(p.data_in, with_sizes=True)
        # a read granularity small enough to keep every worker busy
        chunk_bytes = min(int(p.chunk_size * (1 << 20)), 32 << 20)

        def timed_parse(ch):
            t0 = time.perf_counter()
            blk = parse(ch)
            self._acc_stage("parse_s", time.perf_counter() - t0)
            return blk

        with ThreadPoolExecutor(max_workers=threads) as ex:
            futs: deque = deque()
            for path, b, e in _byte_ranges(files, sizes, 0, 1):
                for ch in _iter_text_chunks(path, b, e, chunk_bytes):
                    futs.append(ex.submit(timed_parse, ch))
                    while len(futs) >= 2 * threads:
                        blk = futs.popleft().result()
                        if blk.size:
                            yield blk
            while futs:
                blk = futs.popleft().result()
                if blk.size:
                    yield blk

    def _run_rec(self) -> None:
        """Threaded parse -> member slicing -> threaded localize + write;
        ``part_size`` rolls over to a new ``-part_<i>`` directory once
        the current one holds that many MB."""
        p = self.param
        log.info("reading data from %s in %s format", p.data_in,
                 p.data_format)
        mr = self.member_rows()
        log.info("rec members: %s rows each",
                 mr if mr > 0 else "one read chunk of")
        if p.rec_batch_size == 0 and not p.batch_size and p.rec_localize:
            log.warning(
                "no batch_size given: members default to %d rows; pass "
                "the training batch_size (or rec_batch_size) so members "
                "come out batch-aligned — the cached reader re-compacts "
                "every batch of an unaligned member", DEFAULT_MEMBER_ROWS)
        threads = p.convert_threads or min(6, os.cpu_count() or 1)
        split = p.part_size > 0
        limit = p.part_size * (1 << 20) if split else None
        nrows = ipart = nblk = 0
        written = [0]      # bytes in the current part, as writes land
        written_lock = mutex()
        out_dir = self._open_rec_part(ipart, split)

        def write_member(path: str, blk: RowBlock) -> None:
            t0 = time.perf_counter()
            sz = _write_member(path, blk, p.rec_localize, p.rec_compress)
            self._acc_stage("write_s", time.perf_counter() - t0)
            with written_lock:
                written[0] += sz

        futures: deque = deque()
        with ThreadPoolExecutor(max_workers=threads) as ex:
            for blk in _member_blocks(self._parsed_blocks(threads), mr):
                if split and written[0] >= limit:
                    while futures:   # a part boundary: settle the sizes
                        futures.popleft().result()
                    ipart += 1
                    nblk = 0
                    written[0] = 0
                    out_dir = self._open_rec_part(ipart, split)
                path = stream.join(out_dir,
                                   f"part-{nblk:05d}{self.member_suffix()}")
                futures.append(ex.submit(write_member, path, blk))
                nblk += 1
                nrows += blk.size
                if len(futures) >= 2 * threads:
                    futures.popleft().result()
            while futures:
                futures.popleft().result()
        log.info("done. written %d examples", nrows)
        self.num_rows = nrows

    # ------------------------------------------------------------- libsvm
    def _run_libsvm(self) -> None:
        p = self.param
        reader = Reader(p.data_in, p.data_format, 0, 1,
                        chunk_bytes=int(p.chunk_size * (1 << 20)))
        log.info("reading data from %s in %s format", p.data_in,
                 p.data_format)
        split = p.part_size > 0
        limit = p.part_size * (1 << 20) if split else None
        ipart = nwrite = nrows = 0
        out = None

        def open_part():
            nonlocal ipart, nwrite
            path = p.data_out + (f"-part_{ipart}" if split else "")
            ipart += 1
            nwrite = 0
            log.info("writing data to %s in libsvm format", path)
            return stream.open_stream(path, "w")

        out = open_part()
        try:
            for blk in reader:
                if split and nwrite >= limit:
                    out.close()
                    out = open_part()
                nwrite += _write_text_block(out, blk)
                nrows += blk.size
        finally:
            out.close()
        log.info("done. written %d examples", nrows)
        self.num_rows = nrows


def _write_text_block(out, blk: RowBlock) -> int:
    """One libsvm line per row: ``label idx:val ...`` (``%g``; binary
    features as ``idx:1``)."""
    idx = np.char.mod("%d", blk.index.astype(np.uint64))
    if blk.value is not None:
        feats = np.char.add(np.char.add(idx, ":"),
                            np.char.mod("%g", blk.value))
    else:
        feats = np.char.add(idx, ":1")
    labels = np.char.mod("%g", blk.label)
    off = blk.offset
    data = "\n".join(labels[i] + " " + " ".join(feats[off[i]:off[i + 1]])
                     for i in range(blk.size)) + "\n"
    out.write(data)
    return len(data)
