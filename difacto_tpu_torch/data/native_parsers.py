"""ctypes bridge: the native libsvm, criteo and adfea parsers into
RowBlocks (counterpart of difacto_tpu/data/native_parsers.py).

Each falls back to its Python parser (data/parsers.py) when the native
library (native/__init__.py) is unavailable; both give the same
RowBlocks byte for byte (tests/test_torch_native.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..base import FEAID_DTYPE, REAL_DTYPE
from ..native import get_lib
from .rowblock import RowBlock, empty_block


def parse_libsvm_native(chunk: bytes) -> RowBlock:
    lib = get_lib()
    if lib is None:
        from .parsers import parse_libsvm
        return parse_libsvm(chunk)

    max_rows = chunk.count(b"\n") + 2
    # implicit-value tokens ("idx" == "idx:1") carry no ':', so budget by
    # token count instead: tokens are separated by >= 1 whitespace char
    # and each row owns one label token, so features <= separators + 1
    max_nnz = (chunk.count(b" ") + chunk.count(b"\t") + chunk.count(b"\n")
               + chunk.count(b"\r") + 2)
    labels = np.empty(max_rows, dtype=REAL_DTYPE)
    offset = np.empty(max_rows + 1, dtype=np.int64)
    index = np.empty(max_nnz, dtype=FEAID_DTYPE)
    value = np.empty(max_nnz, dtype=REAL_DTYPE)
    out_rows = ctypes.c_int64()
    out_nnz = ctypes.c_int64()
    out_has_value = ctypes.c_int()

    rc = lib.difacto_parse_libsvm(
        chunk, len(chunk),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offset.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        index.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        value.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(out_rows), ctypes.byref(out_nnz),
        ctypes.byref(out_has_value))
    if rc != 0:
        raise ValueError("malformed libsvm chunk")
    n, nnz = out_rows.value, out_nnz.value
    if n == 0:
        return empty_block()
    return RowBlock(
        offset=offset[:n + 1].copy(),
        label=labels[:n].copy(),
        index=index[:nnz].copy(),
        value=value[:nnz].copy() if out_has_value.value else None,
    )


def parse_criteo_native(chunk: bytes, is_train: bool = True) -> RowBlock:
    lib = get_lib()
    if lib is None:
        from .parsers import parse_criteo
        return parse_criteo(chunk, is_train)

    max_rows = chunk.count(b"\n") + 2
    # every feature field follows a tab in train mode; without a label the
    # first field has no leading tab, so budget one extra feature per row
    max_nnz = chunk.count(b"\t") + (1 if is_train else max_rows) + 1
    labels = np.empty(max_rows, dtype=REAL_DTYPE)
    offset = np.empty(max_rows + 1, dtype=np.int64)
    index = np.empty(max_nnz, dtype=FEAID_DTYPE)
    out_rows = ctypes.c_int64()
    out_nnz = ctypes.c_int64()

    rc = lib.difacto_parse_criteo(
        chunk, len(chunk), int(is_train),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offset.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        index.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        max_rows, max_nnz,
        ctypes.byref(out_rows), ctypes.byref(out_nnz))
    if rc != 0:
        raise ValueError("malformed criteo chunk" if rc == -1
                         else "criteo parse buffer overflow")
    n, nnz = out_rows.value, out_nnz.value
    if n == 0:
        return empty_block()
    return RowBlock(
        offset=offset[:n + 1].copy(),
        label=labels[:n].copy(),
        index=index[:nnz].copy(),
        value=None,  # binary features
    )


def parse_adfea_native(chunk: bytes) -> RowBlock:
    """Native adfea parser with the Python fallback (parsers.parse_adfea
    is the semantic reference; src/reader/adfea_parser.h:20-91)."""
    lib = get_lib()
    if lib is None:
        from .parsers import parse_adfea
        return parse_adfea(chunk)

    # every feature token contains ':'; rows are delimited by their 3
    # header tokens, so splitting on whitespace bounds rows loosely
    max_nnz = chunk.count(b":") + 1
    # tokens are separated by >= 1 whitespace char and each row owns 3
    # header tokens, so rows <= (separators + 1) / 3; count every
    # separator class the native tokenizer skips (incl. '\r' — an
    # undercount here overruns the caller-allocated buffers)
    seps = (chunk.count(b"\n") + chunk.count(b" ") + chunk.count(b"\t")
            + chunk.count(b"\r"))
    max_rows = seps // 3 + 2
    labels = np.empty(max_rows, dtype=REAL_DTYPE)
    offset = np.empty(max_rows + 1, dtype=np.int64)
    index = np.empty(max_nnz, dtype=FEAID_DTYPE)
    out_rows = ctypes.c_int64()
    out_nnz = ctypes.c_int64()

    rc = lib.difacto_parse_adfea(
        chunk, len(chunk),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offset.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        index.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.byref(out_rows), ctypes.byref(out_nnz))
    if rc != 0:
        raise ValueError("malformed adfea chunk")
    n, nnz = out_rows.value, out_nnz.value
    if n == 0:
        return empty_block()
    return RowBlock(
        offset=offset[:n + 1].copy(),
        label=labels[:n].copy(),
        index=index[:nnz].copy(),
        value=None,  # binary features
    )
