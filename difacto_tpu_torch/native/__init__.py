"""The host-side C++ parsers (libsvm, criteo, adfea, and the MurmurHash64A
the criteo parser hashes with), built with ``g++`` at first use and
loaded with ``ctypes`` (counterpart of difacto_tpu/native).

The library goes into ``difacto_tpu_torch/_build/`` (ignored by git),
named by the content hash of its sources and flags, as the CUDA kernels
are (ops/build.py): an edited source rebuilds, an unchanged one is
reused, and concurrent first uses in several processes each build to a
per-pid tmp file and rename it into place. Nothing is ever written next
to the sources. When the library cannot be built or loaded,
:func:`get_lib` returns None and the callers (data/native_parsers.py)
parse with the Python parsers, which give the same RowBlocks byte for
byte. This is host parsing, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

from ..ops.build import BUILD_DIR
from ..utils.locktrace import mutex

log = logging.getLogger("difacto_tpu_torch")

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("libsvm_parser.cc", "criteo_parser.cc", "adfea_parser.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = mutex()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                        *(str(SRC_DIR / n) for n in SOURCES)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _bind(lib: ctypes.CDLL) -> None:
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_i64_p = ctypes.POINTER(ctypes.c_int64)
    c_u64_p = ctypes.POINTER(ctypes.c_uint64)
    lib.difacto_parse_libsvm.restype = ctypes.c_int
    lib.difacto_parse_libsvm.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, c_float_p, c_i64_p, c_u64_p,
        c_float_p, c_i64_p, c_i64_p, ctypes.POINTER(ctypes.c_int)]
    lib.difacto_parse_criteo.restype = ctypes.c_int
    lib.difacto_parse_criteo.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, c_float_p, c_i64_p,
        c_u64_p, ctypes.c_int64, ctypes.c_int64, c_i64_p, c_i64_p]
    lib.difacto_parse_adfea.restype = ctypes.c_int
    lib.difacto_parse_adfea.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, c_float_p, c_i64_p, c_u64_p,
        c_i64_p, c_i64_p]
    lib.difacto_murmur64a.restype = ctypes.c_uint64
    lib.difacto_murmur64a.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_uint64]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when it cannot be
    built or loaded (the callers then parse in Python). One attempt per
    process."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                # the first-use build is serialized on purpose: every
                # caller needs its result, and g++ is bounded by the
                # subprocess timeout=120 (processes race safely through
                # the per-pid tmp and the atomic replace)
                # lint: ok(lock-blocking) bounded build under the init lock
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            log.info("native parsers unavailable (%s); parsing in Python", e)
            return None
        _bind(lib)
        _lib = lib
        return _lib
