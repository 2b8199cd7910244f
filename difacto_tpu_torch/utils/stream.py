"""File IO (counterpart of difacto_tpu/utils/stream.py), local paths only.

Atomic npz writes (tmp + rename) with the manifest sidecar written
strictly after the npz finalizes, npz reads, and the directory helpers
the data readers, the rec cache and the converter call (listing with
sizes, ``makedirs``, ``join``). The files are byte-compatible with the
JAX package's in both directions. Remote (``scheme://``) URIs are not
ported yet and raise; ``file://`` is a local path.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import IO, List, Optional

import numpy as np


def _local(uri: str) -> str:
    if uri.startswith("file://"):
        return uri[len("file://"):]
    if "://" in uri:
        raise NotImplementedError(
            f"remote URI {uri!r}: the port reads and writes local paths "
            "only (ROADMAP.md, Queue 1: remote streams)")
    return uri


def _ensure_parent(path: str) -> None:
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)


def open_stream(uri: str, mode: str = "rb") -> IO:
    """Open a local path; writes create missing parent directories."""
    path = _local(uri)
    if "w" in mode or "a" in mode:
        _ensure_parent(path)
    return open(path, mode)


def exists(uri: str) -> bool:
    return os.path.exists(_local(uri))


def isfile(uri: str) -> bool:
    return os.path.isfile(_local(uri))


def isdir(uri: str) -> bool:
    return os.path.isdir(_local(uri))


def listdir_files(uri: str) -> List[tuple]:
    """Sorted [(path, size)] of the regular files in a directory."""
    return sorted((e.path, e.stat().st_size)
                  for e in os.scandir(_local(uri)) if e.is_file())


def getsize(uri: str) -> int:
    return os.path.getsize(_local(uri))


def getmtime(uri: str) -> float:
    """Last-modified time in seconds (the hot-reload watcher's hint
    beside manifest generations)."""
    return os.path.getmtime(_local(uri))


def makedirs(uri: str) -> None:
    os.makedirs(_local(uri), exist_ok=True)


def join(uri: str, *parts: str) -> str:
    return os.path.join(_local(uri), *parts)


def glob(uri: str) -> List[str]:
    return sorted(_glob.glob(_local(uri)))


def remove(uri: str) -> None:
    os.remove(_local(uri))


def save_npz(uri: str, manifest: Optional[dict] = None,
             compress: bool = False, **arrays) -> None:
    """Atomic npz write (tmp + rename), uncompressed unless ``compress``
    (a 4M-row table is ~300 MB, which zlib would write at a few MB/s).
    ``manifest`` (writer metadata: learner/rows/generation) turns on the
    ``<path>.manifest.json`` sidecar with per-array sha256 digests,
    written AFTER the npz finalizes so it doubles as the commit marker
    (utils/manifest.py)."""
    path = _local(uri)
    _ensure_parent(path)
    tmp = path + ".tmp.npz"  # .npz suffix stops savez appending its own
    (np.savez_compressed if compress else np.savez)(tmp, **arrays)
    os.replace(tmp, path)
    if manifest is not None:
        from . import manifest as _mft
        _mft.write(uri, _mft.build(
            {k: np.asarray(v) for k, v in arrays.items()}, **manifest))


def load_npz(uri: str):
    """np.load of an npz; the caller uses it as a context manager."""
    return np.load(_local(uri))
