"""File IO over local paths and remote URIs (counterpart of
difacto_tpu/utils/stream.py).

Plain paths (and ``file://``) use the standard library. Any other
``scheme://`` URI (``hdfs://``, ``gs://``, ``s3://``, ``memory://`` in
the tests) routes through fsspec, which is imported only when a remote
URI is used, so local paths need no fsspec. The helpers: opening,
listing (with sizes, one listing call for a remote directory), ``glob``,
``makedirs``, ``remove``, ``getmtime``, ``join``; atomic npz writes
(local: tmp + rename; remote: an upload to ``<uri>.tmp`` and a
server-side move) with the manifest sidecar written strictly after the
npz finalizes; npz reads (a remote object is fetched into memory
first). The files are byte-compatible with the JAX package's in both
directions.
"""

from __future__ import annotations

import glob as _glob
import io
import os
from typing import IO, List, Optional

import numpy as np


def is_remote(uri: str) -> bool:
    """True for ``scheme://`` URIs other than ``file://``."""
    return "://" in uri and not uri.startswith("file://")


def _local(uri: str) -> str:
    return uri[len("file://"):] if uri.startswith("file://") else uri


def _fs(uri: str):
    """(fsspec filesystem, path) of a remote URI."""
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            f"remote URI {uri!r} requires fsspec (pip install fsspec)") from e
    return fsspec.core.url_to_fs(uri)


def _scheme(uri: str) -> str:
    return uri.split("://", 1)[0] + "://"


def _ensure_parent(path: str) -> None:
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)


def open_stream(uri: str, mode: str = "rb") -> IO:
    """Open a local path or a remote URI; local writes create missing
    parent directories (fsspec's remote writes make their own)."""
    if is_remote(uri):
        fs, path = _fs(uri)
        return fs.open(path, mode)
    path = _local(uri)
    if "w" in mode or "a" in mode:
        _ensure_parent(path)
    return open(path, mode)


def exists(uri: str) -> bool:
    if is_remote(uri):
        fs, path = _fs(uri)
        return fs.exists(path)
    return os.path.exists(_local(uri))


def isfile(uri: str) -> bool:
    if is_remote(uri):
        fs, path = _fs(uri)
        return fs.isfile(path)
    return os.path.isfile(_local(uri))


def isdir(uri: str) -> bool:
    if is_remote(uri):
        fs, path = _fs(uri)
        return fs.isdir(path)
    return os.path.isdir(_local(uri))


def listdir(uri: str) -> List[str]:
    """Sorted full paths (URIs stay URIs) of a directory's entries."""
    if is_remote(uri):
        fs, path = _fs(uri)
        sch = _scheme(uri)
        return sorted(p if p.startswith(sch) else sch + p.lstrip("/")
                      for p in fs.ls(path, detail=False))
    path = _local(uri)
    return sorted(os.path.join(path, f) for f in os.listdir(path))


def listdir_files(uri: str) -> List[tuple]:
    """Sorted [(path, size)] of the regular files in a directory: one
    listing call for a remote directory, not a stat per file."""
    if is_remote(uri):
        fs, path = _fs(uri)
        sch = _scheme(uri)
        out = []
        for e in fs.ls(path, detail=True):
            if e.get("type") == "file":
                name = e["name"]
                if not name.startswith(sch):
                    name = sch + name.lstrip("/")
                out.append((name, int(e.get("size") or 0)))
        return sorted(out)
    return sorted((e.path, e.stat().st_size)
                  for e in os.scandir(_local(uri)) if e.is_file())


def glob(uri: str) -> List[str]:
    if is_remote(uri):
        fs, path = _fs(uri)
        sch = _scheme(uri)
        return sorted(sch + p.lstrip("/") for p in fs.glob(path))
    return sorted(_glob.glob(_local(uri)))


def getsize(uri: str) -> int:
    if is_remote(uri):
        fs, path = _fs(uri)
        return fs.size(path)
    return os.path.getsize(_local(uri))


def getmtime(uri: str) -> float:
    """Last-modified time in seconds (the hot-reload watcher's hint
    beside manifest generations); 0.0 where a remote backend cannot
    say."""
    if is_remote(uri):
        fs, path = _fs(uri)
        try:
            return fs.modified(path).timestamp()
        except (NotImplementedError, AttributeError, OSError):
            return 0.0
    return os.path.getmtime(_local(uri))


def makedirs(uri: str) -> None:
    if is_remote(uri):
        fs, path = _fs(uri)
        fs.makedirs(path, exist_ok=True)
        return
    os.makedirs(_local(uri), exist_ok=True)


def remove(uri: str) -> None:
    """Delete a file (checkpoint pruning, tmp-key cleanup)."""
    if is_remote(uri):
        fs, path = _fs(uri)
        fs.rm(path)
        return
    os.remove(_local(uri))


def join(uri: str, *parts: str) -> str:
    if is_remote(uri):
        return "/".join([uri.rstrip("/"), *parts])
    return os.path.join(_local(uri), *parts)


def move_remote(tmp: str, uri: str) -> None:
    """Finalize a remote upload: a server-side move of ``tmp`` onto
    ``uri`` (copy + delete where the backend has no move)."""
    fs, path = _fs(uri)
    _, tmp_path = _fs(tmp)
    try:
        fs.mv(tmp_path, path)
    except (AttributeError, NotImplementedError):
        fs.copy(tmp_path, path)
        fs.rm(tmp_path)


def save_npz(uri: str, manifest: Optional[dict] = None,
             compress: bool = False, fault_point: str = "",
             **arrays) -> None:
    """Atomic npz write, uncompressed unless ``compress`` (a 4M-row
    table is ~300 MB, which zlib would write at a few MB/s). Local: tmp
    + rename. Remote: the bytes go to ``<uri>.tmp`` and a server-side
    move finalizes them, so no reader sees a half-uploaded object under
    the real name.

    ``manifest`` (writer metadata: learner/rows/generation) turns on the
    ``<path>.manifest.json`` sidecar with per-array sha256 digests,
    written AFTER the npz finalizes, so it doubles as the commit marker
    (utils/manifest.py).

    ``fault_point`` names the injection point to traverse
    (utils/faultinject.py): ``truncate`` tears the artifact (half its
    bytes under the final name, no manifest: what a crash mid-upload
    leaves) and ``kill`` tears it, then SIGKILLs the process."""
    from . import faultinject
    kind = faultinject.fire(fault_point) if fault_point else None
    save = np.savez_compressed if compress else np.savez
    if is_remote(uri):
        buf = io.BytesIO()
        save(buf, **arrays)
        data = buf.getvalue()
        if kind in ("truncate", "kill"):
            _torn_write(uri, data, kind)
            return
        tmp = uri + ".tmp"
        with open_stream(tmp, "wb") as f:
            f.write(data)
        move_remote(tmp, uri)
    else:
        path = _local(uri)
        _ensure_parent(path)
        tmp = path + ".tmp.npz"  # .npz suffix stops savez appending its own
        save(tmp, **arrays)
        if kind in ("truncate", "kill"):
            with open(tmp, "rb") as f:
                data = f.read()
            os.remove(tmp)
            _torn_write(path, data, kind)
            return
        os.replace(tmp, path)
    if manifest is not None:
        from . import manifest as _mft
        _mft.write(uri, _mft.build(
            {k: np.asarray(v) for k, v in arrays.items()}, **manifest))


def _torn_write(uri: str, data: bytes, kind: str) -> None:
    """An injected torn write: half the bytes land under the FINAL name
    (past the tmp + rename that exists to prevent exactly this), no
    manifest follows, and ``kill`` then takes the process down like a
    SIGKILL mid-checkpoint."""
    with open_stream(uri, "wb") as f:
        f.write(data[:max(len(data) // 2, 1)])
    if kind == "kill":
        import signal
        os.kill(os.getpid(), signal.SIGKILL)


def load_npz(uri: str, fault_point: str = ""):
    """np.load of an npz; the caller uses it as a context manager. A
    remote object is fetched into memory first (np.load needs a seekable
    file). ``fault_point`` traverses an injection point: ``err`` is the
    same OSError a failing read raises."""
    if fault_point:
        from . import faultinject
        faultinject.act_default(faultinject.fire(fault_point))
    if is_remote(uri):
        with open_stream(uri, "rb") as f:
            return np.load(io.BytesIO(f.read()))
    return np.load(_local(uri))
