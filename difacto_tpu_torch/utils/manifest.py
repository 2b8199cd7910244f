"""Checkpoint manifests (counterpart of difacto_tpu/utils/manifest.py).

Every checkpoint save leaves a sidecar

    <path>.manifest.json
      {"format": 1, "generation": 7, "rows": 12345, "learner": "sgd",
       "arrays": {"w": {"sha256": ..., "dtype": "<f4", "shape": [12345]},
                  ...}}

written strictly AFTER the npz finalizes, so it doubles as the commit
marker. ``generation`` increases monotonically across the saves of one
checkpoint family (the prefix with ``_iter-k`` / ``_part-r`` / ``.npz``
stripped). The digest and the JSON layout are the JAX package's, so a
manifest written by either package verifies in the other.
"""

from __future__ import annotations

import hashlib
import json
import logging
import re
import zipfile
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import stream

log = logging.getLogger("difacto_tpu_torch")

MANIFEST_SUFFIX = ".manifest.json"
FORMAT = 1

_ITER_RE = re.compile(r"_iter-(\d+)")
_DECOR_RE = re.compile(
    r"(?:_iter-\d+)?(?:_part-\d+)?(?:_fs-\d+-of-\d+)?(?:\.npz)?$")


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed verification: truncated npz, digest mismatch,
    or a missing manifest where one is required."""

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(
            f"corrupt checkpoint {path!r}: {reason}. Delete or replace "
            "the file, or point at an older generation (task=serve falls "
            "back to the newest verified one automatically).")


def manifest_path(uri: str) -> str:
    return uri + MANIFEST_SUFFIX


def family_prefix(uri: str) -> str:
    return _DECOR_RE.sub("", uri)


def _digest(arr: np.ndarray) -> str:
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype.str).encode())
    h.update(str(a.shape).encode())
    # the bytes through a view, not a copy: hashlib hashes a large buffer
    # without the interpreter lock, where a copy holds it (a 256 MB
    # member stalled a serving batcher ~100 ms during a hot reload)
    h.update(a.reshape(-1).view(np.uint8))
    return h.hexdigest()


def build(arrays: Dict[str, np.ndarray], **extra) -> dict:
    """Manifest dict for a set of named arrays; ``extra`` carries the
    writer's metadata (learner, epoch, rows, generation)."""
    man = {"format": FORMAT}
    man.update(extra)
    man["arrays"] = {
        name: {"sha256": _digest(np.asarray(a)),
               "dtype": str(np.asarray(a).dtype.str),
               "shape": list(np.asarray(a).shape)}
        for name, a in arrays.items()}
    return man


def write(uri: str, man: dict) -> None:
    with stream.open_stream(manifest_path(uri), "w") as f:
        f.write(json.dumps(man, sort_keys=True))


def read(uri: str) -> Optional[dict]:
    """The manifest for ``uri``, or None when the sidecar is absent; a
    garbled sidecar is corrupt, not absent."""
    mp = manifest_path(uri)
    if not stream.exists(mp):
        return None
    try:
        with stream.open_stream(mp, "r") as f:
            man = json.loads(f.read())
        if not isinstance(man, dict) or "arrays" not in man:
            raise ValueError("manifest missing 'arrays'")
        return man
    except (ValueError, OSError) as e:
        raise CheckpointCorrupt(uri, f"unreadable manifest: {e}") from e


def verify(uri: str, require_manifest: bool = False) -> Optional[dict]:
    """Verify checkpoint ``uri`` against its manifest: the manifest (None
    for an accepted manifest-less file). FileNotFoundError when the npz
    is missing; CheckpointCorrupt on any failure, and with
    ``require_manifest`` on a missing sidecar (every save writes one, so
    its absence means a torn save)."""
    with open_verified(uri, require_manifest=require_manifest) as z:
        return z.finish()


class VerifiedNpz:
    """Single-pass verifying npz reader: members are digested as the
    caller loads them; :meth:`finish` digests the members the load never
    touched, so every byte is read once and a corrupt file raises
    :class:`CheckpointCorrupt` before the caller commits any state. A
    clean ``with`` exit runs ``finish()``."""

    def __init__(self, uri: str, require_manifest: bool = False,
                 fault_point: str = ""):
        if not stream.isfile(uri):
            raise FileNotFoundError(uri)
        self.uri = uri
        self.manifest = read(uri)
        if self.manifest is None and require_manifest:
            raise CheckpointCorrupt(
                uri, "manifest missing — incomplete (torn) checkpoint, "
                     "or a file not written by a difacto save")
        try:
            self._npz = stream.load_npz(uri, fault_point=fault_point)
            self._names = set(self._npz.files)
        except FileNotFoundError:
            raise
        except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
            from . import faultinject
            if isinstance(e, faultinject.FaultInjected):
                raise  # an injected read failure keeps its type
            raise CheckpointCorrupt(uri, f"unreadable npz: {e}") from e
        self._checked: set = set()
        self._finished = False

    @property
    def files(self):
        return self._npz.files

    def __getitem__(self, name: str):
        try:
            a = self._npz[name]
        except KeyError:
            raise
        except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
            raise CheckpointCorrupt(
                self.uri, f"array {name!r} unreadable: {e}") from e
        man = self.manifest
        if man is not None and name not in self._checked:
            info = man["arrays"].get(name)
            if info is not None and _digest(np.asarray(a)) != info["sha256"]:
                raise CheckpointCorrupt(
                    self.uri, f"array {name!r} sha256 mismatch (bit flip "
                              "or partial write)")
            self._checked.add(name)
        return a

    def finish(self) -> Optional[dict]:
        if self._finished:
            return self.manifest
        self._finished = True
        if self.manifest is None:
            return None
        for name in self.manifest["arrays"]:
            if name in self._checked:
                continue
            if name not in self._names:
                raise CheckpointCorrupt(
                    self.uri, f"array {name!r} listed in manifest but "
                              "missing from npz (truncated write)")
            self[name]
        return self.manifest

    def close(self) -> None:
        self._npz.close()

    def __enter__(self) -> "VerifiedNpz":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                self.finish()
        finally:
            self.close()


def open_verified(uri: str, require_manifest: bool = False,
                  fault_point: str = "") -> VerifiedNpz:
    return VerifiedNpz(uri, require_manifest=require_manifest,
                       fault_point=fault_point)


# ------------------------------------------------------- generations

def _family_manifests(uri: str) -> List[Tuple[int, str]]:
    """[(generation, npz_path)] of ``uri``'s family, newest first.
    Unreadable sidecars are skipped (they fail verification later)."""
    fam = family_prefix(uri)
    out = []
    for mp in stream.glob(fam + "*" + MANIFEST_SUFFIX):
        base = mp[:-len(MANIFEST_SUFFIX)]
        if family_prefix(base) != fam:
            continue  # a longer sibling prefix globbed in
        try:
            with stream.open_stream(mp, "r") as f:
                man = json.loads(f.read())
            gen = int(man.get("generation", 0))
        except (ValueError, OSError, KeyError):
            continue
        if man.get("fs_shard") is not None:
            continue  # shard members are not load entry points
        out.append((gen, base))
    out.sort(key=lambda t: (-t[0], t[1]))
    return out


def next_generation(uri: str) -> int:
    """Generation the next save of this family stamps (max + 1; first 1)."""
    gens = _family_manifests(uri)
    return (gens[0][0] + 1) if gens else 1


def generation_paths(uri: str) -> List[str]:
    """Checkpoint paths of ``uri``'s family, newest generation first."""
    return [p for _, p in _family_manifests(uri)]


def prune_checkpoints(model_prefix: str, keep: int,
                      protect: Optional[Iterable[int]] = None
                      ) -> List[str]:
    """Retire the interval checkpoints (``_iter-k`` files and their
    manifests) of ``model_prefix``'s family older than the newest
    ``keep`` epochs; the final undecorated model is never a candidate.
    ``protect`` exempts epochs whatever their age (the base a live WAL
    chain is rooted at, an epoch a replica push is still copying); they
    take none of the ``keep`` places. Returns the removed checkpoint
    paths."""
    if keep <= 0:
        return []
    protected = frozenset(int(e) for e in (protect or ()))
    fam = family_prefix(model_prefix)
    by_epoch: Dict[int, List[str]] = {}
    for path in stream.glob(fam + "_iter-*"):
        if path.endswith(MANIFEST_SUFFIX):
            continue
        m = _ITER_RE.search(path)
        if m is None:
            continue
        by_epoch.setdefault(int(m.group(1)), []).append(path)
    removed = []
    for epoch in sorted(by_epoch)[:-keep]:
        if epoch in protected:
            continue
        for path in by_epoch[epoch]:
            for p in (path, manifest_path(path)):
                try:
                    stream.remove(p)
                    if p == path:
                        removed.append(p)
                except OSError:
                    pass
    return removed
