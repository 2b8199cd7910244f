"""Model metadata + serving-store construction (counterpart of
difacto_tpu/serve/model.py).

``open_serving_store`` is the serving entry: a read-only SlotStore
(hashed or dictionary, FM or the flat V_dim=0 table) on ``device`` with
a weights-only, manifest-verified load. The geometry (V_dim,
hash_capacity, slot_dtype) comes from the checkpoint itself; a corrupt
newest file walks back to the newest generation that verifies, unless the caller (a hot reload) asks
for no walk-back. ``serve_mesh_fs > 1`` (:class:`ServingShardParam`)
opens the read-only table fs-sharded over a ``(1, serve_mesh_fs)`` mesh
(parallel/mesh.py): each key range a shard, every pull one gather launch
per shard run. Any checkpoint layout loads into any ``serve_mesh_fs``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

from ..config import KWArgs, Param
from ..utils import stream

log = logging.getLogger("difacto_tpu_torch")


@dataclasses.dataclass
class ServingShardParam(Param):
    """The mesh knob of the serving-store open path (the JAX package's):
    ``serve_mesh_fs > 1`` shards the read-only table into that many
    contiguous key ranges (a power of two dividing ``hash_capacity``).
    run_serve hands the same kwargs to the reloader, so a reload rebuilds
    the same mesh."""
    serve_mesh_fs: int = dataclasses.field(default=1, metadata=dict(lo=1))


def store_geometry(param) -> Tuple[int, int, str]:
    """(V_dim, hash_capacity, slot_dtype): what a predict executor's
    store functions (``make_fns(param)``) were built for. An in-place hot
    reload (executor.swap_store) needs it unchanged; a change goes through
    the blue/green executor swap (serve/reload.py)."""
    return (param.V_dim, param.hash_capacity, param.slot_dtype)


def resolve_model_path(uri: str) -> str:
    """The checkpoint file behind a model prefix: learners append
    ``_part-<rank>`` (sgd) or ``.npz`` (lbfgs/bcd)."""
    for cand in (uri, uri + "_part-0", uri + ".npz", uri + "_part-0.npz"):
        if stream.isfile(cand):
            return cand
    raise FileNotFoundError(f"no model file found for {uri!r} "
                            f"(tried _part-0 / .npz suffixes)")


def model_meta(uri: str) -> dict:
    """{'path', 'learner', 'hashed', 'hash_capacity', 'V_dim', 'save_aux',
    'fs_count', 'slot_dtype'} of a saved model; ``learner`` comes from the
    checkpoint's marker, else from the key layout each learner writes."""
    path = resolve_model_path(uri)
    with stream.load_npz(path) as z:
        files = set(z.files)
        if "learner" in files:
            learner: Optional[str] = str(z["learner"])
        elif "hash_capacity" in files or "keys" in files:
            learner = "sgd"
        elif "lens" in files and "weights" in files:
            learner = "lbfgs"
        elif "feaids" in files and "w" in files:
            learner = "bcd"
        else:
            learner = None
        return {
            "path": path,
            "learner": learner,
            "hashed": "hash_capacity" in files,
            "hash_capacity": (int(z["hash_capacity"])
                              if "hash_capacity" in files else 0),
            "V_dim": int(z["V_dim"]) if "V_dim" in files else 0,
            "save_aux": bool(z["save_aux"]) if "save_aux" in files else False,
            "fs_count": int(z["fs_count"]) if "fs_count" in files else 1,
            "slot_dtype": (str(z["slot_dtype"])
                           if "slot_dtype" in files else "fp32"),
        }


def open_serving_store(model_in: str, kwargs: KWArgs = (),
                       fallback: bool = True, device="cuda", mesh=None
                       ) -> Tuple["SlotStore", dict, KWArgs]:
    """Read-only SlotStore on ``device`` loaded weights-only from
    ``model_in``; updater keys in ``kwargs`` (l1_shrk, V_dtype, ...) are
    consumed, the geometry is the checkpoint's. Returns (store, meta,
    leftover kwargs). With ``fallback`` (serve startup) a corrupt file
    walks back to the newest generation of its family that verifies;
    ``fallback=False`` (a hot reload) raises instead, so a failed reload
    keeps the model in memory and never regresses to an older file.
    ``mesh`` (a parallel.mesh.Mesh) overrides ``serve_mesh_fs``:
    task=pred under the training mesh keys opens the store on that
    mesh."""
    from ..utils import manifest as mft
    from ..utils.manifest import CheckpointCorrupt

    path = resolve_model_path(model_in)
    candidates = [path]
    if fallback:
        candidates += [p for p in mft.generation_paths(path) if p != path]
    last_err: Optional[CheckpointCorrupt] = None
    for cand in candidates:
        try:
            out = _open_verified(cand, kwargs, device, mesh)
        except FileNotFoundError:
            continue
        except CheckpointCorrupt as e:
            log.warning("serving model candidate failed verification: %s", e)
            last_err = e
            continue
        if cand != path:
            log.warning("model %s is corrupt; serving previous verified "
                        "generation %s instead", path, cand)
        return out
    if last_err is None:
        raise FileNotFoundError(path)
    raise last_err


def _open_verified(path: str, kwargs: KWArgs, device, mesh=None
                   ) -> Tuple["SlotStore", dict, KWArgs]:
    from ..store.local import SlotStore
    from ..updaters.sgd_updater import SGDUpdaterParam

    meta = model_meta(path)
    if meta["learner"] not in (None, "sgd"):
        raise ValueError(
            f"model {path!r} was produced by "
            f"learner={meta['learner']!r}; the serving executor loads sgd "
            "SlotStore checkpoints only — re-train with learner=sgd to "
            "serve this data")
    sparam, kwargs = ServingShardParam.init_allow_unknown(list(kwargs))
    uparam, remain = SGDUpdaterParam.init_allow_unknown(kwargs)
    # geometry from the checkpoint; the cold tier is a training-side
    # residency choice, a serving replica holds the whole table
    uparam = dataclasses.replace(uparam, V_dim=meta["V_dim"],
                                 hash_capacity=meta["hash_capacity"],
                                 slot_dtype=meta["slot_dtype"],
                                 cold_tier_rows=0)
    if mesh is None and sparam.serve_mesh_fs > 1:
        from ..parallel import make_mesh
        mesh = make_mesh(dp=1, fs=sparam.serve_mesh_fs, device=device)
    store = SlotStore(uparam, device=device, read_only=True, mesh=mesh)
    n = store.load(meta["path"])
    log.info("serving store: %s (%s, V_dim=%d, %s, fs=%d, %d non-empty "
             "entries, weights-only)", meta["path"],
             "hashed" if meta["hashed"] else "dictionary", meta["V_dim"],
             store.device, store.fs_count, n)
    return store, meta, remain
