"""Bucketed read-only predict executor (counterpart of
difacto_tpu/serve/executor.py).

Rows / nnz / distinct-feature counts / the widest row pad up to STICKY
bucket caps (data/pack_stream.ShapeSchedule), so a stream of batches
reuses a few padded shapes. The same executor backs ``task=pred``
(__main__.py) and ``task=serve`` (serve/server.py): identical
localization, packing (ops/batch.pack_batch) and predict step
(step.make_predict_fn), and every row's score is computed in a fixed
per-row order (ops/segment.py) — so offline prediction files and online
responses are bit-identical for the same rows, however they are batched.

The executor never mutates the store: in a hashed store unknown ids hash
to slots whose rows are whatever the table holds; in a dictionary store
they map to the trash slot, whose w is 0 and whose embedding is never
live, as in the JAX package.

Hot reload (serve/reload.py) swaps a freshly loaded store of the same
geometry under the executor (:meth:`PredictExecutor.swap_store`); a
geometry change builds a second executor, seeds it with this one's
sticky caps (:meth:`seed_caps`) and runs one padded predict per recorded
bucket (:meth:`warm_bucket`) before the server retargets its batcher.
Nothing is compiled here: a warm launches the gather on the new table and
primes the caching allocator's blocks for those shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..data.localizer import compact
from ..data.pack_stream import ShapeSchedule
from ..data.rowblock import RowBlock
from ..losses import LossSpec, create as create_loss
from ..ops.batch import max_row_nnz, pack_batch, unpack_batch
from ..step import make_predict_fn
from ..store.local import SlotStore, pad_slots_oob
from ..utils.locktrace import mutex


def sigmoid(pred: np.ndarray) -> np.ndarray:
    """Raw margin -> probability, shared by the pred writer and the serve
    response formatter (one definition, identical bytes)."""
    return 1.0 / (1.0 + np.exp(-np.asarray(pred)))


class PredictExecutor:
    """Shape-bucketed batch scoring over a SlotStore on its device.

    ``predict(blk)`` -> (scores[:rows] np.float32 raw margins, objv, auc)
    with objv/auc left as device scalars. Dispatch is single-threaded by
    contract; the stats counters are locked for observer threads."""

    def __init__(self, store: SlotStore, loss: Optional[LossSpec] = None):
        self.store = store
        self.loss = loss if loss is not None \
            else create_loss("fm", store.param.V_dim)
        self._step = make_predict_fn(store.fns, self.loss)
        self.shapes = ShapeSchedule()
        self._mu = mutex()
        self._buckets: dict = {}   # statics key -> dispatch count
        self._dispatches = 0
        self._warmed = 0           # buckets registered by warm_bucket()
        self.generation = 1        # advances once per hot reload

    def stats(self) -> dict:
        """{'buckets_compiled', 'bucket_hits', 'dispatches',
        'model_generation'} under the JAX executor's names and arithmetic:
        a bucket counts at its first occurrence; a warmed bucket was
        registered without a dispatch, so it does not deflate the hits.
        A sharded store adds ``fs``, its key-range shard count (the JAX
        executor has no such key, so an unsharded one keeps JAX's set)."""
        with self._mu:
            out = {"buckets_compiled": len(self._buckets),
                   "bucket_hits": self._dispatches
                   - (len(self._buckets) - self._warmed),
                   "dispatches": self._dispatches,
                   "model_generation": self.generation}
            fs = self.store.fs_count
        if fs > 1:
            out["fs"] = fs
        return out

    # ------------------------------------------------------- warm replay
    def warm_set(self) -> Tuple[dict, list]:
        """(sticky-cap snapshot, recorded bucket keys): what a blue/green
        successor needs to pad every batch this executor served to the
        same shapes and to warm them before the swap."""
        with self._mu:
            return self.shapes.snapshot(), list(self._buckets)

    def seed_caps(self, caps: dict) -> None:
        """Adopt another executor's sticky caps, so a batch that was a
        bucket hit there stays one here."""
        self.shapes.absorb(caps)

    def warm_bucket(self, key: Tuple[int, int, int, int, bool]) -> None:
        """One predict of a synthetic single-row batch padded to the
        bucket ``key``'s caps, on this executor's store: it launches the
        gather on the new table and allocates the shapes a later request
        of that bucket needs. Registers the key without counting a
        dispatch."""
        b_cap, nnz_cap, u_cap, row_cap, binary = key
        store = self.store
        dev = store.device
        blk = RowBlock(
            offset=np.array([0, 1], dtype=np.int64),
            label=np.zeros(1, dtype=np.float32),
            index=np.zeros(1, dtype=np.uint32),
            value=None if binary else np.ones(1, dtype=np.float32),
            weight=None)
        padded = pad_slots_oob(np.zeros(1, dtype=np.int32), u_cap,
                               store.state.capacity)
        i32, f32, _ = pack_batch(blk, 1, padded, b_cap, nnz_cap, u_cap)
        batch, slots_t, _ = unpack_batch(
            torch.from_numpy(i32).to(dev), torch.from_numpy(f32).to(dev),
            b_cap, nnz_cap, u_cap, row_cap, binary=binary)
        pred, _, _ = self._step(store.state, batch, store.shard_slots(
            slots_t, padded, store.state.capacity))
        pred.cpu()                 # the warm ends when its launch does
        with self._mu:
            if key not in self._buckets:
                self._buckets[key] = 0
                self._warmed += 1

    # ------------------------------------------------------------- swap
    def swap_store(self, store: SlotStore) -> int:
        """The same-geometry hot-reload commit point: one attribute
        assignment. ``predict`` snapshots ``self.store`` once per call, so
        a batch in flight finishes on the model it started with. A store
        of another geometry (:func:`model.store_geometry`) is refused, and
        the old model keeps serving; the reloader routes it through the
        blue/green executor swap instead."""
        from .model import store_geometry
        old = self.store
        if store.fs_count != old.fs_count:
            raise ValueError(
                f"hot-reload mesh mismatch: serving an "
                f"fs={old.fs_count}-sharded table, new store is "
                f"fs={store.fs_count}; pass the same serve_mesh_fs on "
                "reload (run_serve threads it through the reloader)")
        if store_geometry(store.param) != store_geometry(old.param):
            raise ValueError(
                f"hot-reload geometry mismatch: serving "
                f"(V_dim={old.param.V_dim}, "
                f"hash_capacity={old.param.hash_capacity}) vs new model "
                f"(V_dim={store.param.V_dim}, "
                f"hash_capacity={store.param.hash_capacity}); in-place "
                "swap keeps the store functions, so a geometry change "
                "must go through the blue/green executor swap "
                "(serve/reload.py, requires a server-attached reloader)")
        with self._mu:
            # lint: ok(data-race) atomic reference swap (hot-reload commit):
            # predict and warm_bucket read self.store once per batch
            self.store = store
            self.generation += 1
            return self.generation

    def predict(self, blk: RowBlock) -> Tuple[np.ndarray, torch.Tensor,
                                              torch.Tensor]:
        """Score a raw-id row block: (clamped raw margins of the real rows
        on the host, objv, auc on the device)."""
        # ONE store snapshot per batch: a concurrent swap_store never
        # splits a batch across two models
        store = self.store
        dev = store.device
        if blk.size == 0:
            z = torch.zeros((), dtype=torch.float32, device=dev)
            return np.zeros(0, dtype=np.float32), z, z
        cblk, uniq, _ = compact(blk)
        # sort + dedup the slot set (the gather declares sorted unique
        # slots; hashed ids may collide) and rewrite the localized columns
        slots = store.map_keys(uniq, insert=False)
        uniq_slots, remap = np.unique(slots, return_inverse=True)
        cblk = RowBlock(offset=cblk.offset, label=cblk.label,
                        index=remap[cblk.index].astype(np.uint32),
                        value=cblk.value, weight=cblk.weight)
        n_uniq = len(uniq_slots)
        b_cap = self.shapes.cap("serve.b", blk.size)
        nnz_cap = self.shapes.cap("serve.nnz", blk.nnz)
        u_cap = self.shapes.cap("serve.u", n_uniq)
        row_cap = self.shapes.cap("serve.row", max_row_nnz(blk))
        padded = pad_slots_oob(uniq_slots.astype(np.int32), u_cap,
                               store.state.capacity)
        i32, f32, binary = pack_batch(cblk, n_uniq, padded, b_cap, nnz_cap,
                                      u_cap)
        key = (b_cap, nnz_cap, u_cap, row_cap, binary)
        with self._mu:
            self._buckets[key] = self._buckets.get(key, 0) + 1
            self._dispatches += 1
        batch, slots_t, _ = unpack_batch(
            torch.from_numpy(i32).to(dev), torch.from_numpy(f32).to(dev),
            b_cap, nnz_cap, u_cap, row_cap, binary=binary)
        pred, objv, auc = self._step(store.state, batch, store.shard_slots(
            slots_t, padded, store.state.capacity))
        return pred[:blk.size].cpu().numpy(), objv, auc

    def predict_scores(self, blk: RowBlock) -> np.ndarray:
        """Scores only — the micro-batcher's entry."""
        return self.predict(blk)[0]
