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
"""

from __future__ import annotations

import threading
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
        self._mu = threading.Lock()
        self._buckets: dict = {}   # statics key -> dispatch count
        self._dispatches = 0

    def stats(self) -> dict:
        with self._mu:
            return {"buckets": len(self._buckets),
                    "bucket_hits": self._dispatches - len(self._buckets),
                    "dispatches": self._dispatches}

    def predict(self, blk: RowBlock) -> Tuple[np.ndarray, torch.Tensor,
                                              torch.Tensor]:
        """Score a raw-id row block: (clamped raw margins of the real rows
        on the host, objv, auc on the device)."""
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
        pred, objv, auc = self._step(store.state, batch, slots_t)
        return pred[:blk.size].cpu().numpy(), objv, auc

    def predict_scores(self, blk: RowBlock) -> np.ndarray:
        """Scores only — the micro-batcher's entry."""
        return self.predict(blk)[0]
