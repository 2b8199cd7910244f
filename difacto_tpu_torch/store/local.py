"""Slot store over a hashed device slot table (counterpart of
difacto_tpu/store/local.py, the hashed store).

The model lives in device tensors (:class:`SGDState`); the host keeps only
the slot-assignment rule. A hashed store maps byte-reversed feature ids to
``rev_id mod (capacity - 1) + 1`` (row 0 stays the trash slot), with no
dictionary. Checkpoints are the JAX package's npz + manifest format, byte
for byte, in both directions: a hashed save writes the full dense logical
table (w, cnt, v_live, V and, with aux, z, sqrt_g, Vg as f32 arrays) plus
geometry stamps, and a load rebuilds the fused rows through
``build_rows`` (requantizing when the stamp says int8/fp8).

A trainable store (``read_only=False``) carries the optimizer state in
its fused rows and saves it with ``save_aux``; the learner pushes through
``store.fns`` (updaters/sgd_updater.make_fns) in place on ``state.VVg``.

Not ported yet, and raising a typed NotImplementedError that names the
ROADMAP.md queue item: the dictionary (exact-id) store, per-key-range
sharded checkpoints, the host-RAM cold tier, count-min admission and
occupancy eviction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..base import FEAID_DTYPE
from ..updaters.sgd_updater import (SGDState, SGDUpdaterParam,
                                    emb_cols_f32, init_state, make_fns,
                                    quantized, row_layout, scal_cols)
from ..utils import manifest as mft
from ..utils import stream
from ..utils.platform import resolve_device
from .convert import state_from_numpy


def pad_slots_oob(slots: np.ndarray, cap: int, capacity: int) -> np.ndarray:
    """int32[cap]: sorted unique ``slots`` followed by ascending
    out-of-bounds padding (capacity, capacity+1, ...)."""
    out = np.arange(capacity, capacity + cap, dtype=np.int64)
    out[:len(slots)] = slots
    return out.astype(np.int32)


def hash_slots(rev_ids: np.ndarray, hash_capacity: int) -> np.ndarray:
    """Byte-REVERSED uint64 ids -> int32 slots in [1, capacity)."""
    cap = np.uint64(hash_capacity - 1)
    return (np.asarray(rev_ids, FEAID_DTYPE) % cap
            + np.uint64(1)).astype(np.int32)


class SlotStore:
    """A hashed slot table on one device.

    ``read_only`` stores serve inference: :meth:`load` defaults to a
    weights-only view that never materializes optimizer state."""

    def __init__(self, param: SGDUpdaterParam, device="cuda",
                 read_only: bool = False):
        if param.hash_capacity <= 0:
            raise NotImplementedError(
                "the dictionary (exact-id) store is not ported yet; set "
                "hash_capacity > 0 (ROADMAP.md, Queue 1: dictionary store)")
        if not read_only:
            for knob in ("cold_tier_rows", "admit_min_count",
                         "evict_occupancy"):
                if getattr(param, knob):
                    raise NotImplementedError(
                        f"{knob}: the capacity tier (cold tier, admission, "
                        "eviction) is not ported yet (ROADMAP.md, Queue 1: "
                        "capacity tier)")
        self.param = param
        self.device = resolve_device(device)
        self.read_only = read_only
        self.fns = make_fns(param)
        self.state: SGDState = init_state(param, param.hash_capacity,
                                          self.device)

    def map_keys(self, keys: np.ndarray, insert: bool = True) -> np.ndarray:
        """Unique byte-reversed uint64 ids -> int32 slots (the hashed rule
        never inserts, so ``insert`` changes nothing)."""
        return hash_slots(np.asarray(keys, dtype=FEAID_DTYPE),
                          self.param.hash_capacity)

    def pad_slots(self, slots: np.ndarray, cap: int) -> torch.Tensor:
        """Sorted unique slots padded to ``cap`` with ascending
        out-of-bounds lanes, on the store's device."""
        return torch.from_numpy(pad_slots_oob(
            slots, cap, self.state.capacity)).to(self.device)

    def evaluate_dev(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(penalty, nnz) as device scalars (Evaluate,
        sgd_updater.cc:15-32); callers fetch them with other metrics."""
        return self.fns.evaluate(self.state)

    def evaluate(self) -> Tuple[float, float]:
        penalty, nnz = self.evaluate_dev()
        return float(penalty), float(nnz)

    # ------------------------------------------------------------- ckpt
    def _state_np(self, keys: Tuple[str, ...]) -> dict:
        """Host numpy view of the LOGICAL columns ``keys`` (V/Vg stripped
        of pad and scalar lanes, dequantized for 8-bit rows, f32)."""
        p, st = self.param, self.state
        w, z, sg, cnt, live = scal_cols(p, st)
        cols = {"w": w, "z": z, "sqrt_g": sg, "cnt": cnt, "v_live": live}
        if "V" in keys or "Vg" in keys:
            if p.V_dim == 0:
                cols["V"] = cols["Vg"] = st.VVg
            elif quantized(p):
                cols["V"], cols["Vg"] = emb_cols_f32(p, st)
            else:
                k, h, _, _ = row_layout(p, st.capacity)
                cols["V"], cols["Vg"] = st.VVg[:, :k], st.VVg[:, h:h + k]
        out = {f: cols[f].cpu() for f in keys}
        for f in ("V", "Vg"):
            if f in out:
                out[f] = out[f].to(torch.float32)
        return {f: a.numpy() for f, a in out.items()}

    def save(self, path: str, save_aux: bool = False) -> int:
        """Checkpoint the dense hashed table as one uncompressed npz plus
        its manifest sidecar (monotonic generation, written after the
        npz). Returns the count of non-zero w."""
        saved = ("w", "cnt", "v_live", "V") + (
            ("z", "sqrt_g", "Vg") if save_aux else ())
        st = self._state_np(saved)
        arrays = dict(hash_capacity=np.array(self.param.hash_capacity),
                      V_dim=np.array(self.param.V_dim),
                      save_aux=np.array(save_aux),
                      learner=np.array("sgd"),
                      slot_dtype=np.array(self.param.slot_dtype),
                      cold_tier_rows=np.array(self.param.cold_tier_rows),
                      **{k: st[k] for k in saved})
        n = int((st["w"] != 0).sum())
        man = {"learner": "sgd", "rows": n, "save_aux": bool(save_aux),
               "generation": mft.next_generation(path)}
        stream.save_npz(path, manifest=man, **arrays)
        return n

    def load(self, path: str, weights_only: Optional[bool] = None) -> int:
        """Restore a hashed checkpoint (the counterpart of the JAX store's
        hashed ``load`` + ``_assemble_state``). ``weights_only`` (default:
        the read_only flag) reads just w / cnt / v_live / V; absent
        columns are zero. Members are digested as they load, and a
        corrupt file raises ``manifest.CheckpointCorrupt`` before any
        state commits. Returns the count of non-zero w."""
        if weights_only is None:
            weights_only = self.read_only
        loaded = ("w", "cnt", "v_live", "V") + (
            () if weights_only else ("z", "sqrt_g", "Vg"))
        cap, k = self.param.hash_capacity, self.param.V_dim
        with mft.open_verified(path) as z:
            if "hash_capacity" not in z.files:
                raise ValueError(
                    "checkpoint store mode mismatch: checkpoint is a "
                    "dictionary model, store is hashed")
            if int(z["hash_capacity"]) != cap:
                raise ValueError("hashed checkpoint needs a store with the "
                                 "same hash_capacity")
            ck_vdim = int(z["V_dim"]) if "V_dim" in z.files else 0
            if ck_vdim != k:
                raise ValueError(f"checkpoint V_dim={ck_vdim} != configured "
                                 f"V_dim={k} ({path})")
            if "fs_count" in z.files and "w" not in z.files:
                raise NotImplementedError(
                    f"{path} is a per-key-range sharded checkpoint stub; "
                    "sharded loads are not ported yet (ROADMAP.md, "
                    "Queue 1: sharding)")
            arr = {key: z[key] for key in loaded if key in z.files}
            z.finish()  # digest sweep BEFORE the state commits
        for key, a in arr.items():
            if np.shape(a)[0] != cap:
                raise ValueError(f"checkpoint array {key!r} has "
                                 f"{np.shape(a)[0]} rows, the table {cap}")
        arr.setdefault("w", np.zeros(cap, np.float32))
        self.state = state_from_numpy(self.param, arr, self.device)
        return int((np.asarray(arr["w"]) != 0).sum())
