"""Slot store over a device slot table (counterpart of
difacto_tpu/store/local.py): the hashed store and the exact-id
dictionary store.

The model lives in device tensors (:class:`SGDState`); the host keeps
only the slot-assignment rule:

- hashed (``hash_capacity > 0``): byte-reversed feature ids map to
  ``rev_id mod (capacity - 1) + 1`` (row 0 stays the trash slot), no
  dictionary, a fixed capacity;
- dictionary (``hash_capacity == 0``, the JAX package's default): the
  sorted parallel arrays ``_keys``/``_slots`` map each id to its own
  slot, assigned in insertion order from 1; a lookup inserts unknown ids
  (read-only stores map them to the trash slot instead), and the table
  doubles from ``init_capacity`` whenever the next slot would not fit.
  New rows come from the store's init provider, ``init(capacity) ->
  SGDState``: by default ``init_state`` (V drawn from a torch generator
  seeded with ``param.seed`` over the whole capacity, so a row's initial
  V depends on the seed and the capacity only); parity tests give it the
  JAX package's init table, which torch cannot draw.

Checkpoints are the JAX package's npz + manifest format in both
directions: a hashed save writes the full dense logical table (w, cnt,
v_live, V and, with aux, z, sqrt_g, Vg as f32 arrays) plus geometry
stamps; a dictionary save writes the sorted ``keys`` with the rows of
the entries that are non-empty (w, cnt or a live embedding), and a load
gives them slots 1..n. Loads rebuild the fused rows through
``build_rows`` (requantizing when the stamp says int8/fp8). ``dump``
writes the readable TSV of ``task=dump``.

A trainable store (``read_only=False``) carries the optimizer state in
its fused rows and saves it with ``save_aux``; the learner pushes through
``store.fns`` (updaters/sgd_updater.make_fns) in place on ``state.VVg``.

Not ported yet, and raising a typed NotImplementedError that names the
ROADMAP.md queue item: per-key-range sharded checkpoints, the host-RAM
cold tier, count-min admission and occupancy eviction.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..base import FEAID_DTYPE, reverse_bytes
from ..updaters.sgd_updater import (TRASH_SLOT, SGDState, SGDUpdaterParam,
                                    grow_state, init_state, make_fns)
from ..utils import manifest as mft
from ..utils import stream
from ..utils.platform import resolve_device
from .convert import state_from_numpy, state_to_numpy
from .slots import hash_slots, pad_slots_oob  # noqa: F401


class SlotStore:
    """A hashed or dictionary slot table on one device.

    ``read_only`` stores serve inference: lookups never insert, and
    :meth:`load` defaults to a weights-only view that never materializes
    optimizer state. ``init`` overrides the init provider (see the module
    docstring)."""

    def __init__(self, param: SGDUpdaterParam, device="cuda",
                 read_only: bool = False,
                 init: Optional[Callable[[int], SGDState]] = None):
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
        self.hashed = param.hash_capacity > 0
        self._init = init if init is not None else (
            lambda capacity: init_state(param, capacity, self.device))
        self._keys = np.empty(0, dtype=FEAID_DTYPE)
        self._slots = np.empty(0, dtype=np.int64)
        self._next_slot = TRASH_SLOT + 1
        self.state: SGDState = self._init(
            param.hash_capacity if self.hashed else param.init_capacity)

    # ------------------------------------------------------------- keys
    @property
    def num_features(self) -> int:
        return len(self._keys)

    def map_keys(self, keys: np.ndarray, insert: bool = True) -> np.ndarray:
        """Unique byte-reversed uint64 ids -> int32 slots. Hashed: the
        modular rule. Dictionary: known ids get their slot; unknown ids
        are inserted with the next slots in input order (the reference's
        operator[] inserts on Get, sgd_updater.cc:46), growing the table
        as needed, or map to TRASH_SLOT when ``insert`` is off or the
        store is read-only."""
        keys = np.asarray(keys, dtype=FEAID_DTYPE)
        if self.hashed:
            return hash_slots(keys, self.param.hash_capacity)
        insert = insert and not self.read_only
        n = len(self._keys)
        out = np.full(len(keys), TRASH_SLOT, dtype=np.int32)
        if n:
            idx = np.searchsorted(self._keys, keys)
            safe = np.minimum(idx, n - 1)
            hit = (idx < n) & (self._keys[safe] == keys)
            out[hit] = self._slots[idx[hit]]
        else:
            hit = np.zeros(len(keys), dtype=bool)
        if insert:
            miss = ~hit
            n_new = int(miss.sum())
            if n_new:
                new_keys = keys[miss]
                new_slots = self._next_slot + np.arange(n_new, dtype=np.int64)
                out[miss] = new_slots.astype(np.int32)
                self._next_slot += n_new
                order = np.argsort(new_keys, kind="stable")
                nk, ns = new_keys[order], new_slots[order]
                pos = np.searchsorted(self._keys, nk)
                self._keys = np.insert(self._keys, pos, nk)
                self._slots = np.insert(self._slots, pos, ns)
                self._ensure_capacity(self._next_slot)
        return out

    def map_keys_dedup(self, keys: np.ndarray,
                       counts: Optional[np.ndarray] = None):
        """:meth:`map_keys` -> ``(slots, remap, counts)`` with ``slots``
        sorted unique, as the kernels take them. ``remap`` is None when
        the mapped slots already ascend, else ``remap[i]`` is the new
        position of input key ``i`` (the caller rewrites its localized
        indices through it); hashed ids that collide merge, and their
        ``counts`` add up."""
        slots = self.map_keys(keys)
        n = len(slots)
        if n > 1 and (slots[1:] <= slots[:-1]).any():
            uniq, inv = np.unique(slots, return_inverse=True)
            if counts is not None:
                counts = np.bincount(
                    inv, weights=counts, minlength=len(uniq)
                ).astype(np.float32)
            return uniq.astype(np.int32), inv, counts
        return slots, None, counts

    def capacity_for(self, need: int) -> int:
        """The capacity after doubling the live one until ``need`` slots
        fit."""
        cap = self.state.capacity
        while cap < need:
            cap *= 2
        return cap

    def _ensure_capacity(self, need: int) -> None:
        self.grow_to(self.capacity_for(need))

    def grow_to(self, capacity: int) -> None:
        """Grow the table to ``capacity`` rows (updaters/sgd_updater
        ``grow_state``); no-op when it is already that large."""
        if capacity > self.state.capacity:
            self.state = grow_state(self.param, self.state, capacity,
                                    self._init)

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

    def _state_np(self, keys) -> dict:
        """Host numpy view of the live table's logical columns ``keys``
        (store/convert.state_to_numpy)."""
        return state_to_numpy(self.param, self.state, keys)

    def save(self, path: str, save_aux: bool = False,
             epoch: Optional[int] = None) -> int:
        """Checkpoint as one uncompressed npz plus its manifest sidecar
        (monotonic generation, written after the npz; ``epoch`` stamps an
        interval checkpoint): the dense hashed table, or the dictionary's
        sorted keys with their non-empty rows. Returns the count of
        non-zero w (hashed) or of saved keys."""
        saved = ("w", "cnt", "v_live", "V") + (
            ("z", "sqrt_g", "Vg") if save_aux else ())
        st = self._state_np(saved)
        if self.hashed:
            arrays = dict(hash_capacity=np.array(self.param.hash_capacity),
                          V_dim=np.array(self.param.V_dim),
                          save_aux=np.array(save_aux),
                          learner=np.array("sgd"),
                          slot_dtype=np.array(self.param.slot_dtype),
                          cold_tier_rows=np.array(self.param.cold_tier_rows),
                          **{k: st[k] for k in saved})
            n = int((st["w"] != 0).sum())
        else:
            keys, slots = self._keys, self._slots
            live = (st["w"][slots] != 0) | (st["cnt"][slots] != 0)
            if self.param.V_dim > 0:
                live |= st["v_live"][slots]
            keys, slots = keys[live], slots[live]
            arrays = dict(keys=keys, w=st["w"][slots], cnt=st["cnt"][slots],
                          v_live=st["v_live"][slots], V=st["V"][slots],
                          save_aux=np.array(save_aux),
                          V_dim=np.array(self.param.V_dim),
                          learner=np.array("sgd"),
                          slot_dtype=np.array(self.param.slot_dtype))
            if save_aux:
                arrays.update(z=st["z"][slots], sqrt_g=st["sqrt_g"][slots],
                              Vg=st["Vg"][slots])
            n = len(keys)
        man = {"learner": "sgd", "rows": n, "save_aux": bool(save_aux),
               "generation": mft.next_generation(path)}
        if epoch is not None:
            man["epoch"] = int(epoch)
        stream.save_npz(path, manifest=man, **arrays)
        return n

    def load(self, path: str, weights_only: Optional[bool] = None,
             require_manifest: bool = False) -> int:
        """Restore a checkpoint (the counterpart of the JAX store's
        ``load`` + ``_assemble_state``). ``weights_only`` (default: the
        read_only flag) reads just w / cnt / v_live / V; the optimizer
        columns are zero. A dictionary checkpoint's keys take slots 1..n
        of a fresh table from the init provider, at the live capacity
        doubled until n + 1 rows fit. Members are digested as they load,
        and a corrupt file raises ``manifest.CheckpointCorrupt`` before
        any state commits; so does a missing manifest with
        ``require_manifest`` (a torn interval checkpoint). Returns the
        count of non-zero w (hashed) or of loaded keys."""
        if weights_only is None:
            weights_only = self.read_only
        loaded = ("w", "cnt", "v_live", "V") + (
            () if weights_only else ("z", "sqrt_g", "Vg"))
        k = self.param.V_dim
        with mft.open_verified(path,
                               require_manifest=require_manifest) as z:
            if self.hashed != ("hash_capacity" in z.files):
                raise ValueError(
                    "checkpoint store mode mismatch: checkpoint is "
                    f"{'a dictionary model' if self.hashed else 'hashed'},"
                    f" store is {'hashed' if self.hashed else 'dictionary'}")
            if self.hashed and int(z["hash_capacity"]) \
                    != self.param.hash_capacity:
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
            arr = {key: z[key] for key in loaded + ("keys",)
                   if key in z.files}
            z.finish()  # digest sweep BEFORE the state commits
        if self.hashed:
            cap = self.param.hash_capacity
            for key, a in arr.items():
                if np.shape(a)[0] != cap:
                    raise ValueError(f"checkpoint array {key!r} has "
                                     f"{np.shape(a)[0]} rows, the table "
                                     f"{cap}")
            arr.setdefault("w", np.zeros(cap, np.float32))
            self.state = state_from_numpy(self.param, arr, self.device)
            return int((np.asarray(arr["w"]) != 0).sum())
        keys = np.asarray(arr["keys"], dtype=FEAID_DTYPE)
        n = len(keys)
        self.state = state_from_numpy(self.param, arr, self.device,
                                      init=self._init,
                                      min_capacity=self.state.capacity)
        self._keys = keys
        self._slots = np.arange(1, n + 1, dtype=np.int64)
        self._next_slot = n + 1
        return n

    def dump(self, path: str, dump_aux: bool = False,
             need_reverse: bool = True) -> int:
        """Human-readable TSV (Updater::Dump, sgd_updater.h:108-139), the
        JAX store's ``dump`` byte for byte: ``feaid size w [sqrt_g z]
        V... [Vg...]`` per non-empty entry (w != 0 or a live embedding),
        each value ``repr`` of the f32 read as a float64; 8-bit and bf16
        tables dump their dequantized values. ``need_reverse`` un-reverses
        a dictionary's ids back to the original space; the hashed store
        has no ids, so its first column is the slot and ``need_reverse``
        is ignored. The table comes to the host once. Returns the count
        of lines."""
        k = self.param.V_dim
        st = self._state_np(("w", "v_live", "V") + (
            ("sqrt_g", "z", "Vg") if dump_aux else ()))
        if self.hashed:
            keep = st["w"] != 0
            if k > 0:
                keep |= st["v_live"]
            keep[TRASH_SLOT] = False
            slots = np.nonzero(keep)[0]
            keys = slots.astype(FEAID_DTYPE)
        else:
            keys, slots = self._keys, self._slots
            keep = st["w"][slots] != 0
            if k > 0:
                keep |= st["v_live"][slots]
            keys, slots = keys[keep], slots[keep]
            if need_reverse:
                keys = reverse_bytes(keys)
        live = (st["v_live"][slots] if k > 0
                else np.zeros(len(slots), dtype=bool)).tolist()

        def col(name):
            return st[name][slots].astype(np.float64).tolist()

        w = col("w")
        aux = list(zip(col("sqrt_g"), col("z"))) if dump_aux else None
        V = col("V") if k > 0 else None
        Vg = col("Vg") if k > 0 and dump_aux else None
        with stream.open_stream(path, "w") as f:
            for i, key in enumerate(keys.tolist()):
                cols = [str(key), str(1 + k if live[i] else 1), repr(w[i])]
                if dump_aux:
                    cols += [repr(aux[i][0]), repr(aux[i][1])]
                if live[i]:
                    cols += map(repr, V[i])
                    if dump_aux:
                        cols += map(repr, Vg[i])
                f.write("\t".join(cols) + "\n")
        return len(slots)
