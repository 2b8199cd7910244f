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
:meth:`pull`/:meth:`push` are the reference-shaped KV API over the same
functions.

The capacity levers (capacity/): with ``cold_tier_rows`` the device table
holds ``D = hash_capacity - cold_tier_rows`` hot rows and a
:class:`~difacto_tpu_torch.capacity.tier.ColdTier` keeps the rest in host
RAM; saves and dumps still write the logical table, and a load splits it
into the hot prefix and the host tail. ``evict_occupancy`` demotes (under
a tier) or resets the lowest-count rows at epoch ends
(:meth:`maybe_evict`). The write-ahead log's row surgery
(:meth:`wal_touched_rows`, :meth:`apply_wal_rows`) moves rows through the
same gather and scatter kernels.

Under a ``(dp, fs)`` mesh (parallel/mesh.py, ``mesh=``) the table is cut
into ``fs`` contiguous key-range shards: with ``fs > 1`` the state is a
parallel.sharded.ShardedState whose shard ``f`` holds rows ``[f * C/fs,
(f + 1) * C/fs)`` of every leaf in allocations of its own on the mesh's
``devices[0][f]``, and no tensor holds the whole table. Its rows are
made there (updaters/sgd_updater.init_rows, or the slices of a given
init provider's table), a doubling moves rows between shards
(``grow_sharded``), the batch's pulls and pushes run one kernel launch
per shard run on the shard's device (parallel/sharded.py) on the slots
:meth:`shard_slots` routes, and evaluation sums the shards' partials in
shard order. ``save`` then writes per-key-range members
``<path>_fs-<i>-of-<n>`` (each from its shard) and the array-free stub
last; a load of ``fs`` members fills each shard from its member, and any
other layout loads into any ``fs``, as the JAX store does. The
per-device figures of :meth:`capacity_stats` are read from the shards'
allocations. The cold tier and the write-ahead log refuse a mesh with
the JAX package's errors.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..base import FEAID_DTYPE, reverse_bytes
from ..updaters.sgd_updater import (TRASH_SLOT, SGDState, SGDUpdaterParam,
                                    grow_sharded, grow_state, init_rows,
                                    init_state, make_fns)
from ..utils import manifest as mft
from ..utils import stream
from ..utils.platform import resolve_device
from .convert import (fs_shard_path, read_shard_member,
                      read_sharded_columns, state_from_numpy,
                      state_to_numpy)
from .slots import hash_slots, pad_slots_oob  # noqa: F401

# the KV API's value-type channels (include/difacto/store.h:33-35)
K_FEACOUNT = 1
K_WEIGHT = 2
K_GRADIENT = 3


def collision_stats(ids: np.ndarray, hash_capacity: int) -> dict:
    """Hashed-store collision accounting for a set of distinct feature ids
    (the JAX store's ``collision_stats``, the same keys): the reference's
    distributed SGD keys the model by exact 64-bit id, so no two features
    alias; the hashed store trades that for a fixed capacity.
    ``collided_frac`` is the fraction of distinct ids that share their slot
    with at least one other id (their gradients merge for good);
    tools/collision_study.py measures what that costs in AUC."""
    ids = np.unique(np.asarray(ids, dtype=FEAID_DTYPE))
    slots = hash_slots(reverse_bytes(ids), hash_capacity)
    n = len(ids)
    # O(n): a bincount over the table would allocate O(hash_capacity)
    _, occ = np.unique(slots, return_counts=True)
    collided = n - int((occ == 1).sum())
    return {
        "n_ids": n,
        "hash_capacity": hash_capacity,
        "load_factor": round(n / max(hash_capacity - 1, 1), 4),
        "slots_used": len(occ),
        "collided_frac": round(collided / max(n, 1), 4),
    }


class SlotStore:
    """A hashed or dictionary slot table on one device.

    ``read_only`` stores serve inference: lookups never insert, and
    :meth:`load` defaults to a weights-only view that never materializes
    optimizer state. ``init`` overrides the init provider (see the module
    docstring), ``virgin_V`` the cold tier's virgin V [cold_tier_rows,
    V_dim] (capacity/tier.virgin_V). A read-only store ignores
    ``cold_tier_rows``: serving holds the whole table. ``mesh`` (a
    parallel.mesh.Mesh) shards the table over its ``fs`` axis; the store
    then lives on the mesh's home device."""

    def __init__(self, param: SGDUpdaterParam, device="cuda",
                 read_only: bool = False,
                 init: Optional[Callable[[int], SGDState]] = None,
                 virgin_V: Optional[np.ndarray] = None, mesh=None):
        self.param = param
        self.mesh = mesh
        self.device = mesh.home if mesh is not None \
            else resolve_device(device)
        self.read_only = read_only
        self.fns = make_fns(param, mesh)
        self.hashed = param.hash_capacity > 0
        self._provider = init
        self._init = init if init is not None else (
            lambda capacity: init_state(param, capacity, self.device))
        self._keys = np.empty(0, dtype=FEAID_DTYPE)
        self._slots = np.empty(0, dtype=np.int64)
        self._next_slot = TRASH_SLOT + 1
        cap = param.hash_capacity if self.hashed else param.init_capacity
        tiered = param.cold_tier_rows > 0 and not read_only
        if tiered:
            if not self.hashed:
                raise ValueError("cold_tier_rows requires the hashed "
                                 "store (hash_capacity > 0): dictionary "
                                 "slots have no fixed logical space to "
                                 "tier over")
            if param.V_dim == 0:
                raise ValueError("cold_tier_rows requires V_dim > 0: the "
                                 "tier moves fused rows, the flat layout "
                                 "has none")
            if mesh is not None:
                raise ValueError("cold_tier_rows is single-device only: "
                                 "tier routing runs on the dispatch "
                                 "thread against an unsharded table (use "
                                 "mesh_fs for sharded capacity, or "
                                 "combine fs with slot_dtype)")
            if param.cold_tier_rows >= cap - 1:
                raise ValueError(
                    f"cold_tier_rows={param.cold_tier_rows} must leave at "
                    f"least 2 hot rows of hash_capacity={cap} (trash row "
                    "+ one working row)")
            cap -= param.cold_tier_rows
        if self.fs_count > 1:
            # fail at construction with the knob to fix; doubling growth
            # keeps the capacity divisible (grow_to checks again)
            from ..parallel import validate_fs_capacity
            validate_fs_capacity(cap, self.fs_count)
        self.state = self._fresh(cap)
        self.tier = None
        if tiered:
            from ..capacity.tier import ColdTier
            self.tier = ColdTier(self, virgin_V)

    # ------------------------------------------------------------ shards
    @property
    def fs_count(self) -> int:
        """Feature-shard degree: the contiguous key-range shards the
        table's capacity axis splits into (1 without a mesh)."""
        from ..parallel import fs_size
        return fs_size(self.mesh)

    @property
    def shard_devices(self) -> list:
        """The device of each key-range shard, in shard order (the one
        device without a mesh)."""
        return [self.device] if self.mesh is None \
            else self.mesh.shard_devices

    def shard_slots(self, slots: torch.Tensor, host_slots: np.ndarray,
                    capacity: int):
        """The slot argument of ``self.fns`` for a batch: ``slots`` itself
        without a mesh; under one, a parallel.sharded.ShardedSlots routed
        on the host copy ``host_slots`` over a ``capacity``-row table (the
        one the batch was padded for), each shard's local slots on its
        device."""
        if self.mesh is None:
            return slots
        from ..parallel import sharded
        return sharded.route(slots, host_slots, capacity, self.fs_count,
                             self.shard_devices)

    def _fresh_rows(self, capacity: int, lo: int, hi: int,
                    device: torch.device, memo: Optional[dict] = None
                    ) -> SGDState:
        """Rows ``[lo, hi)`` of a fresh ``capacity``-row table on
        ``device``: drawn there (updaters/sgd_updater.init_rows), or cut
        from the init provider's table (``memo`` keeps one per
        capacity)."""
        if self._provider is None:
            return init_rows(self.param, capacity, lo, hi, device)
        from ..parallel.mesh import device_copy
        memo = {} if memo is None else memo
        if capacity not in memo:
            memo[capacity] = self._provider(capacity)
        return SGDState(*(device_copy(t[lo:hi], device)
                          for t in memo[capacity]))

    def _fresh(self, capacity: int):
        """A fresh table of ``capacity`` rows: the init provider's, or
        under ``fs > 1`` a ShardedState whose every shard's rows are made
        on its device."""
        if self.fs_count == 1:
            return self._init(capacity)
        from ..parallel import fs_shard_bounds
        from ..parallel.sharded import ShardedState
        memo: dict = {}
        return ShardedState([
            self._fresh_rows(capacity, lo, hi, dev, memo)
            for (lo, hi), dev in zip(fs_shard_bounds(capacity,
                                                     self.fs_count),
                                     self.shard_devices)])

    # ------------------------------------------------------------- keys
    @property
    def num_features(self) -> int:
        return len(self._keys)

    @property
    def next_slot(self) -> int:
        """The slot the next inserted id takes (dictionary store)."""
        return self._next_slot

    def map_keys(self, keys: np.ndarray, insert: bool = True,
                 grow: bool = True) -> np.ndarray:
        """Unique byte-reversed uint64 ids -> int32 slots. Hashed: the
        modular rule. Dictionary: known ids get their slot; unknown ids
        are inserted with the next slots in input order (the reference's
        operator[] inserts on Get, sgd_updater.cc:46), growing the table
        as needed, or map to TRASH_SLOT when ``insert`` is off or the
        store is read-only. ``grow=False`` inserts without growing the
        table: the multi-host schedule's lookahead thread inserts, and the
        dispatch thread grows (:meth:`grow_to`) before the first step
        that needs the rows."""
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
                if grow:
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

    def capacity_for(self, need: int, current: Optional[int] = None) -> int:
        """The capacity after doubling the live one (or ``current``) until
        ``need`` slots fit."""
        cap = self.state.capacity if current is None else current
        while cap < need:
            cap *= 2
        return cap

    def _ensure_capacity(self, need: int) -> None:
        self.grow_to(self.capacity_for(need))

    def grow_to(self, capacity: int) -> None:
        """Grow the table to ``capacity`` rows (updaters/sgd_updater
        ``grow_state``); no-op when it is already that large."""
        if capacity > self.state.capacity:
            if self.fs_count > 1:
                from ..parallel import validate_fs_capacity
                validate_fs_capacity(capacity, self.fs_count)
                memo: dict = {}
                self.state = grow_sharded(
                    self.param, self.state, capacity,
                    lambda c, lo, hi, dev: self._fresh_rows(c, lo, hi, dev,
                                                            memo))
                return
            self.state = grow_state(self.param, self.state, capacity,
                                    self._init)

    def pad_slots(self, slots: np.ndarray, cap: int) -> torch.Tensor:
        """Sorted unique slots padded to ``cap`` with ascending
        out-of-bounds lanes, on the store's device."""
        return torch.from_numpy(pad_slots_oob(
            slots, cap, self.state.capacity)).to(self.device)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Slots for known ids, TRASH_SLOT for unknown (no insertion)."""
        return self.map_keys(keys, insert=False)

    # ------------------------------------------------------------ KV API
    def pull(self, keys: np.ndarray):
        """(w, V, vmask) host rows in the caller's key order (Pull): the
        keys' sorted-unique slots, routed through the cold tier when it is
        on (promoting cold rows), gathered once."""
        slots_np, remap, _ = self.map_keys_dedup(keys)
        perm = None
        if self.tier is not None:
            slots_np, _, perm = self.tier.route(slots_np)
        slots_np = np.ascontiguousarray(slots_np, dtype=np.int32)
        w, V, vmask = self.fns.get_rows(self.state, self.shard_slots(
            torch.from_numpy(slots_np).to(self.device), slots_np,
            self.state.capacity))
        # a bf16 table's V leaves as f32: numpy has no bfloat16
        out = [None if a is None else a.cpu().to(
            torch.float32 if a.dtype == torch.bfloat16 else a.dtype).numpy()
            for a in (w, V, vmask)]
        for idx in (perm, remap):
            if idx is not None:
                out = [None if a is None else a[idx] for a in out]
        return tuple(out)

    def push(self, keys: np.ndarray, val_type: int, gw: np.ndarray,
             gV: Optional[np.ndarray] = None,
             vmask: Optional[np.ndarray] = None) -> None:
        """Push (kFeaCount counts or kGradient gradients) for ``keys``:
        colliding hashed keys add up; under the cold tier the slots route
        to device rows and the values follow them (a slot whose promote
        was refused lands on an OOB lane and its update is dropped)."""
        if self.read_only:
            raise RuntimeError(
                "push on a read-only store: this SlotStore was opened "
                "weights-only for inference (serve/task=pred) and carries "
                "no optimizer state to update")
        slots_np, remap, _ = self.map_keys_dedup(keys)
        if remap is not None:
            n = len(slots_np)
            gw = np.bincount(remap, weights=np.asarray(gw, np.float64),
                             minlength=n).astype(np.float32)
            if gV is not None:
                agg = np.zeros((n,) + np.asarray(gV).shape[1:],
                               dtype=np.float32)
                np.add.at(agg, remap, np.asarray(gV))
                gV = agg
            if vmask is not None:
                vm = np.zeros(n, dtype=np.float32)
                np.maximum.at(vm, remap, np.asarray(vmask, np.float32))
                vmask = vm
        if self.tier is not None:
            slots_np, order, _ = self.tier.route(slots_np)
            gw = np.asarray(gw)[order]
            gV = None if gV is None else np.asarray(gV)[order]
            vmask = None if vmask is None else np.asarray(vmask)[order]

        def dev(a, dtype=torch.float32):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(self.device, dtype)

        slots_np = np.ascontiguousarray(slots_np, dtype=np.int32)
        slots = self.shard_slots(dev(slots_np, torch.int32), slots_np,
                                 self.state.capacity)
        if val_type == K_FEACOUNT:
            self.state = self.fns.apply_count(self.state, slots, dev(gw))
        elif val_type == K_GRADIENT:
            self.state = self.fns.apply_grad(self.state, slots, dev(gw),
                                             dev(gV), dev(vmask))
        else:
            raise ValueError(f"unknown val_type {val_type}")

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

    def _logical_np(self, keys) -> dict:
        """:meth:`_state_np` over the LOGICAL slot space: the device view
        for an untiered store; under the cold tier the [D]-row columns
        expand to [hash_capacity] rows (capacity/tier.logical_cols), so
        saves and dumps never depend on the residency at save time."""
        st = self._state_np(keys)
        if self.tier is not None:
            st = self.tier.logical_cols(st)
        return st

    # ------------------------------------------------------ capacity
    def maybe_evict(self) -> int:
        """Occupancy eviction (``evict_occupancy``): when the occupied
        share of device rows exceeds the threshold, evict the lowest-count
        occupied rows until occupancy is 0.9x the threshold. Under the
        cold tier they demote to host RAM and stay addressable; without it
        their FTRL/AdaGrad scalars reset to virgin (the V codes and scales
        stay, masked by live=False). Epoch boundaries only. Returns the
        rows evicted, counted into ``store_evictions_total``."""
        thr = self.param.evict_occupancy
        if thr <= 0:
            return 0
        st = self._state_np(("w", "cnt", "v_live"))
        occupied = (st["w"] != 0) | (st["cnt"] != 0)
        if self.param.V_dim > 0:
            occupied |= np.asarray(st["v_live"], bool)
        occupied[TRASH_SLOT] = False
        cap = self.state.capacity
        n_occ = int(occupied.sum())
        if n_occ / max(cap - 1, 1) <= thr:
            return 0
        target = int(0.9 * thr * (cap - 1))
        n_evict = n_occ - target
        rows = np.nonzero(occupied)[0]
        order = np.argsort(st["cnt"][rows], kind="stable")
        victims = np.sort(rows[order[:n_evict]])
        if self.tier is not None:
            n = self.tier.demote_rows(victims)
        else:
            n = self._reset_rows(victims)
        if n:
            from ..obs import REGISTRY
            REGISTRY.counter(
                "store_evictions_total",
                "table rows evicted under occupancy pressure "
                "(evict_occupancy)").inc(n)
        return n

    def _reset_rows(self, victims: np.ndarray) -> int:
        """Reset the scalars of the given sorted device rows to virgin
        (w = z = sqrt_g = cnt = 0, live False): the eviction without a
        tier. Fused rows take one gather and one scatter (the kernels on
        the card) with the V halves and the quant scales carried; under a
        mesh each shard resets its own rows on its device."""
        n = len(victims)
        if n == 0:
            return 0
        from ..parallel.sharded import shard_states
        for st, lo, hi in shard_states(self.state):
            v = victims[(victims >= lo) & (victims < hi)] - lo
            if len(v):
                self._reset_shard_rows(st, v, hi - lo)
        return n

    def _reset_shard_rows(self, st: SGDState, victims: np.ndarray,
                          n_rows: int) -> None:
        """:meth:`_reset_rows` of one ``n_rows``-row table (a shard, or
        the whole table), ``victims`` its local rows."""
        dev = st.VVg.device
        if self.param.V_dim == 0:
            vj = torch.from_numpy(victims.astype(np.int64)).to(dev)
            for col in (st.w, st.z, st.sqrt_g, st.cnt):
                col[vj] = 0.0
            st.v_live[vj] = False
            return
        from ..ops import fused
        from ..ops.batch import bucket
        from ..updaters.sgd_updater import pack_scal, row_layout, scal_f32
        _, _, _, off = row_layout(self.param, self.state.capacity)
        sl = torch.from_numpy(pad_slots_oob(
            victims.astype(np.int32), bucket(len(victims)), n_rows)).to(dev)
        rows = fused.gather_rows(st.VVg, sl)
        f = scal_f32(rows[:, off:])
        zero = torch.zeros(rows.shape[0], dtype=torch.float32,
                           device=dev)
        scal = pack_scal(zero, zero, zero, zero, zero.to(torch.bool),
                         rows.dtype, scale_V=f[:, 5], scale_Vg=f[:, 6])
        out = torch.cat([rows[:, :off], scal], dim=1)
        fused.scatter_rows(st.VVg, sl, out)

    def device_bytes(self) -> list:
        """Bytes each key-range shard's allocations hold on its device, in
        shard order (one entry without a mesh): read from the tensors."""
        from ..parallel.sharded import shard_states
        return [sum(t.numel() * t.element_size() for t in st)
                for st, _, _ in shard_states(self.state)]

    def capacity_stats(self) -> dict:
        """Effective-capacity accounting of the levers: logical rows
        against what an fp32, untiered table of the same device bytes
        would hold. Under a mesh each logical device holds one shard, so
        the per-device figures are the JAX store's ``total // fs`` and
        ``logical // fs``, read from the shards' allocations."""
        import dataclasses
        from ..updaters.sgd_updater import state_bytes
        dev_rows = self.state.capacity
        logical = self.param.hash_capacity if self.hashed else dev_rows
        bytes_total = state_bytes(self.param, dev_rows)
        base = dataclasses.replace(self.param, slot_dtype="fp32",
                                   V_dtype="float32", cold_tier_rows=0)
        base_bpr = state_bytes(base, dev_rows) / max(dev_rows, 1)
        baseline_rows = bytes_total / max(base_bpr, 1e-9)
        out = {
            "slot_dtype": self.param.slot_dtype,
            "logical_rows": logical,
            "device_rows": dev_rows,
            "table_bytes_per_device": max(self.device_bytes()),
            "effective_rows_per_device": logical // self.fs_count,
            "capacity_multiplier": round(logical / max(baseline_rows,
                                                       1e-9), 3),
        }
        if self.tier is not None:
            out["tier"] = self.tier.stats()
        return out

    def shard_stats(self) -> list:
        """Per-key-range shard occupancy: [{shard, row_lo, row_hi, rows,
        occupancy, table_bytes}] with ``rows`` the non-zero w of the
        shard's range and ``table_bytes`` the bytes of the shard's
        allocations on its device. Reads the w column to the host: cold
        paths only."""
        from ..parallel import fs_shard_bounds
        w = self._state_np(("w",))["w"]
        cap, fs = self.state.capacity, self.fs_count
        per_shard = self.device_bytes()
        out = []
        for i, (lo, hi) in enumerate(fs_shard_bounds(cap, fs)):
            rows = int((w[lo:hi] != 0).sum())
            out.append({"shard": i, "row_lo": lo, "row_hi": hi,
                        "rows": rows,
                        "occupancy": round(rows / max(hi - lo, 1), 6),
                        "table_bytes": per_shard[i]})
        return out

    def publish_shard_stats(self) -> list:
        """:meth:`shard_stats` into the global registry
        (``store_shard_rows`` / ``store_shard_occupancy`` gauges)."""
        from ..obs import gauge
        stats = self.shard_stats()
        rows_g = gauge("store_shard_rows",
                       "non-empty slot-table rows per fs key-range shard")
        occ_g = gauge("store_shard_occupancy",
                      "filled fraction of each fs key-range shard")
        for s in stats:
            rows_g.labels(shard=str(s["shard"])).set(s["rows"])
            occ_g.labels(shard=str(s["shard"])).set(s["occupancy"])
        return stats

    # --------------------------------------------------- WAL row surgery
    def wal_geometry(self) -> dict:
        """The geometry stamp every WAL segment carries and replay checks
        before applying (durability/wal.py)."""
        return {"hash_capacity": int(self.param.hash_capacity),
                "capacity": int(self.state.capacity),
                "V_dim": int(self.param.V_dim),
                "slot_dtype": self.param.slot_dtype,
                "row_width": int(self.state.VVg.shape[1])}

    def wal_touched_rows(self, slots: np.ndarray) -> dict:
        """Host copies of the given device rows exactly as the table
        stores them: the fused VVg container rows (a CPU tensor: bf16 has
        no numpy dtype) through the gather kernel for V_dim > 0, or the
        five flat columns (numpy) of the V_dim = 0 layout. The WAL's
        append-side read, once per flush window."""
        slots = np.asarray(slots, dtype=np.int32)
        n = len(slots)
        if n == 0:
            return {}
        st = self.state
        if self.param.V_dim == 0:
            sl = torch.from_numpy(slots.astype(np.int64)).to(self.device)
            return {k: getattr(st, k)[sl].cpu().numpy()
                    for k in ("w", "z", "sqrt_g", "cnt", "v_live")}
        from ..ops import fused
        from ..ops.batch import bucket
        rows = fused.gather_rows(st.VVg, self.pad_slots(slots, bucket(n)))
        return {"VVg": rows[:n].cpu()}

    def apply_wal_rows(self, slots: np.ndarray, arrays: dict) -> int:
        """Write replayed WAL rows back into the table, the inverse of
        :meth:`wal_touched_rows` bit for bit: the scatter kernel with its
        epilogue off for fused rows, index writes for the flat columns.
        Replay only (durability/recover.py), never beside a step."""
        slots = np.asarray(slots, dtype=np.int32)
        n = len(slots)
        if n == 0:
            return 0
        st = self.state
        if self.param.V_dim == 0:
            cols = ("w", "z", "sqrt_g", "cnt", "v_live")
            for k in cols:
                if len(arrays[k]) != n:
                    raise ValueError(
                        f"WAL column {k!r} has {len(arrays[k])} rows "
                        f"for {n} slots")
            sl = torch.from_numpy(slots.astype(np.int64)).to(self.device)
            for k in cols:
                col = getattr(st, k)
                col[sl] = torch.from_numpy(np.array(arrays[k])).to(
                    self.device, col.dtype)
            return n
        from ..ops import fused
        from ..ops.batch import bucket
        width = st.VVg.shape[1]
        rows = arrays["VVg"]
        if isinstance(rows, np.ndarray):   # a read view of a segment
            rows = torch.from_numpy(np.array(rows))
        if rows.dtype != st.VVg.dtype:
            raise ValueError(
                f"WAL rows are {rows.dtype} but the table stores "
                f"{st.VVg.dtype}: geometry mismatch")
        rows = rows.reshape(n, width)
        cap = bucket(n)
        full = torch.zeros((cap, width), dtype=rows.dtype)
        full[:n] = rows
        self.state = st._replace(VVg=fused.scatter_rows(
            st.VVg, self.pad_slots(slots, cap), full.to(self.device)))
        return n

    def save(self, path: str, save_aux: bool = False,
             epoch: Optional[int] = None,
             shards: Optional[int] = None) -> int:
        """Checkpoint as one uncompressed npz plus its manifest sidecar
        (monotonic generation, written after the npz; ``epoch`` stamps an
        interval checkpoint): the dense hashed table, or the dictionary's
        sorted keys with their non-empty rows. Returns the count of
        non-zero w (hashed) or of saved keys.

        ``shards`` (default: the mesh's fs degree) splits a HASHED table
        into per-key-range members ``<path>_fs-<i>-of-<n>``, each with its
        own manifest, and an array-free stub at ``<path>`` written LAST as
        the generation's commit marker (:meth:`_save_sharded`)."""
        saved = ("w", "cnt", "v_live", "V") + (
            ("z", "sqrt_g", "Vg") if save_aux else ())
        if shards is None:
            shards = self.fs_count if self.hashed else 1
        if self.hashed and shards > 1:
            return self._save_sharded(path, saved, save_aux, epoch, shards)
        st = self._logical_np(saved) if self.hashed \
            else self._state_np(saved)
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
        stream.save_npz(path, manifest=man, fault_point="ckpt.write",
                        **arrays)
        return n

    def _save_sharded(self, path: str, saved, save_aux: bool,
                      epoch: Optional[int], shards: int) -> int:
        """The JAX store's ``_save_sharded``: every member carries rows
        [lo, hi) of each column plus the geometry stamp (``fs_count``,
        ``row_lo``, ``row_hi``); the stub, written last, closes the
        generation, so a save torn between members leaves no stub
        manifest and reads as incomplete, never as half a table."""
        from ..parallel import fs_shard_bounds
        from ..parallel.sharded import ShardedState
        cap = self.param.hash_capacity
        bounds = fs_shard_bounds(cap, shards)
        if isinstance(self.state, ShardedState) and shards == self.fs_count:
            # each member from its own shard, one at a time on the host
            def member(i):
                return state_to_numpy(self.param, self.state.shards[i],
                                      saved, cap)
        else:
            st = self._logical_np(saved)

            def member(i):
                lo, hi = bounds[i]
                return {k: st[k][lo:hi] for k in saved}
        gen = mft.next_generation(path)
        n = 0
        geom = dict(hash_capacity=np.array(cap),
                    V_dim=np.array(self.param.V_dim),
                    save_aux=np.array(save_aux),
                    learner=np.array("sgd"),
                    slot_dtype=np.array(self.param.slot_dtype),
                    cold_tier_rows=np.array(self.param.cold_tier_rows),
                    fs_count=np.array(shards))
        for i, (lo, hi) in enumerate(bounds):
            cols = member(i)
            rows = int((cols["w"] != 0).sum())
            n += rows
            man = {"learner": "sgd", "rows": rows,
                   "save_aux": bool(save_aux), "generation": gen,
                   "fs_shard": i, "fs_count": shards}
            if epoch is not None:
                man["epoch"] = int(epoch)
            stream.save_npz(fs_shard_path(path, i, shards), manifest=man,
                            fault_point="ckpt.write", row_lo=np.array(lo),
                            row_hi=np.array(hi), **geom, **cols)
        man = {"learner": "sgd", "rows": n, "save_aux": bool(save_aux),
               "generation": gen, "fs_count": shards}
        if epoch is not None:
            man["epoch"] = int(epoch)
        stream.save_npz(path, manifest=man, fault_point="ckpt.write",
                        **geom)
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
        with mft.open_verified(path, require_manifest=require_manifest,
                               fault_point="ckpt.read") as z:
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
            sharded = "fs_count" in z.files and "w" not in z.files
            if sharded:
                fs_count = int(z["fs_count"])
                arr = {}
            else:
                arr = {key: z[key] for key in loaded + ("keys",)
                       if key in z.files}
            z.finish()  # digest sweep BEFORE the state commits
        if sharded and fs_count == self.fs_count > 1:
            # member i straight into shard i, on its device, each verified
            # before anything commits
            return self._load_members(path, loaded)
        if sharded:
            # per-key-range stub: the table lives in its members, each
            # verified before anything commits (store/convert.py)
            arr = read_sharded_columns(path, fs_count,
                                       self.param.hash_capacity, k, loaded,
                                       weights_only)
            self._commit_hashed(arr)
            return int((arr["w"] != 0).sum())
        if self.hashed:
            cap = self.param.hash_capacity
            for key, a in arr.items():
                if np.shape(a)[0] != cap:
                    raise ValueError(f"checkpoint array {key!r} has "
                                     f"{np.shape(a)[0]} rows, the table "
                                     f"{cap}")
            arr.setdefault("w", np.zeros(cap, np.float32))
            self._commit_hashed(arr)
            return int((np.asarray(arr["w"]) != 0).sum())
        keys = np.asarray(arr["keys"], dtype=FEAID_DTYPE)
        n = len(keys)
        if self.fs_count > 1:
            self.state = self._dict_shards(arr, n)
        else:
            self.state = state_from_numpy(self.param, arr, self.device,
                                          init=self._init,
                                          min_capacity=self.state.capacity)
        self._keys = keys
        self._slots = np.arange(1, n + 1, dtype=np.int64)
        self._next_slot = n + 1
        return n

    def _commit_hashed(self, arr: dict) -> None:
        """Commit loaded LOGICAL hashed-table columns [hash_capacity rows]:
        the whole table on the device, or under the cold tier its hot
        prefix [0, D) on the device and the tail into the host tier
        (capacity/tier.load_cold), so checkpoints cross tier settings both
        ways."""
        if self.fs_count > 1:
            self.state = self._placed(arr, self.param.hash_capacity)
            return
        if self.tier is None:
            self.state = state_from_numpy(self.param, arr, self.device)
            return
        D = self.tier.D
        self.state = state_from_numpy(
            self.param, {k: np.asarray(a)[:D] for k, a in arr.items()},
            self.device)
        cap, k = self.param.hash_capacity, self.param.V_dim
        full = {"z": np.zeros(cap, np.float32),
                "sqrt_g": np.zeros(cap, np.float32),
                "cnt": np.zeros(cap, np.float32),
                "v_live": np.zeros(cap, bool),
                "V": np.zeros((cap, k), np.float32),
                "Vg": np.zeros((cap, k), np.float32)}
        full.update(arr)
        self.tier.load_cold(full)

    def _placed(self, arr: dict, capacity: int):
        """A ShardedState of logical host columns ``[capacity]``: each
        shard's rows built on its device."""
        from ..parallel import fs_shard_bounds
        from ..parallel.sharded import ShardedState
        return ShardedState([
            state_from_numpy(self.param,
                             {f: np.asarray(a)[lo:hi]
                              for f, a in arr.items()},
                             dev, capacity=capacity)
            for (lo, hi), dev in zip(fs_shard_bounds(capacity,
                                                     self.fs_count),
                                     self.shard_devices)])

    def _load_members(self, path: str, loaded) -> int:
        """A per-key-range checkpoint of this store's ``fs``: member ``i``
        verified and built into shard ``i`` on its device, one member on
        the host at a time; the shards commit together."""
        from ..parallel.sharded import ShardedState
        cap = self.param.hash_capacity
        shards, n = [], 0
        for i, dev in enumerate(self.shard_devices):
            cols = read_shard_member(path, i, self.fs_count, cap, loaded)
            n += int((np.asarray(cols["w"]) != 0).sum()) if "w" in cols \
                else 0
            shards.append(state_from_numpy(self.param, cols, dev,
                                           capacity=cap))
        self.state = ShardedState(shards)
        return n

    def _dict_shards(self, arr: dict, n: int):
        """The sharded dictionary load: the capacity doubled from the live
        one until n + 1 rows fit, the keys' rows at slots 1..n and every
        other row a fresh table's, each shard built on its device (the
        round trip through the logical columns is the flat load's, so
        both give one table bit for bit)."""
        from ..parallel import fs_shard_bounds
        from ..parallel.sharded import ShardedState
        cap = self.capacity_for(n + 1)
        memo: dict = {}
        shards = []
        for (lo, hi), dev in zip(fs_shard_bounds(cap, self.fs_count),
                                 self.shard_devices):
            cols = {f: a.copy() for f, a in state_to_numpy(
                self.param, self._fresh_rows(cap, lo, hi, dev, memo),
                capacity=cap).items()}
            a, b = max(lo, 1), min(hi, n + 1)
            if a < b:
                for f, v in arr.items():
                    if f in cols and np.size(v):
                        cols[f][a - lo:b - lo] = np.asarray(v)[a - 1:b - 1]
            shards.append(state_from_numpy(self.param, cols, dev,
                                           capacity=cap))
        return ShardedState(shards)

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
        dumped = ("w", "v_live", "V") + (
            ("sqrt_g", "z", "Vg") if dump_aux else ())
        st = self._logical_np(dumped) if self.hashed \
            else self._state_np(dumped)
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
