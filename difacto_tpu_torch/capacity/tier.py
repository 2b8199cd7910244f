"""Host-RAM cold tier behind the device slot table (counterpart of
difacto_tpu/capacity/tier.py).

With ``cold_tier_rows = R > 0`` the hashed store's LOGICAL slot space
keeps its ``hash_capacity = L`` rows, but the device table holds only
``D = L - R`` hot rows; the tail lives in host RAM here, and rows move
between the two in batches on the dispatch thread:

- every batch's sorted-unique logical slots are ROUTED to device rows
  before the batch is copied to the device (:meth:`ColdTier.route`,
  :func:`route_payload`): a resident slot is a HIT; a miss PROMOTES the
  slot's row from host RAM (or its virgin init row) into a free device
  row, first demoting the least-recently-touched resident rows when the
  hot set is full. The routed row vector is sorted again and the
  payload's index cells are rewritten through the position permutation,
  so the table kernels' sorted-unique contract holds.
- a promote is one scatter (``ops/fused.scatter_rows``, the scatter kernel
  with its epilogue off on a CUDA table), a demote one gather
  (``ops/fused.gather_rows``, the gather kernel), each over an OOB-padded
  slot vector of an ``ops/batch.bucket`` length: the pad lanes ``D + j``
  gather zeros and are dropped by the scatter.
- fault points ``store.demote`` / ``store.promote`` (utils/faultinject): a
  refused demote keeps its victims hot and serving (this batch's misses
  degrade to the OOB lane and read zeros); a refused promote degrades
  only the missing slots. Neither tears the table.

The residency maps, the logical LRU clock and the host rows are numpy,
as in the JAX package, so the two can be compared array for array. Host
rows hold the device container's bits: float32, int16 for a bf16 table
(torch's bfloat16 has no numpy dtype) or int8.

The virgin V of the cold tail cannot be the JAX package's (a jax.random
draw): by default it is drawn from a ``torch.Generator`` seeded from
``param.seed`` in a stream distinct from the table's init
(:func:`virgin_V`); the store's ``virgin_V=`` argument injects another,
as the parity tests inject JAX's. Counters: ``store_tier_hits_total``,
``store_tier_misses_total``, ``store_tier_promotes_total``,
``store_tier_demotes_total``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..obs import REGISTRY
from ..ops import fused
from ..ops.batch import bucket
from ..store.slots import pad_slots_oob
from ..updaters.sgd_updater import (TRASH_SLOT, build_rows, quantized,
                                    row_layout, scal_f32, v_dtype)
from ..utils import faultinject
from ..utils.faultinject import FaultInjected

# the host numpy dtype that holds each container's bits
_HOST = {torch.float32: np.float32, torch.bfloat16: np.int16,
         torch.int8: np.int8}


def virgin_V(param, n: int) -> np.ndarray:
    """f32[n, V_dim]: the cold tail's virgin V, uniform in
    +-V_init_scale/2, from a CPU ``torch.Generator`` whose seed mixes
    ``param.seed`` with 1, so it never repeats the table init's stream
    (seeded with ``param.seed`` itself, updaters/sgd_updater.init_state)."""
    seed = (int(param.seed) * 0x9E3779B97F4A7C15 + 1) & ((1 << 63) - 1)
    gen = torch.Generator().manual_seed(seed)
    V = (torch.rand((n, param.V_dim), generator=gen, dtype=torch.float32)
         - 0.5) * param.V_init_scale
    return V.numpy()


class ColdTier:
    """Residency maps and host row storage for one SlotStore.

    Single-threaded: every method runs on the store's dispatch thread,
    between steps, the thread that owns ``store.state``."""

    def __init__(self, store, virgin: Optional[np.ndarray] = None) -> None:
        param = store.param
        self.store = store
        self.param = param
        self.L = param.hash_capacity
        self.D = self.L - param.cold_tier_rows
        self.layout = row_layout(param, self.D)
        self._dtype = v_dtype(param)
        self._np_dtype = np.dtype(_HOST[self._dtype])
        # residency: logical slot -> device row (-1 = cold); device row ->
        # owning slot (-1 = free). At init slots [0, D) are hot at row ==
        # slot and the tail [D, L) is cold.
        self._resident = np.full(self.L, -1, dtype=np.int64)
        self._resident[:self.D] = np.arange(self.D)
        self._owner = np.arange(self.D, dtype=np.int64)
        # logical LRU clock: one tick per routed batch
        self._clock = np.zeros(self.D, dtype=np.int64)
        self._tick = 0
        # demoted rows: logical slot -> the device row's container bits
        self._rows: dict = {}
        n_tail = self.L - self.D
        if virgin is None:
            virgin = virgin_V(param, n_tail)
        virgin = np.asarray(virgin, dtype=np.float32)
        if virgin.shape != (n_tail, param.V_dim):
            raise ValueError(f"virgin V has shape {virgin.shape}, the cold "
                             f"tail needs ({n_tail}, {param.V_dim})")
        self._virgin_V = virgin
        self._hits = REGISTRY.counter(
            "store_tier_hits_total",
            "batch slots already resident in the device hot tier")
        self._misses = REGISTRY.counter(
            "store_tier_misses_total",
            "batch slots that were cold (host tier) when requested")
        self._promotes = REGISTRY.counter(
            "store_tier_promotes_total",
            "rows promoted host tier -> device hot rows")
        self._demotes = REGISTRY.counter(
            "store_tier_demotes_total",
            "rows demoted device hot rows -> host tier")
        # device moves per kind ("promote", "demote", "evict"): the calls,
        # and the padded slot vector of the largest one
        self.calls = {"promote": 0, "demote": 0, "evict": 0}
        self.largest: dict = {}

    # ------------------------------------------------------------ bits
    def _to_host(self, rows: torch.Tensor) -> np.ndarray:
        rows = rows.cpu()
        if rows.dtype == torch.bfloat16:
            rows = rows.view(torch.int16)
        return rows.numpy()

    def _container(self, rows: np.ndarray) -> torch.Tensor:
        """Host row bits -> a CPU tensor of the table's container dtype."""
        t = torch.from_numpy(np.ascontiguousarray(rows))
        return t.view(torch.bfloat16) if self._dtype == torch.bfloat16 \
            else t

    def _note(self, kind: str, pad: np.ndarray, n: int) -> None:
        self.calls[kind] += 1
        if n > self.largest.get(kind, (0, None))[0]:
            self.largest[kind] = (n, pad)

    def stats(self) -> dict:
        return {"logical_rows": self.L, "device_rows": self.D,
                "resident": int((self._owner >= 0).sum()),
                "cold_stored": len(self._rows)}

    # ------------------------------------------------------------ route
    def route(self, slots: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sorted-unique logical slots (producer pads >= L welcome) ->
        ``(routed, order, perm)``: ``routed`` the same-length device row
        vector, sorted ascending, with the OOB lanes ``D + position`` for
        pads and degraded slots; ``order[j]`` the input position now at
        routed position ``j``; ``perm[p]`` the routed position of input
        position ``p`` (the index-cell rewrite map)."""
        s = np.asarray(slots, dtype=np.int64)
        n = len(s)
        self._tick += 1
        out = np.empty(n, dtype=np.int64)
        real_idx = np.nonzero(s < self.L)[0]
        # pads (and degraded slots below) get large distinct values so the
        # sort keeps them unique; they become D + j afterwards
        out[s >= self.L] = 2 * self.L + np.nonzero(s >= self.L)[0]
        rows = self._resident[s[real_idx]]
        hit = rows >= 0
        out[real_idx[hit]] = rows[hit]
        self._hits.inc(int(hit.sum()))
        miss_idx = real_idx[~hit]
        if len(miss_idx):
            self._misses.inc(len(miss_idx))
            granted = self._promote(s[miss_idx], protect=rows[hit])
            ok = granted >= 0
            out[miss_idx[ok]] = granted[ok]
            out[miss_idx[~ok]] = 2 * self.L + miss_idx[~ok]
        dev = out[out < self.D]
        self._clock[dev] = self._tick
        order = np.argsort(out, kind="stable")
        routed = out[order]
        n_pad = int((routed >= self.D).sum())
        if n_pad:
            routed[n - n_pad:] = self.D + np.arange(n - n_pad, n)
        perm = np.empty(n, dtype=np.int64)
        perm[order] = np.arange(n)
        return routed.astype(np.int32), order, perm

    # -------------------------------------------------- promote / demote
    def _tier_values(self, slots: np.ndarray) -> np.ndarray:
        """Host fused rows for ``slots``: demoted bits as they were, and
        virgin init rows (``build_rows`` on the CPU) for tail slots never
        demoted."""
        _, _, Wx, _ = self.layout
        vals = np.zeros((len(slots), Wx), dtype=self._np_dtype)
        virgin_i, virgin_s = [], []
        for i, sl in enumerate(np.asarray(slots, np.int64).tolist()):
            row = self._rows.pop(sl, None)
            if row is not None:
                vals[i] = row
            else:
                virgin_i.append(i)
                virgin_s.append(sl - self.D)
        if virgin_i:
            V = torch.from_numpy(self._virgin_V[np.asarray(virgin_s)])
            z = torch.zeros(len(virgin_i), dtype=torch.float32)
            built = build_rows(self.param, self.D, V, torch.zeros_like(V),
                               z, z, z, z, z.to(torch.bool))
            vals[np.asarray(virgin_i)] = self._to_host(built)
        return vals

    def _promote(self, miss_slots: np.ndarray,
                 protect: np.ndarray) -> np.ndarray:
        """Bring ``miss_slots`` (sorted unique, all cold) to the device.
        Returns the granted device row per slot, -1 where the slot stays
        cold this batch (a promote or demote fault, or no row left to
        evict). Fires ``store.promote``; demotes LRU victims through
        :meth:`_demote` when the hot set is full."""
        need = len(miss_slots)
        grant = np.full(need, -1, dtype=np.int64)
        free = np.nonzero(self._owner < 0)[0]
        if len(free) < need:
            self._demote_lru(need - len(free), protect)
            free = np.nonzero(self._owner < 0)[0]
        m = min(len(free), need)
        if m == 0:
            return grant
        try:
            faultinject.act_default(faultinject.fire("store.promote"))
        except FaultInjected:
            # the missing slots stay cold and read zeros this batch
            return grant
        dest = free[:m]
        vals = self._tier_values(miss_slots[:m])
        cap = bucket(m)
        pad = pad_slots_oob(dest.astype(np.int32), cap, self.D)
        _, _, Wx, _ = self.layout
        vp = np.zeros((cap, Wx), dtype=self._np_dtype)
        vp[:m] = vals
        st = self.store.state
        dev = st.VVg.device
        fused.scatter_rows(st.VVg, torch.from_numpy(pad).to(dev),
                           self._container(vp).to(dev))
        self._note("promote", pad, m)
        self._resident[miss_slots[:m]] = dest
        self._owner[dest] = miss_slots[:m]
        self._clock[dest] = self._tick
        self._promotes.inc(m)
        grant[:m] = dest
        return grant

    def _demote_lru(self, count: int, protect: np.ndarray) -> int:
        """Demote up to ``count`` least-recently-touched resident rows,
        never ``protect`` (this batch's hit rows) nor the trash row."""
        cand = self._owner >= 0
        cand[TRASH_SLOT] = False
        cand[np.asarray(protect, dtype=np.int64)] = False
        rows = np.nonzero(cand)[0]
        if not len(rows):
            return 0
        count = min(count, len(rows))
        if count < len(rows):
            part = np.argpartition(self._clock[rows], count - 1)[:count]
            victims = rows[part]
        else:
            victims = rows
        return self._demote(np.sort(victims))

    def _demote(self, victims: np.ndarray, kind: str = "demote") -> int:
        """Demote the given device rows (sorted unique) to host RAM. On a
        ``store.demote`` fault the victims stay hot: the move is fetch,
        then forget, and the fault fires before the fetch."""
        n = len(victims)
        if n == 0:
            return 0
        try:
            faultinject.act_default(faultinject.fire("store.demote"))
        except FaultInjected:
            return 0
        cap = bucket(n)
        table = self.store.state.VVg
        pad = pad_slots_oob(victims.astype(np.int32), cap, self.D)
        rows = fused.gather_rows(table, torch.from_numpy(pad).to(
            table.device))
        self._note(kind, pad, n)
        vals = self._to_host(rows)[:n]
        owners = self._owner[victims]
        for sl, val in zip(owners.tolist(), vals):
            self._rows[sl] = val
        self._resident[owners] = -1
        self._owner[victims] = -1
        self._demotes.inc(n)
        return n

    def demote_rows(self, victims: np.ndarray) -> int:
        """Occupancy eviction (``SlotStore.maybe_evict``): demote these
        device rows to the host tier, where they stay addressable."""
        victims = np.asarray(victims, dtype=np.int64)
        victims = victims[(victims != TRASH_SLOT)
                          & (self._owner[victims] >= 0)]
        return self._demote(np.sort(victims), kind="evict")

    # ------------------------------------------------------- checkpoint
    def logical_cols(self, device_cols: dict) -> dict:
        """Device-table columns [D rows] -> LOGICAL columns [L rows]: hot
        rows at their owning slot, demoted rows decoded from their host
        bits, virgin tail slots with their init V and zero scalars; the
        dense view an untiered store of capacity L saves."""
        k, h, _, off = self.layout
        out = {name: np.zeros((self.L,) + a.shape[1:], dtype=a.dtype)
               for name, a in device_cols.items()}
        rows = np.nonzero(self._owner >= 0)[0]
        for name, a in device_cols.items():
            out[name][self._owner[rows]] = a[rows]
        if "V" in out:
            virgin = np.ones(self.L - self.D, dtype=bool)
            hot = self._owner[rows]
            virgin[hot[hot >= self.D] - self.D] = False
            for sl in self._rows:
                if sl >= self.D:
                    virgin[sl - self.D] = False
            vs = np.nonzero(virgin)[0]
            out["V"][self.D + vs] = self._virgin_V[vs]
        if self._rows:
            slots = np.fromiter(self._rows.keys(), dtype=np.int64,
                                count=len(self._rows))
            slots.sort()
            rj = self._container(np.stack([self._rows[s]
                                           for s in slots.tolist()]))
            f = scal_f32(rj[:, off:]).numpy()
            cols = {"w": f[:, 0], "z": f[:, 1], "sqrt_g": f[:, 2],
                    "cnt": f[:, 3], "v_live": f[:, 4] > 0}
            if quantized(self.param):
                kind = self.param.slot_dtype
                cols["V"] = fused.dequant_half(
                    rj[:, :k], torch.from_numpy(f[:, 5]), kind).numpy()
                cols["Vg"] = fused.dequant_half(
                    rj[:, h:h + k], torch.from_numpy(f[:, 6]), kind).numpy()
            else:
                cols["V"] = rj[:, :k].to(torch.float32).numpy()
                cols["Vg"] = rj[:, h:h + k].to(torch.float32).numpy()
            for name in out:
                out[name][slots] = cols[name]
        return out

    def load_cold(self, arr: dict) -> None:
        """Seed the tier from LOGICAL checkpoint columns [L rows]:
        residency back to the identity prefix (slots [0, D) hot) and the
        tail [D, L) packed into host fused rows. A tail row whose w, cnt
        and live are all zero stays virgin (no host bits)."""
        self._resident[:] = -1
        self._resident[:self.D] = np.arange(self.D)
        self._owner = np.arange(self.D, dtype=np.int64)
        self._clock[:] = 0
        self._tick = 0
        self._rows = {}
        lo, hi = self.D, self.L
        touched = ((arr["w"][lo:hi] != 0) | (arr["cnt"][lo:hi] != 0)
                   | np.asarray(arr["v_live"][lo:hi], bool))
        idx = np.nonzero(touched)[0]
        if not len(idx):
            return

        def col(name, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(arr[name][lo:hi][idx], dtype=dtype)))

        built = self._to_host(build_rows(
            self.param, self.D, col("V"), col("Vg"), col("w"), col("z"),
            col("sqrt_g"), col("cnt"), col("v_live", bool)))
        for j, s in enumerate(idx.tolist()):
            self._rows[lo + s] = built[j]


def route_payload(tier: Optional[ColdTier], payload):
    """Rewrite a packed host payload (data/pack_stream.Payload) through
    the cold tier before it is copied to the device (the learner's
    ``_stage_payload``): the slots section becomes device rows (promoting
    as needed), the index cells (panel) or column lanes (COO) map through
    the position permutation, and the counts section, when present,
    follows its slots. The section offsets are pack_panel's and
    pack_batch's (ops/batch.py). Pass-through when the tier is off; raw
    and chunked payloads are refused, as the learner turns device_dedup
    and stream_chunks off under a tier."""
    if tier is None:
        return payload
    kind = payload.layout
    if payload.chunks is not None or kind not in ("panel", "coo"):
        raise ValueError(
            f"cold tier cannot route payload kind {kind!r}"
            f"{' with host chunks' if payload.chunks is not None else ''} "
            "(device_dedup / stream_chunks must be off under "
            "cold_tier_rows > 0)")
    i32, f32, b_cap, u_cap = payload.i32, payload.f32, payload.b_cap, \
        payload.u_cap
    if kind == "panel":
        cells = b_cap * payload.d2
        slot_off = cells
        vals_n = 0 if payload.binary else cells
    else:
        nnz_cap = payload.d2
        slot_off = 2 * nnz_cap
        vals_n = 0 if payload.binary else nnz_cap
    routed, order, perm = tier.route(i32[slot_off:slot_off + u_cap])
    i32 = i32.copy()
    i32[slot_off:slot_off + u_cap] = routed
    if kind == "panel":
        i32[:cells] = perm[i32[:cells]].astype(np.int32)
    else:
        i32[nnz_cap:2 * nnz_cap] = \
            perm[i32[nnz_cap:2 * nnz_cap]].astype(np.int32)
    counts_off = vals_n + 3 * b_cap
    if len(f32) >= counts_off + u_cap:
        f32 = f32.copy()
        f32[counts_off:counts_off + u_cap] = \
            f32[counts_off:counts_off + u_cap][order]
    return payload._replace(i32=i32, f32=f32)
