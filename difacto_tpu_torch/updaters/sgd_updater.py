"""Slot table and SGD updater: FTRL for w, AdaGrad for V (counterpart of
difacto_tpu/updaters/sgd_updater.py).

The model is a fixed-capacity table whose row 0 is a reserved trash slot.
Two layouts, keyed on ``V_dim``:

- ``V_dim == 0`` (linear models): flat f32 columns w/z/sqrt_g/cnt plus a
  bool v_live; ``VVg`` is [C, 0].
- ``V_dim > 0``: everything lives in ``VVg`` [C, Wx], one fused row
  ``[V | pad | Vg | pad | scal]`` per slot (:func:`row_layout`); the last
  ``scal_lanes`` lanes carry the f32 bits of (w, z, sqrt_g, cnt, live,
  scale_V, scale_Vg, spare) split into container-dtype lanes
  (:func:`pack_scal`). The container is fp32, bf16, or int8 holding
  int8/fp8 codes with per-row scales (``slot_dtype``).

Every layout decision is the JAX package's, so a table built here is the
JAX table bit for bit (``jax.lax.bitcast_convert_type`` becomes
``Tensor.view(dtype)``, which splits an f32 into lanes low bits first on
little-endian hosts, as XLA does).

- Pull gating (Get, sgd_updater.cc:34-58): an embedding is served only
  when live and, with ``l1_shrk``, when w != 0.
- Push (:func:`row_epilogue`, the plain version of the CUDA scatter
  kernel's epilogue): FTRL-proximal on w (UpdateW, sgd_updater.cc:105-131),
  lazy-V activation ``live |= (w != 0) & (cnt > V_threshold)``, AdaGrad on
  V (UpdateV, sgd_updater.cc:133-142) for rows whose embedding was pulled.
  Every operation is the JAX source's, in its order, on f32 values, so the
  result is the JAX package's bit for bit: constants are f32-rounded
  tensors on the data's device (CUDA divides by a Python scalar as a
  multiply by its reciprocal), and ``sqrt`` is taken in f64 and rounded,
  which is the correctly rounded f32 root (torch's CPU f32 ``sqrt`` is not
  always).
- Evaluate (sgd_updater.cc:15-32): penalty charges l2 on the V term too
  (a reference quirk kept by the JAX package); nnz counts V_dim for every
  live embedding.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Param
from ..ops import fused

TRASH_SLOT = 0  # row 0 absorbs padded scatters; never a real feature


@dataclass
class SGDUpdaterParam(Param):
    """The JAX package's updater knobs under the same names and defaults:
    the learning knobs, the table geometry (V_dim, hash_capacity, the row
    layout knobs, slot_dtype), the init (seed, V_init_scale) and the pull
    gate ``l1_shrk``. ``fused_kernel`` is parsed so JAX configs that set it
    load, and selects nothing: a table on the card always takes the CUDA
    kernels, a table on the CPU their plain versions. ``init_capacity``
    (dictionary store) and the capacity levers ``admit_min_count``,
    ``evict_occupancy`` and ``cold_tier_rows`` (capacity/) are the JAX
    package's too."""
    l1: float = field(default=1.0, metadata=dict(lo=0, hi=1e10))
    l2: float = field(default=0.0, metadata=dict(lo=0, hi=1e10))
    V_l2: float = field(default=0.01, metadata=dict(lo=0, hi=1e10))
    lr: float = field(default=0.01, metadata=dict(lo=0, hi=10))
    lr_beta: float = field(default=1.0, metadata=dict(lo=0, hi=1e10))
    V_lr: float = field(default=0.01, metadata=dict(lo=0, hi=1e10))
    V_lr_beta: float = field(default=1.0, metadata=dict(lo=0, hi=10))
    V_init_scale: float = field(default=0.01, metadata=dict(lo=0, hi=10))
    V_dim: int = field(default=0, metadata=dict(lo=0))
    V_threshold: int = 10
    l1_shrk: bool = True
    seed: int = 0
    hash_capacity: int = 0
    init_capacity: int = field(default=1 << 14, metadata=dict(lo=2))
    V_dtype: str = field(default="float32",
                         metadata=dict(enum=["float32", "bfloat16"]))
    pad_v_rows: bool = True
    pad_v_rows_max_mb: int = 1536
    fused_kernel: str = field(default="auto",
                              metadata=dict(enum=["auto", "pallas",
                                                  "jnp", "off"]))
    slot_dtype: str = field(default="fp32",
                            metadata=dict(enum=["fp32", "bf16",
                                                "int8", "fp8"]))
    admit_min_count: int = field(default=0, metadata=dict(lo=0))
    evict_occupancy: float = field(default=0.0, metadata=dict(lo=0, hi=1))
    cold_tier_rows: int = field(default=0, metadata=dict(lo=0))


class SGDState(NamedTuple):
    """Slot-table state; every array has capacity rows (row 0 trash). The
    five flat fields are empty [0] placeholders when V_dim > 0."""
    w: torch.Tensor        # f32[C] (V_dim=0) | f32[0]
    z: torch.Tensor        # f32[C] FTRL dual  | f32[0]
    sqrt_g: torch.Tensor   # f32[C]            | f32[0]
    cnt: torch.Tensor      # f32[C] counts     | f32[0]
    VVg: torch.Tensor      # [C, Wx] fused rows (V_dim>0) | [C, 0]
    v_live: torch.Tensor   # bool[C] (V_dim=0)  | bool[0]

    @property
    def capacity(self) -> int:
        return self.VVg.shape[0]


def quantized(param: SGDUpdaterParam) -> bool:
    """True when the fused rows store 8-bit codes with per-row scales."""
    return param.slot_dtype in ("int8", "fp8") and param.V_dim > 0


def v_dtype(param: SGDUpdaterParam) -> torch.dtype:
    """Container dtype of the fused rows: slot_dtype int8/fp8 share the
    int8 container, bf16 forces bfloat16, fp32 defers to V_dtype."""
    if param.V_dim > 0:
        if param.slot_dtype in ("int8", "fp8"):
            return torch.int8
        if param.slot_dtype == "bf16":
            return torch.bfloat16
    return torch.bfloat16 if param.V_dtype == "bfloat16" else torch.float32


def v_half(param: SGDUpdaterParam, capacity: int) -> int:
    """Stored width of each VVg half: V_dim rounded up to 64 lanes when
    pad_v_rows and the padded table fits pad_v_rows_max_mb, else V_dim."""
    k = param.V_dim
    if k == 0 or not param.pad_v_rows:
        return k
    h = -(-k // 64) * 64
    if capacity * 2 * h * v_dtype(param).itemsize \
            > param.pad_v_rows_max_mb << 20:
        return k
    return h


def fuse_vvg(V: torch.Tensor, Vg: torch.Tensor, h: int) -> torch.Tensor:
    """[V | pad | Vg | pad] with each half zero-padded from k to h lanes."""
    k = V.shape[1]
    if h == k:
        return torch.cat([V, Vg], dim=1)
    pad = torch.zeros((V.shape[0], h - k), dtype=V.dtype, device=V.device)
    return torch.cat([V, pad, Vg, pad], dim=1)


# the scalar section: the BYTES of f32[8] = (w, z, sqrt_g, cnt, live,
# scale_V, scale_Vg, spare) viewed in the row's container dtype — 8 f32
# lanes, 16 bf16 lanes or 32 int8 lanes
SCAL_F32S = 8


def scal_lanes(dtype: torch.dtype) -> int:
    return SCAL_F32S * (4 // dtype.itemsize)


def row_layout(param: SGDUpdaterParam, capacity: int
               ) -> Tuple[int, int, int, int]:
    """(k, h, Wx, off) of the fused row at this capacity: half width h,
    total width Wx (a multiple of 128 lanes), scalar offset off = Wx -
    scal_lanes. The scalars ride inside the Vg-half pad when it is wide
    enough; otherwise the row grows to the next multiple of 128."""
    k = param.V_dim
    if k <= 0:
        raise ValueError("the flat V_dim=0 layout has no fused row")
    h = v_half(param, capacity)
    ns = scal_lanes(v_dtype(param))
    Wx = 2 * h if h - k >= ns else -(-(2 * h + ns) // 128) * 128
    return k, h, Wx, Wx - ns


def state_bytes(param: SGDUpdaterParam, capacity: int) -> int:
    """Device bytes of the slot table at ``capacity`` rows: four f32
    columns and a bool for the flat layout, the fused rows otherwise."""
    if param.V_dim == 0:
        return capacity * (4 * 4 + 1)
    _, _, Wx, _ = row_layout(param, capacity)
    return capacity * Wx * v_dtype(param).itemsize


def gather_bytes(param: SGDUpdaterParam, capacity: int, u_cap: int) -> int:
    """Bytes ONE direction of a fused-row gather (or scatter) of
    ``u_cap`` rows moves at this capacity's row layout: the unit of the
    learner's ``store_gather_bytes_total`` counter (a train step counts
    it twice, pull and push)."""
    if param.V_dim == 0:
        return u_cap * 3 * 4
    _, _, Wx, _ = row_layout(param, capacity)
    return u_cap * Wx * v_dtype(param).itemsize


def pack_scal(w, z, sqrt_g, cnt, live, dtype: torch.dtype,
              scale_V=None, scale_Vg=None) -> torch.Tensor:
    """f32 scalar columns + bool live -> [n, scal_lanes] of ``dtype``;
    omitted scales stay exact 0.0."""
    wf = w.to(torch.float32)
    zero = torch.zeros_like(wf)
    f = torch.stack([wf, z.to(torch.float32), sqrt_g.to(torch.float32),
                     cnt.to(torch.float32), live.to(torch.float32),
                     zero if scale_V is None else scale_V.to(torch.float32),
                     zero if scale_Vg is None
                     else scale_Vg.to(torch.float32),
                     zero], dim=1)
    return f if dtype == torch.float32 else f.view(dtype)


def scal_f32(lanes: torch.Tensor) -> torch.Tensor:
    """[n, scal_lanes] scalar section (any container) -> f32[n, 8]:
    columns (w, z, sqrt_g, cnt, live, scale_V, scale_Vg, spare)."""
    if lanes.dtype == torch.float32:
        return lanes
    return lanes.contiguous().view(torch.float32)


def unpack_scal(lanes: torch.Tensor):
    """[n, scal_lanes] -> (w, z, sqrt_g, cnt, live)."""
    f = scal_f32(lanes)
    return f[:, 0], f[:, 1], f[:, 2], f[:, 3], f[:, 4] > 0


def scal_cols(param: SGDUpdaterParam, state: SGDState):
    """(w, z, sqrt_g, cnt, v_live) as full-table columns, layout-free —
    the checkpoint view (a full-table pass: cold paths only)."""
    if param.V_dim == 0:
        return state.w, state.z, state.sqrt_g, state.cnt, state.v_live
    _, _, _, off = row_layout(param, state.capacity)
    return unpack_scal(state.VVg[:, off:])


def emb_cols_f32(param: SGDUpdaterParam, state: SGDState):
    """Full-table logical f32 (V, Vg) columns, dequantized for 8-bit
    rows (cold paths only)."""
    k, h, _, off = row_layout(param, state.capacity)
    V, Vg = state.VVg[:, :k], state.VVg[:, h:h + k]
    if not quantized(param):
        return V.to(torch.float32), Vg.to(torch.float32)
    f = scal_f32(state.VVg[:, off:])
    return (fused.dequant_half(V, f[:, 5], param.slot_dtype),
            fused.dequant_half(Vg, f[:, 6], param.slot_dtype))


def set_all_live(param: SGDUpdaterParam, state: SGDState) -> SGDState:
    """Activate every embedding row."""
    if param.V_dim == 0:
        return state._replace(v_live=torch.ones_like(state.v_live))
    _, _, _, off = row_layout(param, state.capacity)
    f = scal_f32(state.VVg[:, off:])
    scal = pack_scal(f[:, 0], f[:, 1], f[:, 2], f[:, 3],
                     torch.ones_like(f[:, 0], dtype=torch.bool),
                     state.VVg.dtype, scale_V=f[:, 5], scale_Vg=f[:, 6])
    return state._replace(VVg=torch.cat([state.VVg[:, :off], scal], dim=1))


def build_rows(param: SGDUpdaterParam, capacity: int, V, Vg,
               w, z, sqrt_g, cnt, live) -> torch.Tensor:
    """Assemble full fused rows [V | pad | Vg | pad | scal] at this
    capacity's layout from f32 tensor parts (all on one device); 8-bit
    slots requantize each half with fresh per-row scales."""
    _, h, _, off = row_layout(param, capacity)
    dt = v_dtype(param)
    V, Vg = V.to(torch.float32), Vg.to(torch.float32)
    if quantized(param):
        Vc, sV = fused.quant_half(V, param.slot_dtype)
        Vgc, sVg = fused.quant_half(Vg, param.slot_dtype)
        halves = fuse_vvg(Vc, Vgc, h)
    else:
        sV = sVg = None
        halves = fuse_vvg(V, Vg, h).to(dt)
    scal = pack_scal(w, z, sqrt_g, cnt, live, dt, scale_V=sV, scale_Vg=sVg)
    # in-pad layout: the scalars replace the tail of the Vg-half pad;
    # appended layout: zero gap lanes between the halves and the scalars
    if off <= 2 * h:
        return torch.cat([halves[:, :off], scal], dim=1)
    gap = torch.zeros((halves.shape[0], off - 2 * h), dtype=dt,
                      device=halves.device)
    return torch.cat([halves, gap, scal], dim=1)


def init_state(param: SGDUpdaterParam, capacity: int,
               device: torch.device) -> SGDState:
    """A fresh table: zero scalars, V drawn uniform in
    ±V_init_scale/2 from a torch generator seeded with ``param.seed``
    (the JAX package draws from jax.random; the two never share bits)."""
    empty = torch.zeros(0, dtype=torch.float32, device=device)
    k = param.V_dim
    if k == 0:
        def zeros():
            return torch.zeros(capacity, dtype=torch.float32, device=device)
        return SGDState(w=zeros(), z=zeros(), sqrt_g=zeros(), cnt=zeros(),
                        VVg=torch.zeros((capacity, 0), dtype=torch.float32,
                                        device=device),
                        v_live=torch.zeros(capacity, dtype=torch.bool,
                                           device=device))
    gen = torch.Generator(device=device).manual_seed(param.seed)
    V = (torch.rand((capacity, k), generator=gen, dtype=torch.float32,
                    device=device) - 0.5) * param.V_init_scale
    if quantized(param):
        zcol = torch.zeros(capacity, dtype=torch.float32, device=device)
        T = build_rows(param, capacity, V, torch.zeros_like(V), zcol, zcol,
                       zcol, zcol, zcol.to(torch.bool))
    else:
        # all-zero scalar lanes encode (0, 0, 0, 0, live=False)
        _, _, Wx, _ = row_layout(param, capacity)
        T = torch.zeros((capacity, Wx), dtype=v_dtype(param), device=device)
        T[:, :k] = V.to(T.dtype)
    return SGDState(w=empty, z=empty.clone(), sqrt_g=empty.clone(),
                    cnt=empty.clone(), VVg=T,
                    v_live=torch.zeros(0, dtype=torch.bool, device=device))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as the f32 0-d tensor JAX's weak typing makes of it,
    on ``like``'s device (a fill there, no copy from the host)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt: f64 root rounded once to f32."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def ftrl_w(w, z, sg, gw, l1: float, l2: float, lr: float, lr_beta: float):
    """The FTRL-proximal w update (UpdateW, sgd_updater.cc:105-131) in the
    JAX source's operation order."""
    l1t, l2t, lrt, lbt = (_f32(v, w) for v in (l1, l2, lr, lr_beta))
    g = gw + l2t * w
    sg_new = _sqrt(sg * sg + g * g)
    z_new = z - (g - (sg_new - sg) / lrt * w)
    eta = (lbt + sg_new) / lrt
    w_new = torch.where(z_new.abs() <= l1t, torch.zeros_like(z_new),
                        (z_new - torch.sign(z_new) * l1t) / eta)
    return w_new, z_new, sg_new


def row_epilogue(param: SGDUpdaterParam, capacity: int, rows: torch.Tensor,
                 gw: torch.Tensor, gV: Optional[torch.Tensor],
                 pull_vmask: Optional[torch.Tensor]) -> torch.Tensor:
    """The per-row FTRL(w) + AdaGrad(V) update of gathered fused rows
    [n, Wx] -> new rows, without the gather and the scatter: the plain
    version of the scatter kernel's epilogue. ``pull_vmask`` gates AdaGrad
    to rows whose embedding was pulled this batch (sgd_updater.cc:91-96);
    those rows get zeros in their pad lanes, the others keep their
    embedding lanes bit for bit. Pad lanes of the slot vector compute
    garbage that the scatter drops."""
    k, h, _, off = row_layout(param, capacity)
    q = quantized(param)
    f = scal_f32(rows[:, off:])
    w, z, sg, cnt, live = f[:, 0], f[:, 1], f[:, 2], f[:, 3], f[:, 4] > 0
    sV, sVg = f[:, 5], f[:, 6]
    w_new, z_new, sg_new = ftrl_w(w, z, sg, gw, param.l1, param.l2,
                                  param.lr, param.lr_beta)
    live_new = live | ((w_new != 0) & (cnt > _f32(param.V_threshold, cnt)))
    if gV is not None:
        if q:
            V = fused.dequant_half(rows[:, :k], sV, param.slot_dtype)
            Vg = fused.dequant_half(rows[:, h:h + k], sVg, param.slot_dtype)
        else:
            V = rows[:, :k].to(torch.float32)
            Vg = rows[:, h:h + k].to(torch.float32)
        gv = gV + _f32(param.V_l2, V) * V
        Vg_new = _sqrt(Vg * Vg + gv * gv)
        V_new = V - _f32(param.V_lr, V) / (
            Vg_new + _f32(param.V_lr_beta, V)) * gv
        um = pull_vmask > 0
        if q:
            Vc, sV_new = fused.quant_half(V_new, param.slot_dtype)
            Vgc, sVg_new = fused.quant_half(Vg_new, param.slot_dtype)
            emb = torch.where(um[:, None], fuse_vvg(Vc, Vgc, h),
                              rows[:, :2 * h])
            sV = torch.where(um, sV_new, sV)
            sVg = torch.where(um, sVg_new, sVg)
        else:
            emb = torch.where(um[:, None],
                              fuse_vvg(V_new, Vg_new, h).to(rows.dtype),
                              rows[:, :2 * h])
    else:
        emb = rows[:, :2 * h]
    scal = pack_scal(w_new, z_new, sg_new, cnt, live_new, rows.dtype,
                     scale_V=sV, scale_Vg=sVg)
    # in-pad layout: the scalars replace the tail of emb's own pad lanes;
    # appended layout: the gap lanes between are carried
    if off <= 2 * h:
        return torch.cat([emb[:, :off], scal], dim=1)
    return torch.cat([emb, rows[:, 2 * h:off], scal], dim=1)


def container_kind(param: SGDUpdaterParam) -> str:
    """The fused row's container as the scatter kernel names it."""
    if quantized(param):
        return param.slot_dtype
    return "bf16" if v_dtype(param) == torch.bfloat16 else "fp32"


def epilogue_spec(param: SGDUpdaterParam, capacity: int) -> fused.Epilogue:
    """The scatter kernel's epilogue for this table: layout, container
    and the f32-rounded hyperparameters."""
    k, h, _, off = row_layout(param, capacity)
    hyper = tuple(float(np.float32(v)) for v in (
        param.l1, param.l2, param.lr, param.lr_beta, param.V_l2,
        param.V_lr, param.V_lr_beta, float(param.V_threshold)))
    return fused.Epilogue(k, h, off, container_kind(param), hyper)


def _gather_flat(col: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Flat-column gather with zero fill on OOB slots (the V_dim=0
    layout's pull, a plain tensor gather in both packages)."""
    s = slots.to(torch.int64)
    ok = (s >= 0) & (s < col.shape[0])
    v = col[torch.where(ok, s, torch.zeros_like(s))]
    return torch.where(ok, v, torch.zeros_like(v))


def _scatter_flat(col: torch.Tensor, slots: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """``col[slots] = vals`` in place for the in-bounds lanes of sorted
    unique slots; out-of-bounds pad lanes are dropped (the V_dim=0
    layout's push, a plain tensor scatter in both packages)."""
    s = slots.to(torch.int64)
    ok = (s >= 0) & (s < col.shape[0])
    col[s[ok]] = vals[ok]


def grow_state(param: SGDUpdaterParam, state: SGDState, new_capacity: int,
               init) -> SGDState:
    """Double-and-copy growth of the dictionary store's table: rows
    ``[old:]`` come from ``init(new_capacity)`` (a fresh table at the new
    capacity, so a row's initial V is a function of the seed and the
    capacity at which it was added, as in the JAX package). A growth that
    crosses ``pad_v_rows_max_mb`` changes the row layout (the half width
    h drops from 64 to V_dim); the old rows are then re-laid out through
    ``build_rows`` at the new capacity's layout."""
    old = state.capacity
    if new_capacity <= old:
        return state
    ext = init(new_capacity)
    if param.V_dim and row_layout(param, old) != row_layout(param,
                                                            new_capacity):
        _, _, _, off = row_layout(param, old)
        w, z, sg, cnt, live = unpack_scal(state.VVg[:, off:])
        Vf, Vgf = emb_cols_f32(param, state)
        state = state._replace(VVg=build_rows(
            param, new_capacity, Vf, Vgf, w, z, sg, cnt, live))
    return SGDState(*(torch.cat([a, b[old:]]) for a, b in zip(state, ext)))


def make_fns(param: SGDUpdaterParam, mesh=None):
    """The updater functions with the params baked in: a namespace of
    ``pull_rows``, ``rows_to_params``, ``get_rows`` (the pull),
    ``apply_count``, ``apply_grad_rows``, ``apply_grad`` (the push, in
    place on the state's table) and ``evaluate``. The train step always
    threads its one gather from the pull to the push (the JAX package's
    ``fns.fused`` path), so no flag selects it.

    ``slots`` is a device slot vector, or under an fs-sharded mesh a
    :class:`~difacto_tpu_torch.parallel.sharded.ShardedSlots`: then the
    fused gathers and scatters run once per non-empty key-range shard of
    ``mesh`` (parallel/sharded.py) over the shards of the table they are
    handed. The flat ``V_dim=0`` columns take plain gathers and scatters
    of the global slots either way."""
    from ..parallel import sharded
    from ..parallel.mesh import state_sharding
    shards = None if mesh is None else state_sharding(mesh)

    has_V = param.V_dim > 0
    thr = param.V_threshold

    def _flat(slots):
        return slots.slots if isinstance(slots, sharded.ShardedSlots) \
            else slots

    def _gather(VVg: torch.Tensor, slots) -> torch.Tensor:
        if isinstance(slots, sharded.ShardedSlots):
            return sharded.sharded_gather(shards(VVg), slots)
        return fused.gather_rows(VVg, slots)

    def _scatter(VVg: torch.Tensor, slots, rows) -> torch.Tensor:
        if isinstance(slots, sharded.ShardedSlots):
            sharded.sharded_scatter(shards(VVg), slots, rows)
            return VVg
        return fused.scatter_rows(VVg, slots, rows)

    def pull_rows(state: SGDState, slots: torch.Tensor) -> torch.Tensor:
        """ONE full fused-row gather of the batch's sorted-unique
        OOB-padded slots (ops/fused.gather_rows: the CUDA kernel on the
        card; one launch per shard run under a mesh). V keeps its
        container dtype."""
        return _gather(state.VVg, slots)

    def rows_to_params(state: SGDState, rows: torch.Tensor):
        """(w, V, v_mask) views of gathered fused rows; 8-bit rows
        dequantize V with the per-row scale of lane 5."""
        _, _, _, off = row_layout(param, state.capacity)
        f = scal_f32(rows[:, off:])
        w, live = f[:, 0], f[:, 4] > 0
        vmask = live & (w != 0) if param.l1_shrk else live
        if quantized(param):
            V = fused.dequant_half(rows[:, :param.V_dim], f[:, 5],
                                   param.slot_dtype)
        else:
            V = rows[:, :param.V_dim]
        return w, V, vmask.to(torch.float32)

    def get_rows(state: SGDState, slots: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            Optional[torch.Tensor]]:
        """Pull [w, V, v_mask] rows for the batch's slots (Get)."""
        if not has_V:
            return _gather_flat(state.w, _flat(slots)), None, None
        return rows_to_params(state, pull_rows(state, slots))

    def apply_count(state: SGDState, slots: torch.Tensor,
                    counts: torch.Tensor) -> SGDState:
        """kFeaCount push (Update, sgd_updater.cc:64-75): one gather, the
        count and lazy-V update of the scalar lanes (scale lanes carried),
        one scatter with the kernel's epilogue off. The flat table adds
        the counts to its cnt column."""
        if not has_V:
            slots = _flat(slots)
            _scatter_flat(state.cnt, slots,
                          _gather_flat(state.cnt, slots) + counts)
            return state
        _, _, _, off = row_layout(param, state.capacity)
        rows = _gather(state.VVg, slots)
        f = scal_f32(rows[:, off:])
        w, z, sg, cnt, live = f[:, 0], f[:, 1], f[:, 2], f[:, 3], f[:, 4] > 0
        cnt_new = cnt + counts
        # V_threshold is an integer: exact in f32 and as a Python scalar
        live_new = live | ((w != 0) & (cnt_new > float(thr)))
        scal = pack_scal(w, z, sg, cnt_new, live_new, state.VVg.dtype,
                         scale_V=f[:, 5], scale_Vg=f[:, 6])
        out = torch.cat([rows[:, :off], scal], dim=1)
        return state._replace(VVg=_scatter(state.VVg, slots, out))

    def apply_grad_rows(state: SGDState, slots: torch.Tensor,
                        rows: torch.Tensor, gw: torch.Tensor,
                        gV: torch.Tensor, pull_vmask: torch.Tensor
                        ) -> SGDState:
        """Fused kGradient push over rows the step already gathered: the
        epilogue and the scatter in one kernel on the card
        (ops/fused.fm_update_rows), in place."""
        if not has_V:
            raise ValueError("apply_grad_rows: the flat V_dim=0 table has "
                             "no fused rows; its push is apply_grad")
        cap = state.capacity
        epi = epilogue_spec(param, cap)
        epilogue = functools.partial(row_epilogue, param, cap)
        if isinstance(slots, sharded.ShardedSlots):
            sharded.sharded_push(shards(state.VVg), slots, rows, gw, gV,
                                 pull_vmask, epi, epilogue)
            return state
        return state._replace(VVg=fused.fm_update_rows(
            state.VVg, slots, rows, gw, gV, pull_vmask, epi, epilogue))

    def apply_grad(state: SGDState, slots: torch.Tensor, gw: torch.Tensor,
                   gV: Optional[torch.Tensor],
                   pull_vmask: Optional[torch.Tensor]) -> SGDState:
        """kGradient push that gathers its own rows first. On the flat
        table: FTRL on the gathered w/z/sqrt_g and three plain scatters,
        in place."""
        if not has_V:
            slots = _flat(slots)
            w_new, z_new, sg_new = ftrl_w(
                _gather_flat(state.w, slots), _gather_flat(state.z, slots),
                _gather_flat(state.sqrt_g, slots), gw, param.l1, param.l2,
                param.lr, param.lr_beta)
            for col, new in ((state.w, w_new), (state.sqrt_g, sg_new),
                             (state.z, z_new)):
                _scatter_flat(col, slots, new)
            return state
        return apply_grad_rows(state, slots, pull_rows(state, slots), gw,
                               gV, pull_vmask)

    def evaluate(state: SGDState) -> Tuple[torch.Tensor, torch.Tensor]:
        """(penalty, nnz) over real rows as device scalars (Evaluate,
        sgd_updater.cc:15-32); full-table column reads, once per epoch."""
        w, _, _, _, live = scal_cols(param, state)
        w = w.clone()
        w[TRASH_SLOT:TRASH_SLOT + 1].zero_()     # a fill, no host copy
        l1, l2 = _f32(param.l1, w), _f32(param.l2, w)
        penalty = torch.sum(l1 * w.abs() + 0.5 * l2 * w * w)
        nnz = torch.sum((w != 0).to(torch.float32))
        if not has_V:
            return penalty, nnz
        live = live.clone()
        live[TRASH_SLOT:TRASH_SLOT + 1].zero_()
        Vcol = emb_cols_f32(param, state)[0]
        Vm = Vcol * live[:, None]
        penalty = penalty + torch.sum(0.5 * l2 * Vm * Vm)
        nnz = nnz + torch.sum(live) * param.V_dim
        return penalty, nnz

    class _NS:
        pass

    ns = _NS()
    ns.param = param
    ns.has_V = has_V
    ns.pull_rows = pull_rows
    ns.rows_to_params = rows_to_params
    ns.get_rows = get_rows
    ns.apply_count = apply_count
    ns.apply_grad_rows = apply_grad_rows
    ns.apply_grad = apply_grad
    ns.evaluate = evaluate
    return ns
