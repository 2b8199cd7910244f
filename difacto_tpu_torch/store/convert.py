"""Carry a model's state across from the JAX package as numpy arrays.

- :func:`state_to_numpy` gives the logical columns a JAX
  ``SlotStore.save`` writes (``w, z, sqrt_g, cnt, v_live, V, Vg``: V/Vg
  stripped of pad and scalar lanes, dequantized for 8-bit rows, f32) of a
  device state; the port's checkpoint save goes through it.
- :func:`state_from_numpy` takes such columns and builds the port's fused
  table through ``build_rows``; the port's checkpoint load goes through
  it too. It also takes a dictionary model's arrays (``keys`` and one row
  per key): the rows go to slots 1..n, the other rows are a fresh
  table's.
- :func:`state_from_jax_table` adopts the JAX fused ``VVg`` table
  (``np.asarray(state.VVg)``) bit for bit; a bfloat16 table arrives as
  ml_dtypes' numpy bfloat16 and is moved through its 16-bit patterns.
- :func:`read_sharded_columns` assembles the logical columns of a
  per-key-range checkpoint (the JAX package's ``_save_sharded`` layout:
  ``<path>_fs-<i>-of-<n>`` members, each verified, and the array-free
  stub at ``<path>``), so a JAX fs-sharded checkpoint loads into a port
  store of any ``fs`` and the port's sharded saves load into JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..updaters.sgd_updater import (SGDState, SGDUpdaterParam, build_rows,
                                    emb_cols_f32, init_state, quantized,
                                    row_layout, scal_cols, v_dtype)
from ..utils.platform import resolve_device

LOGICAL = ("w", "z", "sqrt_g", "cnt", "v_live", "V", "Vg")


def _empty_cols(device: torch.device) -> dict:
    empty = torch.zeros(0, dtype=torch.float32, device=device)
    return dict(w=empty, z=empty.clone(), sqrt_g=empty.clone(),
                cnt=empty.clone(),
                v_live=torch.zeros(0, dtype=torch.bool, device=device))


def state_to_numpy(param: SGDUpdaterParam, state, keys=LOGICAL,
                   capacity: Optional[int] = None) -> dict:
    """Host numpy view of the logical columns ``keys`` of ``state``; a
    parallel.sharded.ShardedState's shards come to the host one by one,
    in shard order. ``capacity`` (default the state's) is the logical
    table's whose row layout the rows have (a shard passes the whole
    table's)."""
    from ..parallel.sharded import ShardedState
    if isinstance(state, ShardedState):
        parts = [state_to_numpy(param, s, keys, state.capacity)
                 for s in state.shards]
        return {f: np.concatenate([p[f] for p in parts]) for f in keys}
    capacity = capacity or state.capacity
    w, z, sg, cnt, live = scal_cols(param, state, capacity)
    cols = {"w": w, "z": z, "sqrt_g": sg, "cnt": cnt, "v_live": live}
    if "V" in keys or "Vg" in keys:
        if param.V_dim == 0:
            cols["V"] = cols["Vg"] = state.VVg
        elif quantized(param):
            cols["V"], cols["Vg"] = emb_cols_f32(param, state, capacity)
        else:
            k, h, _, _ = row_layout(param, capacity)
            cols["V"], cols["Vg"] = state.VVg[:, :k], state.VVg[:, h:h + k]
    # lint: ok(torch-host-sync) the table's columns leave once per save
    # or shard report (a run's end), never per step
    out = {f: cols[f].cpu() for f in keys}
    for f in ("V", "Vg"):
        if f in out:
            out[f] = out[f].to(torch.float32)
    return {f: a.numpy() for f, a in out.items()}


def state_from_numpy(param: SGDUpdaterParam, arrays: dict,
                     device="cuda",
                     init: Optional[Callable[[int], SGDState]] = None,
                     min_capacity: Optional[int] = None,
                     capacity: Optional[int] = None) -> SGDState:
    """Device state from logical numpy columns (fused rows for V_dim > 0,
    the flat columns for V_dim == 0); absent columns are zero, the row
    count is that of ``w``. ``capacity`` (default the row count) is the
    logical table's whose row layout the rows take: a key-range shard's
    rows pass the whole table's.

    With ``keys`` in ``arrays`` (a dictionary model, rows in key order),
    the capacity is ``min_capacity`` (default ``init_capacity``) doubled
    until n + 1 rows fit, the rows go to slots 1..n, and every other row
    is ``init(capacity)``'s (default ``init_state``): the JAX
    dictionary store's load."""
    dev = resolve_device(device)
    if "keys" in arrays:
        n = len(arrays["keys"])
        cap = min_capacity or param.init_capacity
        while cap < n + 1:
            cap *= 2
        fresh = (init or (lambda c: init_state(param, c, dev)))(cap)
        cols = {f: a.copy() for f, a in state_to_numpy(param, fresh).items()}
        for f, a in arrays.items():
            if f in cols and np.size(a):
                cols[f][1:n + 1] = a
        arrays = cols
    n_rows = int(np.asarray(arrays["w"]).shape[0])
    cap = capacity or n_rows
    k = param.V_dim

    def col(name, shape, dtype=torch.float32):
        if name not in arrays:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return torch.as_tensor(np.asarray(arrays[name])).to(dev, dtype)

    w, z, sg, cnt = (col(n, (n_rows,)) for n in ("w", "z", "sqrt_g", "cnt"))
    live = col("v_live", (n_rows,), torch.bool)
    if k == 0:
        return SGDState(w=w, z=z, sqrt_g=sg, cnt=cnt, v_live=live,
                        VVg=torch.zeros((n_rows, 0), dtype=torch.float32,
                                        device=dev))
    T = build_rows(param, cap, col("V", (n_rows, k)),
                   col("Vg", (n_rows, k)), w, z, sg, cnt, live)
    return SGDState(VVg=T, **_empty_cols(dev))


def state_from_jax_table(param: SGDUpdaterParam, vvg_np: np.ndarray,
                         device="cuda") -> SGDState:
    """Adopt a JAX fused table bit for bit (dtype and layout checked)."""
    dev = resolve_device(device)
    a = np.asarray(vvg_np)
    want = v_dtype(param)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C", copy=True))
    if t.dtype != want:
        raise ValueError(f"JAX table dtype {a.dtype} != this layout's "
                         f"container {want}")
    _, _, Wx, _ = row_layout(param, a.shape[0])
    if a.ndim != 2 or a.shape[1] != Wx:
        raise ValueError(f"JAX table shape {a.shape} != [C, {Wx}] for this "
                         "layout")
    return SGDState(VVg=t.to(dev), **_empty_cols(dev))


def fs_shard_path(path: str, shard: int, count: int) -> str:
    """Per-shard checkpoint member name ``<path>_fs-<i>-of-<n>`` (the JAX
    package's); utils/manifest.family_prefix strips the decoration, so
    shard members prune and walk back with their family."""
    return f"{path}_fs-{shard}-of-{count}"


def read_sharded_columns(path: str, fs_count: int, capacity: int,
                         V_dim: int, loaded, weights_only: bool,
                         verify: bool = True) -> dict:
    """Logical columns ``[capacity]`` of a per-key-range checkpoint whose
    stub at ``path`` declared ``fs_count`` shards (the JAX store's
    ``_load_sharded``). Every member is digest-verified (its manifest is
    required: the stub declared it) before the caller commits anything;
    a missing member, a geometry that disagrees with the stub or an array
    of the wrong row count raises ``CheckpointCorrupt``, so loaders walk
    back a generation. ``weights_only`` leaves the optimizer columns out
    (state_from_numpy makes absent columns zero)."""
    from ..parallel.mesh import fs_shard_bounds
    from ..utils import manifest as mft
    try:
        bounds = fs_shard_bounds(capacity, fs_count)
    except ValueError as e:
        raise mft.CheckpointCorrupt(path, str(e)) from e

    arr = {"w": np.zeros(capacity, np.float32),
           "cnt": np.zeros(capacity, np.float32),
           "v_live": np.zeros(capacity, bool),
           "V": np.zeros((capacity, V_dim), np.float32)}
    if not weights_only:
        arr.update(z=np.zeros(capacity, np.float32),
                   sqrt_g=np.zeros(capacity, np.float32),
                   Vg=np.zeros((capacity, V_dim), np.float32))
    for i, (lo, hi) in enumerate(bounds):
        for k, a in read_shard_member(path, i, fs_count, capacity, loaded,
                                      verify).items():
            arr[k][lo:hi] = a
    return arr


def read_shard_member(path: str, i: int, fs_count: int, capacity: int,
                      loaded, verify: bool = True) -> dict:
    """The columns ``loaded`` of member ``i`` of a per-key-range
    checkpoint (rows ``[i * C/n, (i + 1) * C/n)``), digest-verified unless
    ``verify`` is off; a missing member or a geometry that disagrees with
    the stub raises ``CheckpointCorrupt``. A store of the same ``fs``
    loads each member straight into its shard."""
    from ..parallel.mesh import fs_shard_bounds
    from ..utils import manifest as mft
    from ..utils import stream
    lo, hi = fs_shard_bounds(capacity, fs_count)[i]
    sp = fs_shard_path(path, i, fs_count)
    try:
        sctx = (mft.open_verified(sp, require_manifest=True,
                                  fault_point="ckpt.read") if verify
                else stream.load_npz(sp, fault_point="ckpt.read"))
    except FileNotFoundError as e:
        raise mft.CheckpointCorrupt(
            path, f"shard member {sp!r} is missing (torn or "
                  f"partially pruned {fs_count}-shard save)") from e
    out = {}
    with sctx as sz:
        if (int(sz["hash_capacity"]) != capacity
                or int(sz["fs_count"]) != fs_count
                or int(sz["row_lo"]) != lo
                or int(sz["row_hi"]) != hi):
            raise mft.CheckpointCorrupt(
                sp, f"shard geometry disagrees with its stub "
                    f"(expected rows [{lo}, {hi}) of {capacity} over "
                    f"{fs_count} shards)")
        for k in loaded:
            if k in sz.files:
                a = sz[k]
                if np.asarray(a).shape[0] != hi - lo:
                    raise mft.CheckpointCorrupt(
                        sp, f"array {k!r} has {np.asarray(a).shape[0]} "
                            f"rows, shard owns {hi - lo}")
                out[k] = a
        getattr(sz, "finish", lambda: None)()
    return out
