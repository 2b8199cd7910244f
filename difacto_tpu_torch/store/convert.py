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


def state_to_numpy(param: SGDUpdaterParam, state: SGDState,
                   keys=LOGICAL) -> dict:
    """Host numpy view of the logical columns ``keys`` of ``state``."""
    w, z, sg, cnt, live = scal_cols(param, state)
    cols = {"w": w, "z": z, "sqrt_g": sg, "cnt": cnt, "v_live": live}
    if "V" in keys or "Vg" in keys:
        if param.V_dim == 0:
            cols["V"] = cols["Vg"] = state.VVg
        elif quantized(param):
            cols["V"], cols["Vg"] = emb_cols_f32(param, state)
        else:
            k, h, _, _ = row_layout(param, state.capacity)
            cols["V"], cols["Vg"] = state.VVg[:, :k], state.VVg[:, h:h + k]
    out = {f: cols[f].cpu() for f in keys}
    for f in ("V", "Vg"):
        if f in out:
            out[f] = out[f].to(torch.float32)
    return {f: a.numpy() for f, a in out.items()}


def state_from_numpy(param: SGDUpdaterParam, arrays: dict,
                     device="cuda",
                     init: Optional[Callable[[int], SGDState]] = None,
                     min_capacity: Optional[int] = None) -> SGDState:
    """Device state from logical numpy columns (fused rows for V_dim > 0,
    the flat columns for V_dim == 0); absent columns are zero, capacity
    is the row count of ``w``.

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
    cap = int(np.asarray(arrays["w"]).shape[0])
    k = param.V_dim

    def col(name, shape, dtype=torch.float32):
        if name not in arrays:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return torch.as_tensor(np.asarray(arrays[name])).to(dev, dtype)

    w, z, sg, cnt = (col(n, (cap,)) for n in ("w", "z", "sqrt_g", "cnt"))
    live = col("v_live", (cap,), torch.bool)
    if k == 0:
        return SGDState(w=w, z=z, sqrt_g=sg, cnt=cnt, v_live=live,
                        VVg=torch.zeros((cap, 0), dtype=torch.float32,
                                        device=dev))
    T = build_rows(param, cap, col("V", (cap, k)), col("Vg", (cap, k)),
                   w, z, sg, cnt, live)
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
