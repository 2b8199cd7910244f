"""Capacity scaling of the fs-sharded slot table (counterpart of
``capacity_scaling_report`` in difacto_tpu/parallel/capacity.py).

Key-range sharding is for capacity: an fs-way mesh over fs devices holds
an fs-times larger table at the same bytes per device. For each ``fs``
rung the report builds a ``base_capacity * fs``-row hashed table sharded
over a ``(1, fs)`` mesh, runs the port's train step (step.make_step_fns:
the sharded gather, the FM forward and backward, the sharded FTRL/AdaGrad
push) on a synthetic COO batch of uniform slot draws, and reports its
examples per second beside the bytes of each shard and of the device.
The port's mesh lies on one device (parallel/mesh.make_mesh), which holds
every shard: ``table_bytes_per_device`` is the whole table and grows with
fs, and the throughput is the cost of a larger table routed over fs key
ranges. ``bounded_delay_report`` belongs to multi-host training
(ROADMAP.md, item 11b).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence


def capacity_scaling_report(fs_values: Optional[Sequence[int]] = None,
                            base_capacity: int = 1 << 12,
                            V_dim: int = 8, batch: int = 1024,
                            nnz_per_row: int = 8, steps: int = 4,
                            v_dtype: str = "float32",
                            slot_dtype: str = "fp32",
                            device="cuda") -> dict:
    """One leg per fs rung: {fs, hash_capacity, table_bytes_total,
    table_bytes_per_shard, table_bytes_per_device, examples_per_sec,
    step_ms} and the JAX report's scaling summary. Rungs past the logical
    device count are skipped (``skipped_fs``)."""
    import numpy as np
    import torch

    from ..data.rowblock import RowBlock
    from ..losses import create as create_loss
    from ..ops.batch import pad_batch
    from ..step import make_step_fns
    from ..store.local import SlotStore, pad_slots_oob
    from ..updaters.sgd_updater import (SGDUpdaterParam, set_all_live,
                                        state_bytes)
    from ..utils.platform import logical_devices, resolve_device
    from .mesh import make_mesh

    dev = resolve_device(device)
    n_dev = len(logical_devices(dev)[0])
    if fs_values is None:
        fs_values = [f for f in (1, 2, 4, 8) if f <= n_dev]
    skipped = [f for f in fs_values if f > n_dev]
    legs = []
    rng = np.random.RandomState(0)

    def fence(t):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return float(t)

    for fs in fs_values:
        if fs > n_dev:
            continue
        cap = base_capacity * fs
        param = SGDUpdaterParam(V_dim=V_dim, V_threshold=0, lr=0.1,
                                l1=1e-4, l2=1e-4, V_dtype=v_dtype,
                                hash_capacity=cap, slot_dtype=slot_dtype)
        store = SlotStore(param, device=dev,
                          mesh=make_mesh(dp=1, fs=fs, device=dev))
        if V_dim:
            store.state = set_all_live(param, store.state)
        loss = create_loss("fm", V_dim)
        _, train_step, _ = make_step_fns(store.fns, loss)
        u_cap = min(cap // 2, max(64, batch * nnz_per_row // 4))
        uniq = np.sort(rng.permutation(cap - 1)[:u_cap] + 1)
        host = pad_slots_oob(uniq.astype(np.int32), u_cap, cap)
        slots = store.shard_slots(torch.from_numpy(host).to(dev), host,
                                  cap)
        idx = rng.randint(0, u_cap, batch * nnz_per_row).astype(np.uint32)
        blk = RowBlock(
            offset=np.arange(batch + 1, dtype=np.int64) * nnz_per_row,
            label=rng.choice([0.0, 1.0], batch).astype(np.float32),
            index=idx, value=None)
        b = pad_batch(blk, num_uniq=u_cap, batch_cap=batch,
                      nnz_cap=batch * nnz_per_row, device=dev)
        state, objv, _ = train_step(store.state, b, slots)   # warm
        fence(objv)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, objv, _ = train_step(state, b, slots)
        fence(objv)
        dt = time.perf_counter() - t0
        total = state_bytes(param, cap)
        legs.append({
            "fs": fs, "hash_capacity": cap,
            "table_bytes_total": int(total),
            "table_bytes_per_shard": int(total // fs),
            # every shard is on the mesh's one device
            "table_bytes_per_device": int(total),
            "examples_per_sec": round(steps * batch / dt, 1),
            "step_ms": round(dt / steps * 1e3, 3)})
        del store, state
    out = {"metric": "multichip_capacity_scaling", "n_devices": n_dev,
           "config": {"base_capacity": base_capacity, "V_dim": V_dim,
                      "batch": batch, "nnz_per_row": nnz_per_row,
                      "steps": steps, "V_dtype": v_dtype},
           "legs": legs, "skipped_fs": skipped}
    if legs:
        base, peak = legs[0], legs[-1]
        out["max_hash_capacity"] = peak["hash_capacity"]
        out["capacity_scaling"] = round(
            peak["hash_capacity"] / base["hash_capacity"], 3)
        out["throughput_retention"] = round(
            peak["examples_per_sec"] / max(base["examples_per_sec"], 1e-9),
            3)
        out["scaling_efficiency"] = round(
            (peak["hash_capacity"] / base["hash_capacity"])
            / max(peak["fs"] / base["fs"], 1e-9), 3)
    return out
