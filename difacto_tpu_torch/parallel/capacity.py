"""Capacity scaling of the fs-sharded slot table (counterpart of
``capacity_scaling_report`` in difacto_tpu/parallel/capacity.py).

Key-range sharding is for capacity: an fs-way mesh over fs devices holds
an fs-times larger table at the same bytes per device. For each ``fs``
rung the report builds a ``base_capacity * fs``-row hashed table sharded
over a ``(1, fs)`` mesh, runs the port's train step (step.make_step_fns:
the sharded gather, the FM forward and backward, the sharded FTRL/AdaGrad
push) on a synthetic COO batch of uniform slot draws, and reports its
examples per second beside the bytes of each shard and of the device.
Each logical device of the mesh holds one shard, in allocations of its
own (parallel/sharded.ShardedState): ``table_bytes_per_device`` is read
from those allocations and is the JAX report's ``total // fs``, so it
stays flat as fs grows; the throughput is the cost of a larger table
routed over fs key ranges (on one card, every logical device shares its
memory and its time).

``bounded_delay_report`` (the JAX report's counterpart) drives the same
real fs-sharded train step through the windowed pipeline of multi-host
training (data/prefetch.py at depth ``2 + τ``) against simulated peer
clocks, and trains short real runs through the windowed schedule at each
τ to show the trajectory does not move.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from ..utils import devtrace


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

    from ..updaters.sgd_updater import state_bytes
    from ..utils.platform import logical_devices, resolve_device

    dev = resolve_device(device)
    n_dev = len(logical_devices(dev)[0])
    if fs_values is None:
        fs_values = [f for f in (1, 2, 4, 8) if f <= n_dev]
    skipped = [f for f in fs_values if f > n_dev]
    legs = []
    rng = np.random.RandomState(0)

    def fence(t):
        return float(devtrace.fetch(t, point="capacity.fence", fence=True))

    for fs in fs_values:
        if fs > n_dev:
            continue
        cap = base_capacity * fs
        param, train_step, store, b, slots = _synthetic_step(
            fs, base_capacity, V_dim, batch, nnz_per_row, v_dtype,
            slot_dtype, dev, rng)
        state, objv, _ = train_step(store.state, b, slots)   # warm
        fence(objv)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, objv, _ = train_step(state, b, slots)
        fence(objv)
        dt = time.perf_counter() - t0
        total = state_bytes(param, cap)
        per_device = max(store.device_bytes())
        legs.append({
            "fs": fs, "hash_capacity": cap,
            "table_bytes_total": int(total),
            "table_bytes_per_shard": int(total // fs),
            # one shard per logical device, read from its allocations
            "table_bytes_per_device": int(per_device),
            "examples_per_sec": round(steps * batch / dt, 1),
            "step_ms": round(dt / steps * 1e3, 3)})
        del state, store
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


def _synthetic_step(fs: int, base_capacity: int, V_dim: int, batch: int,
                    nnz_per_row: int, v_dtype: str, slot_dtype: str, dev,
                    rng):
    """(param, train_step, store, batch, slots) of a ``base_capacity *
    fs``-row hashed table sharded over a (1, fs) mesh and a synthetic COO
    batch of uniform slot draws from ``rng``."""
    import numpy as np
    import torch

    from ..data.rowblock import RowBlock
    from ..losses import create as create_loss
    from ..ops.batch import pad_batch
    from ..step import make_step_fns
    from ..store.local import SlotStore, pad_slots_oob
    from ..updaters.sgd_updater import SGDUpdaterParam, set_all_live
    from .mesh import make_mesh

    cap = base_capacity * fs
    param = SGDUpdaterParam(V_dim=V_dim, V_threshold=0, lr=0.1,
                            l1=1e-4, l2=1e-4, V_dtype=v_dtype,
                            hash_capacity=cap, slot_dtype=slot_dtype)
    store = SlotStore(param, device=dev,
                      mesh=make_mesh(dp=1, fs=fs, device=dev))
    if V_dim:
        store.state = set_all_live(param, store.state)
    _, train_step, _ = make_step_fns(store.fns, create_loss("fm", V_dim))
    # the timed step, traced under DIFACTO_JAXTRACE (the JAX reports'
    # pjit sites)
    train_step = devtrace.traced(train_step)
    u_cap = min(cap // 2, max(64, batch * nnz_per_row // 4))
    uniq = np.sort(rng.permutation(cap - 1)[:u_cap] + 1)
    host = pad_slots_oob(uniq.astype(np.int32), u_cap, cap)
    slots = store.shard_slots(torch.from_numpy(host).to(dev), host, cap)
    idx = rng.randint(0, u_cap, batch * nnz_per_row).astype(np.uint32)
    blk = RowBlock(
        offset=np.arange(batch + 1, dtype=np.int64) * nnz_per_row,
        label=rng.choice([0.0, 1.0], batch).astype(np.float32),
        index=idx, value=None)
    b = pad_batch(blk, num_uniq=u_cap, batch_cap=batch,
                  nnz_cap=batch * nnz_per_row, device=dev)
    return param, train_step, store, b, slots


def bounded_delay_report(hosts_values: Sequence[int] = (1, 2, 4),
                         taus: Sequence[int] = (0, 1, 4),
                         fs: int = 4, base_capacity: int = 1 << 12,
                         V_dim: int = 8, batch: int = 1024,
                         nnz_per_row: int = 8, steps: int = 8,
                         v_dtype: str = "float32",
                         slot_dtype: str = "fp32",
                         straggle_factor: float = 1.5,
                         auc_legs: bool = True, seed: int = 0,
                         device="cuda") -> dict:
    """Bounded-delay (τ) pipelining legs (the JAX report's, parallel/
    capacity.py:165-): one real fs-sharded train step is driven through
    the windowed pipeline (data/prefetch.prefetch at depth ``2 + τ``)
    against simulated peer clocks. For each ``hosts`` rung one straggler
    timeline ``peer_done[t]`` (the slowest of ``hosts - 1`` jittered
    peers, cumulative) is drawn once and reused for every τ, and the
    pipeline sleeps until ``peer_done[s - τ - 1]`` before staging step
    ``s``, the live schedule's ``wait_clock`` contract; the part drain
    joins the slowest peer's last step. A larger τ waits on an earlier
    clock of the same timeline, so the examples per second do not fall
    with τ, and the gap is the synchronization the window hides.
    ``auc_legs`` adds short real trainings through the windowed schedule
    at each τ (``auc_delta`` against τ=0)."""
    import numpy as np

    from ..data.prefetch import prefetch
    from ..utils.platform import logical_devices, resolve_device

    dev = resolve_device(device)
    n_dev = len(logical_devices(dev)[0])
    fs = min(fs, n_dev)
    _, step, store, b, slots = _synthetic_step(
        fs, base_capacity, V_dim, batch, nnz_per_row, v_dtype, slot_dtype,
        dev, np.random.RandomState(seed))
    state = store.state

    def fence(objv):
        return float(devtrace.fetch(objv, point="capacity.fence",
                                    fence=True))

    state, objv, _ = step(state, b, slots)      # warm
    fence(objv)
    n_base = max(2, steps // 2)
    t0 = time.perf_counter()
    for _ in range(n_base):
        state, objv, _ = step(state, b, slots)
    fence(objv)
    step_s = (time.perf_counter() - t0) / n_base

    legs = []
    for hosts in hosts_values:
        lrng = np.random.RandomState(seed * 1000 + hosts)
        jit = (lrng.uniform(0.0, straggle_factor * step_s,
                            size=(steps, hosts - 1)).max(axis=1)
               if hosts > 1 else np.zeros(steps))
        peer_done = np.cumsum(step_s + jit)
        for tau in taus:
            def exchange_sim(peer_done=peer_done, tau=tau, hosts=hosts):
                start = time.perf_counter()
                for s in range(steps):
                    need = s - tau - 1
                    if hosts > 1 and need >= 0:
                        rem = peer_done[need] - (time.perf_counter()
                                                 - start)
                        if rem > 0:
                            time.sleep(rem)
                    yield s
                if hosts > 1:
                    rem = peer_done[steps - 1] - (time.perf_counter()
                                                  - start)
                    if rem > 0:
                        time.sleep(rem)

            t0 = time.perf_counter()
            for _ in prefetch(exchange_sim(), depth=2 + tau):
                state, objv, _ = step(state, b, slots)
            fence(objv)
            dt = time.perf_counter() - t0
            legs.append({"hosts": hosts, "tau": tau,
                         "examples_per_sec": round(steps * batch / dt, 1),
                         "step_ms": round(dt / steps * 1e3, 3)})
    del state
    out = {"metric": "bounded_delay_pipelining", "n_devices": n_dev,
           "config": {"fs": fs, "base_capacity": base_capacity,
                      "V_dim": V_dim, "batch": batch,
                      "nnz_per_row": nnz_per_row, "steps": steps,
                      "V_dtype": v_dtype, "straggle_factor": straggle_factor,
                      "seed": seed},
           "base_step_ms": round(step_s * 1e3, 3), "legs": legs}
    h1 = [leg for leg in legs if leg["hosts"] == 1]
    hm = [leg for leg in legs if leg["hosts"] == max(hosts_values)]
    if h1 and hm and max(hosts_values) > 1:
        base1 = sum(leg["examples_per_sec"] for leg in h1) / len(h1)
        out["retention_by_tau"] = {
            str(leg["tau"]): round(leg["examples_per_sec"]
                                   / max(base1, 1e-9), 4) for leg in hm}
    if auc_legs:
        out["auc"] = _delay_auc_legs(taus, fs, n_dev, dev)
    return out


def _delay_auc_legs(taus: Sequence[int], fs: int, n_dev: int,
                    dev) -> list:
    """Short real trainings on synthetic data (the JAX report's 400 rows)
    through the windowed schedule at each τ; ``auc_delta`` against τ=0."""
    import os
    import tempfile

    import numpy as np

    dp = 2 if 2 * fs <= n_dev else 1
    if dp * fs > n_dev:
        return [{"skipped": f"needs {dp * fs} devices, have {n_dev}"}]
    rng = np.random.RandomState(7)
    rows, feats = 400, 1 << 12
    with tempfile.NamedTemporaryFile("w", suffix=".libsvm",
                                     delete=False) as f:
        w = rng.randn(64)
        for _ in range(rows):
            ks = np.sort(rng.choice(feats, rng.randint(4, 16),
                                    replace=False))
            y = 1 if w[ks % 64].sum() > 0 else 0
            f.write(str(y) + " " + " ".join(f"{k}:1" for k in ks) + "\n")
        path = f.name

    def train(tau: int) -> float:
        from ..learners.sgd import SGDLearner
        conf = {"data_in": path, "V_dim": "2", "V_threshold": "1",
                "lr": "0.1", "l1": "1e-4", "l2": "1e-4",
                "batch_size": "100", "max_num_epochs": "2",
                "shuffle": "0", "report_interval": "0",
                "stop_rel_objv": "0", "stop_val_auc": "-2",
                "num_jobs_per_epoch": "1", "hash_capacity": str(1 << 16),
                "mesh_dp": str(dp), "mesh_fs": str(fs),
                "bounded_delay": str(tau)}
        ln = SGDLearner(device=dev)
        ln.init(list(conf.items()))
        aucs: list = []
        ln.add_epoch_end_callback(
            lambda e, t, v: aucs.append(t.auc / max(t.nrows, 1.0)))
        ln.run()
        return float(aucs[-1])

    legs = []
    try:
        base = None
        for tau in sorted(set([0, *taus])):
            auc = train(tau)
            if tau == 0:
                base = auc
            legs.append({"tau": tau, "auc": round(auc, 6),
                         "auc_delta": round(auc - base, 6)})
    finally:
        os.unlink(path)
    return legs
