#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (difacto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths at the full width of
examples/criteo_hashed.conf (FM, V_dim 16, 4,194,304 hashed rows: a
2.0 GiB fp32 table on the card) with random weights and synthetic
Criteo rows made from a seed, and holds the CUDA kernels (the fused-row
gather and the scatter with its FTRL/AdaGrad epilogue) against their
plain PyTorch versions. Phases:

1. the card's name and power limit; build the kernels with nvcc, one
   thread (and one nvcc) per source, all started together;
2. the gather kernel against ``gather_rows_ref`` on the card, byte for
   byte: full-width fp32, bf16 and int8 containers, u_cap 8 / 12288 /
   49152 with out-of-bounds pad lanes, and an all-OOB slot vector;
3. ``task=pred``: write a seeded checkpoint with ``SlotStore.save``, open
   it with ``open_serving_store(device="cuda")``, score >= 20,000 rows in
   ``batch_size`` windows through the CLI's pred loop, check them against
   a float64 numpy FM over the logical arrays (1e-4), score again
   (bit-identical), and count the kernel's launches;
4. ``task=serve``: the port's ServeServer over the same store answers a
   pipelined window of rows that straddles two pred windows, equal to the
   pred file's probability column; ``#health`` answers ready;
5. the gather's device time (torch.profiler) at the main path's own slot
   vectors, its bound, the plain version's time and one
   ``torch.index_select`` as a yardstick;
6. the scatter kernel against ``fm_update_rows_ref`` / ``scatter_rows_ref``
   on the card, byte for byte, epilogue on and off: fp32, bf16, int8 and
   fp8 containers; the in-pad layout, the appended layout with its gap
   lanes (the main path's full-width [4,194,304 x 128] fp32 table) and
   the appended V_dim 64 layout; u_cap 8 / 12288 / 49152 with OOB pads
   and an all-OOB vector (table unchanged);
7. ``task=train`` through the port's learner at full width: 50,000
   synthetic train and 10,000 validation rows, 2 epochs, ``has_aux=1
   model_out=...``. The objective per row falls from epoch 0 to 1; the
   launch counts match the batches (one gather and one scatter per step,
   one more of each per epoch-0 batch for the count push, one gather per
   validation block); a second run leaves a bit-identical table, and a
   third with the kernels swapped for their plain versions the same
   table again; the saved model scored through phase 3's pred path is
   within 1e-4 of a float64 numpy FM over the saved arrays;
8. a train step's host wall time, device busy time, idle share, kernels
   per step and top device entries (torch.profiler over 5 steps), and the
   scatter kernel's device time at the main path's own slot vectors,
   beside its bound, the plain version and one ``index_copy_`` of the
   precomputed new rows as a yardstick.

Prints one JSON line of kernel numbers, then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when there is no CUDA device, when the port is not beside it, or when any
phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 20240613
CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "examples", "criteo_hashed.conf")
N_ROWS = 20_000
N_TRAIN, N_VAL = 50_000, 10_000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 rate
KERNELS = {
    "gather_rows": ("difacto_tpu_torch/ops/csrc/gather_rows.cu",
                    "difacto_tpu/ops/fused.py:254"),
    "scatter_epilogue": ("difacto_tpu_torch/ops/csrc/scatter_epilogue.cu",
                         "difacto_tpu/ops/fused.py:337"),
}
DEV = "cuda"                # "cpu" only in a rehearsal off the card


def sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ data
def synthetic_model(C: int, k: int, seed: int) -> dict:
    """Logical arrays of a trained-looking hashed FM: ~30% of w zeroed
    (l1), ~half the embeddings live."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(C) * 0.05).astype(np.float32)
    w[rng.rand(C) < 0.3] = 0.0
    w[0] = 0.0                                   # the trash row
    return {"w": w,
            "cnt": rng.randint(0, 100, C).astype(np.float32),
            "v_live": rng.rand(C) < 0.5,
            "V": ((rng.rand(C, k) - 0.5) * 0.2).astype(np.float32)}


def synthetic_criteo(n: int, seed: int) -> bytes:
    """Criteo-format text: label, 13 integer fields, 26 categorical hex
    fields; zipf-distributed values, ~2% empty fields."""
    rng = np.random.RandomState(seed)
    ints = np.minimum(rng.zipf(1.5, (n, 13)), 10 ** 6) - 1
    cats = np.minimum(rng.zipf(1.2, (n, 26)), 1 << 24) \
        + np.arange(26) * (1 << 25)
    empty = rng.rand(n, 39) < 0.02
    labels = (rng.rand(n) < 0.25).astype(int)
    lines = []
    for i in range(n):
        f = [str(v) for v in ints[i]] + [format(v, "08x") for v in cats[i]]
        f = ["" if e else s for s, e in zip(f, empty[i])]
        lines.append(str(labels[i]) + "\t" + "\t".join(f))
    return ("\n".join(lines) + "\n").encode()


def reference_margins(text: bytes, arrays: dict, hash_capacity: int,
                      l1_shrk: bool = True) -> np.ndarray:
    """float64 numpy FM over the logical arrays, straight from the
    formula (the reference's fm_loss.h): every nonzero of a row adds
    w[slot] and V[slot] (masked by live & w != 0)."""
    from difacto_tpu_torch.base import reverse_bytes
    from difacto_tpu_torch.data.parsers import parse_criteo
    from difacto_tpu_torch.store.local import hash_slots
    blk = parse_criteo(text)
    slot = hash_slots(reverse_bytes(blk.index), hash_capacity)
    w = arrays["w"].astype(np.float64)[slot]
    live = arrays["v_live"][slot]
    if l1_shrk:
        live = live & (arrays["w"][slot] != 0)
    V = arrays["V"].astype(np.float64)[slot] * live[:, None]
    row = np.repeat(np.arange(blk.size), np.diff(blk.offset))
    lin = np.bincount(row, weights=w, minlength=blk.size)
    XV = np.zeros((blk.size, V.shape[1]))
    XXVV = np.zeros_like(XV)
    np.add.at(XV, row, V)
    np.add.at(XXVV, row, V * V)
    return np.clip(lin + 0.5 * (XV ** 2 - XXVV).sum(1), -20.0, 20.0)


# ------------------------------------------------------------ timing
def device_ms(fn, args_list, rounds: int = 5):
    """Mean device time of ``fn(*args)``: the CUDA kernels' own durations
    from torch.profiler (CUPTI), summed per call — the work on the card
    without the host's launch gaps. Raises when the profiler records no
    device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for a in args_list:
        fn(*a)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for a in args_list:
                fn(*a)
        sync()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device activity: "
                           "the kernels cannot be timed on this card")
    return us / 1e3 / (rounds * len(args_list))


# ------------------------------------------------------------ phases
def phase_card() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from concurrent.futures import ThreadPoolExecutor
    from difacto_tpu_torch.ops import build
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.library, KERNELS))
    log(f"phase 1 ok: kernels built in {time.monotonic() - t0:.2f} s")
    for name in KERNELS:
        for ln in build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {name}: " + ln.strip())
    return line


def _slot_vector(C: int, n_real: int, u: int, gen, dev):
    import torch
    from difacto_tpu_torch.store.local import pad_slots_oob
    real = torch.randperm(C, generator=gen, device=dev)[:n_real]
    real = torch.sort(real).values.to(torch.int32).cpu().numpy()
    return torch.from_numpy(pad_slots_oob(real, u, C)).to(dev)


def phase_kernel_vs_plain(C: int) -> float:
    """Byte-exact kernel vs plain gather; returns the max abs difference
    seen over the fp32 compares (0.0 when every byte agrees)."""
    import torch
    from difacto_tpu_torch.ops import fused
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for name, bits, dt in (("fp32", torch.int32, torch.float32),
                           ("bf16", torch.int16, torch.bfloat16),
                           ("int8", torch.int8, torch.int8)):
        info = torch.iinfo(bits)
        table = torch.randint(info.min, info.max, (C, 128), dtype=bits,
                              generator=gen, device=dev).view(dt)
        cases = [(u, n) for u, n in ((8, 5), (12288, 9000), (49152, 40000),
                                     (12288, 0)) if n < C]
        for u, n_real in cases:
            slots = _slot_vector(C, n_real, u, gen, dev)
            got = fused.gather_rows(table, slots)
            want = fused.gather_rows_ref(table, slots)
            sync()
            same = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            if dt == torch.float32:
                fin = torch.isfinite(got) & torch.isfinite(want)
                diff = (got[fin] - want[fin]).abs()
                worst = max(worst, float(diff.max()) if diff.numel() else 0.)
            log(f"  {name} C={C} u_cap={u} real={n_real}: "
                f"{'bit-exact' if same else 'MISMATCH'}")
            if not same:
                raise AssertionError(f"gather kernel != plain on {name} "
                                     f"u_cap={u}")
        del table
    torch.cuda.empty_cache()
    log("phase 2 ok: gather kernel bit-exact with its plain version")
    return worst


def phase_pred(work: str, kwargs: list, uparam, arrays: dict, text: bytes):
    """Save, open, score through the CLI pred loop, check."""
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.data.parsers import parse_criteo
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.serve import PredictExecutor, open_serving_store
    from difacto_tpu_torch.store.convert import state_from_numpy
    from difacto_tpu_torch.store.local import SlotStore

    t0 = time.monotonic()
    writer = SlotStore(uparam, device=DEV)
    writer.state = state_from_numpy(uparam, arrays, device=DEV)
    model = os.path.join(work, "model_part-0")
    nnz_w = writer.save(model)
    del writer
    torch.cuda.empty_cache()
    store, meta, _ = open_serving_store(os.path.join(work, "model"),
                                        device=DEV)
    table = store.state.VVg
    log(f"  checkpoint: {meta}, {nnz_w} non-zero w; table "
        f"{tuple(table.shape)} {table.dtype} "
        f"{table.numel() * table.element_size() / 2 ** 30:.2f} GiB on "
        f"{table.device}; save+open {time.monotonic() - t0:.1f} s")

    data = os.path.join(work, "criteo.txt")
    with open(data, "wb") as f:
        f.write(text)
    pred_out = os.path.join(work, "pred")
    fused.gather_rows_cuda.launches = 0
    t0 = time.monotonic()
    run_pred(kwargs + [("data_in", data), ("pred_out", pred_out)],
             device=DEV, store=store)
    sync()
    pred_s = time.monotonic() - t0
    launches = fused.gather_rows_cuda.launches
    with open(pred_out + "_part-0", "rb") as f:
        lines = f.read().splitlines()
    if len(lines) != N_ROWS:
        raise AssertionError(f"pred file has {len(lines)} rows, want "
                             f"{N_ROWS}")
    if launches <= 0:
        raise AssertionError("task=pred never launched the gather kernel")

    # float64 reference, and a second scoring of every window
    ref = reference_margins(text, arrays, uparam.hash_capacity)
    probs = np.array([float(l.split(b"\t")[1]) for l in lines])
    p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref))).max())
    blk = parse_criteo(text)
    bs = int(dict(kwargs).get("batch_size", 1000))
    ex1, ex2 = PredictExecutor(store), PredictExecutor(store)
    m_err, windows = 0.0, []
    for s in range(0, blk.size, bs):
        sub = blk.slice(s, min(s + bs, blk.size))
        a = ex1.predict_scores(sub)
        b = ex2.predict_scores(sub)
        if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
            raise AssertionError(f"window {s}: repeat scores differ")
        m_err = max(m_err, float(np.abs(a - ref[s:s + len(a)]).max()))
        windows.append(sub)
    if not (np.isfinite(probs).all() and m_err <= 1e-4 and p_err <= 1e-4):
        raise AssertionError(f"pred vs float64 reference: margin err "
                             f"{m_err}, prob err {p_err} (limit 1e-4)")
    log(f"  pred: {len(lines)} rows in {pred_s:.2f} s "
        f"({len(lines) / pred_s:.0f} rows/s incl. host parse), "
        f"{launches} gather launches, max |margin - f64| {m_err:.3g}, "
        f"max |prob - f64| {p_err:.3g}, repeat bit-identical, "
        f"shape caps {ex1.shapes.snapshot()}")
    log("phase 3 ok: task=pred at full width matches the float64 reference")
    return store, lines, launches, windows


def phase_serve(store, lines, text: bytes, batch: int) -> int:
    import torch
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.serve import ServeServer
    # a window that straddles two pred windows: each row is scored in
    # other company than in the pred file, so equal answers show that a
    # row's score does not depend on its batch
    lo = batch // 2
    rows = text.splitlines()[lo:lo + batch]
    fused.gather_rows_cuda.launches = 0
    srv = ServeServer(store, batch_size=batch, max_delay_ms=2000.0,
                      queue_cap=4 * batch, data_format="criteo").start()
    try:
        with socket.create_connection((srv.host, srv.port), timeout=120) \
                as c:
            c.sendall(b"".join(r + b"\n" for r in rows) + b"#health\n")
            f = c.makefile("rb")
            got = [f.readline().rstrip(b"\n") for _ in rows]
            health = json.loads(f.readline())
            c.sendall(b"#stats\n")
            stats = json.loads(f.readline())
    finally:
        srv.close()
    sync()
    launches = fused.gather_rows_cuda.launches
    want = [l.split(b"\t")[1] for l in lines[lo:lo + batch]]
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        raise AssertionError(f"serve answers differ from the pred column "
                             f"on {bad} of {len(want)} rows")
    if health.get("status") != "ready":
        raise AssertionError(f"#health answered {health}")
    if launches <= 0:
        raise AssertionError("task=serve never launched the gather kernel")
    log(f"  serve: rows {lo}:{lo + len(got)} (straddling pred windows) "
        f"answered in {stats['batches']} "
        f"micro-batch(es), p50 {stats.get('p50_ms')} ms, p99 "
        f"{stats.get('p99_ms')} ms, {launches} gather launches, "
        f"#health {health['status']}")
    log("phase 4 ok: task=serve answers equal the pred column")
    return launches


def phase_measure(store, windows) -> dict:
    """The kernel at the main path's own slot vectors (one per pred
    window, cycled so that repeats see the cache as the stream does)."""
    import torch
    from difacto_tpu_torch.data.localizer import compact
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.ops.batch import bucket
    from difacto_tpu_torch.store.local import pad_slots_oob
    table = store.state.VVg
    C, W = table.shape
    row_bytes = W * table.element_size()
    real_slots = []
    for sub in windows:
        _, uniq = compact(sub)
        real_slots.append(np.unique(store.map_keys(uniq)).astype(np.int32))
    # the executor's sticky cap: the bucket of the largest window
    u_cap = bucket(max(len(s) for s in real_slots))
    vecs = [(table, torch.from_numpy(pad_slots_oob(s, u_cap, C)).to(DEV))
            for s in real_slots]
    prefixes = [(table, torch.from_numpy(s).to(DEV)) for s in real_slots]
    def library(t, s):
        return torch.index_select(t, 0, s)

    ms, plain_ms, library_ms = (
        device_ms(fn, args) for fn, args in (
            (fused.gather_rows_cuda, vecs), (fused.gather_rows_ref, vecs),
            (library, prefixes)))
    for t, s in vecs[:4]:
        if not torch.equal(fused.gather_rows_cuda(t, s).view(torch.uint8),
                           fused.gather_rows_ref(t, s).view(torch.uint8)):
            raise AssertionError("kernel != plain on a main-path vector")
    real = float(np.mean([len(s) for s in real_slots]))
    moved = real * row_bytes + u_cap * row_bytes + 4 * u_cap
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"  gather at the main path's shape: table [{C}, {W}] "
        f"{table.dtype}, u_cap {u_cap}, {real:.0f} real rows on average: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({moved / 1e6:.2f} MB at 3.35 TB/s) -> "
        f"{bound_ms / ms:.1%} of the bound")
    profile_predict(store, windows[:5])
    log("phase 5 ok: measured")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "u_cap": u_cap}


def profile_predict(store, windows) -> None:
    """Where a predict window's time goes: host wall time vs the card's
    busy time (sum of kernel durations), and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from difacto_tpu_torch.serve import PredictExecutor
    ex = PredictExecutor(store)
    for sub in windows:
        ex.predict_scores(sub)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for sub in windows:
            ex.predict_scores(sub)
        sync()
        wall = (time.perf_counter() - t0) * 1e3 / len(windows)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / len(windows)
    log(f"  predict window (1000 rows): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({1 - busy / wall:.1%} idle), "
        f"{sum(e.count for e in dev) / len(windows):.0f} kernels")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3 / len(windows):8.4f} ms "
            f"x{e.count // len(windows):4d}  {e.key[:90]}")


# ------------------------------------------------------------ training
def _seeded_table(param, C: int, seed: int):
    """[C, Wx] fused rows built on the card from seeded values: V with
    all-zero halves on every 7th row, w zero on every 3rd, z spread
    around l1, cnt around V_threshold, live half the rows."""
    import torch
    from difacto_tpu_torch.updaters import sgd_updater as T
    gen = torch.Generator(device=DEV).manual_seed(seed)
    k = param.V_dim

    def r(*shape):
        return torch.rand(shape, generator=gen, device=DEV)
    V = (r(C, k) - 0.5) * 0.2
    V[::7] = 0.0
    w = r(C) - 0.5
    w[::3] = 0.0
    thr = float(param.V_threshold)
    return T.build_rows(param, C, V, r(C, k) * 2.0, w,
                        (r(C) - 0.5) * 4.0 * max(param.l1, 0.5),
                        r(C) * 2.0, torch.floor(r(C) * 2.0 * thr + 1.0),
                        r(C) < 0.5)


def _step_inputs(k: int, u: int, seed: int):
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed)
    gw = torch.randn(u, generator=gen, device=DEV) * 0.3
    gV = torch.randn(u, k, generator=gen, device=DEV) * 0.1
    vmask = (torch.rand(u, generator=gen, device=DEV) < 0.6).float()
    return gw, gV, vmask


def phase_scatter_vs_plain(uparam) -> float:
    """Byte-exact scatter kernel vs its plain version, epilogue on and
    off; returns the max abs difference over the fp32 compares."""
    import dataclasses
    import torch
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.updaters import sgd_updater as T
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    worst = 0.0
    for layout, kw in (("in-pad", dict(V_dim=16, pad_v_rows=True)),
                       ("appended+gap", dict(V_dim=16, pad_v_rows=False)),
                       ("appended V64", dict(V_dim=64, pad_v_rows=False))):
        for kind in ("fp32", "bf16", "int8", "fp8"):
            full = layout == "appended+gap" and kind == "fp32"
            # the main path's full table, else a small one
            C = uparam.hash_capacity if full \
                else min(65536, uparam.hash_capacity)
            param = dataclasses.replace(uparam, slot_dtype=kind,
                                        hash_capacity=C, **kw)
            table = _seeded_table(param, C, SEED + 7)
            epi = T.epilogue_spec(param, C)
            plain = functools.partial(T.row_epilogue, param, C)
            rows_src = _seeded_table(param, 49152, SEED + 8)
            for u, n_real in ((8, 5), (12288, 11700), (49152, 40000),
                              (12288, 0)):
                slots = _slot_vector(C, n_real, u, gen, DEV)
                rows = rows_src[:u].contiguous()
                gw, gV, vm = _step_inputs(param.V_dim, u, SEED + u)
                for on in (True, False):
                    got, want = table.clone(), table.clone()
                    if on:
                        fused.fm_update_rows(got, slots, rows, gw, gV, vm,
                                             epi, plain)
                        fused.fm_update_rows_ref(want, slots, rows, gw, gV,
                                                 vm, plain)
                    else:
                        fused.scatter_rows(got, slots, rows)
                        fused.scatter_rows_ref(want, slots, rows)
                    sync()
                    same = torch.equal(got.view(torch.uint8),
                                       want.view(torch.uint8))
                    if n_real == 0:
                        same = same and torch.equal(got.view(torch.uint8),
                                                    table.view(torch.uint8))
                    if kind == "fp32":
                        fin = torch.isfinite(got) & torch.isfinite(want)
                        d = (got[fin] - want[fin]).abs()
                        worst = max(worst, float(d.max()) if d.numel()
                                    else 0.0)
                    if not same:
                        raise AssertionError(
                            f"scatter kernel != plain: {layout} {kind} "
                            f"C={C} u_cap={u} real={n_real} "
                            f"epilogue={'on' if on else 'off'}")
                    del got, want
            log(f"  {layout} {kind} [{C} x {table.shape[1]}] "
                f"{table.dtype}: u_cap 8/12288/49152/all-OOB, epilogue "
                "on and off: bit-exact")
            del table, rows_src
            torch.cuda.empty_cache()
    log("phase 6 ok: scatter kernel bit-exact with its plain version")
    return worst


def _count_batches(p, data_in: str, data_val: str, epochs: int):
    """(train batches per epoch, validation blocks per epoch) the
    learner's readers will cut, counted with the same readers."""
    from difacto_tpu_torch.data.batch_reader import BatchReader
    from difacto_tpu_torch.data.reader import Reader
    n = p.num_jobs_per_epoch
    train = [sum(1 for part in range(n) for _ in BatchReader(
        data_in, p.data_format, part, n, p.batch_size,
        p.batch_size * p.shuffle, p.neg_sampling, seed=e * n + part))
        for e in range(epochs)]
    val = sum(1 for _ in Reader(data_val, p.data_format, 0, 1,
                                chunk_bytes=256 << 20))
    return train, val


def _train(kwargs: list):
    """One ``task=train`` run through the learner: (learner, per-epoch
    training progress)."""
    from difacto_tpu_torch.learners.sgd import SGDLearner
    ln = SGDLearner(device=DEV)
    ln.init(list(kwargs))
    progress = []
    ln.add_epoch_end_callback(lambda k, t, v: progress.append((t, v)))
    ln.run()
    sync()
    return ln, progress


def phase_train(work: str, conf: list, uparam) -> dict:
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.learners.sgd import SGDLearnerParam
    from difacto_tpu_torch.ops import fused
    t0 = time.monotonic()
    data_in = os.path.join(work, "train.txt")
    data_val = os.path.join(work, "val.txt")
    with open(data_in, "wb") as f:
        f.write(synthetic_criteo(N_TRAIN, SEED + 2))
    val_text = synthetic_criteo(N_VAL, SEED + 3)
    with open(data_val, "wb") as f:
        f.write(val_text)
    model = os.path.join(work, "trained")
    kwargs = conf + [("data_in", data_in), ("data_val", data_val),
                     ("max_num_epochs", "2"), ("stop_rel_objv", "0"),
                     ("stop_val_auc", "-2")]
    lp, _ = SGDLearnerParam.init_allow_unknown(kwargs)
    train_b, val_b = _count_batches(lp, data_in, data_val, 2)
    log(f"  {N_TRAIN} train + {N_VAL} validation rows written in "
        f"{time.monotonic() - t0:.1f} s: {train_b} train batches per "
        f"epoch, {val_b} validation block(s)")

    counters = (fused.gather_rows_cuda, fused.fm_update_rows_cuda,
                fused.scatter_rows_cuda)
    for c in counters:
        c.launches = 0
    t0 = time.monotonic()
    ln, progress = _train(kwargs + [("has_aux", "1"), ("model_out", model)])
    train_s = time.monotonic() - t0
    launches = {c.__name__: c.launches for c in counters}
    want = {"gather_rows_cuda": sum(train_b) + train_b[0] + 2 * val_b,
            "fm_update_rows_cuda": sum(train_b),
            "scatter_rows_cuda": train_b[0]}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, the batches need "
                             f"{want}")
    loss = [t.loss / t.nrows for t, _ in progress]
    if not (len(loss) == 2 and np.isfinite(loss).all()
            and loss[1] < loss[0]):
        raise AssertionError(f"objective per row did not fall: {loss}")
    first = ln.store.state.VVg.clone()
    table = ln.store.state.VVg
    log(f"  run 1: {train_s:.1f} s for 2 epochs, loss/row {loss[0]:.6f} -> "
        f"{loss[1]:.6f}, val AUC "
        f"{[round(v.auc / max(v.nrows, 1), 6) for _, v in progress]}, "
        f"launches {launches} (as the batches need)")
    del ln, table
    torch.cuda.empty_cache()

    ln, _ = _train(kwargs)
    if not torch.equal(ln.store.state.VVg.view(torch.int32),
                       first.view(torch.int32)):
        raise AssertionError("a second training run left another table")
    del ln
    torch.cuda.empty_cache()
    log("  run 2: final table bit-identical to run 1")

    def plain_push(table, slots, rows, gw, gV, vmask, epi, epilogue):
        return fused.fm_update_rows_ref(table, slots, rows, gw, gV, vmask,
                                        epilogue)

    saved = (fused.gather_rows, fused.fm_update_rows, fused.scatter_rows)
    for c in counters:
        c.launches = 0
    fused.gather_rows = fused.gather_rows_ref
    fused.fm_update_rows = plain_push
    fused.scatter_rows = fused.scatter_rows_ref
    try:
        ln, _ = _train(kwargs)
    finally:
        fused.gather_rows, fused.fm_update_rows, fused.scatter_rows = saved
    if any(c.launches for c in counters):
        raise AssertionError("the run on the plain versions launched a "
                             "kernel")
    if not torch.equal(ln.store.state.VVg.view(torch.int32),
                       first.view(torch.int32)):
        raise AssertionError("the run on the plain versions left another "
                             "table than the kernels")
    log("  run 3 (gather/scatter swapped for their plain versions): final "
        "table bit-identical to run 1")
    del first

    # the saved model through phase 3's pred path vs a float64 FM
    with np.load(model + "_part-0") as z:
        arrays = {f: z[f] for f in ("w", "V", "v_live")}
    pred_out = os.path.join(work, "trained_pred")
    run_pred(conf + [("model_in", model), ("data_in", data_val),
                     ("pred_out", pred_out)], device=DEV)
    with open(pred_out + "_part-0", "rb") as f:
        probs = np.array([float(l.split(b"\t")[1])
                          for l in f.read().splitlines()])
    ref = reference_margins(val_text, arrays, uparam.hash_capacity)
    p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref))).max())
    if len(probs) != N_VAL or not p_err <= 1e-4:
        raise AssertionError(f"trained model's pred vs float64 FM: "
                             f"{len(probs)} rows, prob err {p_err}")
    log(f"  saved model: {int((arrays['w'] != 0).sum())} non-zero w, "
        f"{int(arrays['v_live'].sum())} live embeddings; task=pred over the "
        f"validation rows within {p_err:.3g} of the float64 FM")
    log("phase 7 ok: task=train at full width, deterministic, kernels = "
        "plain versions")
    return {"launches": launches, "learner": ln, "data_in": data_in,
            "kwargs": kwargs}


def phase_measure_train(ln, data_in: str) -> dict:
    """A train step's time budget and the scatter kernel at the main
    path's own inputs (the trained table, 5 batches of epoch 1)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from difacto_tpu_torch.data.batch_reader import BatchReader
    from difacto_tpu_torch.data.pack_stream import (ShapeSchedule,
                                                    prepare_hashed)
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.ops.batch import bucket, unpack_panel
    from difacto_tpu_torch.updaters.sgd_updater import (epilogue_spec,
                                                        row_epilogue)
    p, store = ln.param, ln.store
    C = store.param.hash_capacity
    shapes = ShapeSchedule()
    blocks, n = [], p.num_jobs_per_epoch
    for part in range(n):                 # epoch 1's full batches
        blocks += [b for b in BatchReader(
            data_in, p.data_format, part, n, p.batch_size,
            p.batch_size * p.shuffle, seed=n + part)
            if b.size == p.batch_size]
        if len(blocks) >= 5:
            break
    blocks = blocks[:5]
    payloads = [prepare_hashed(shapes, C, b, False, False, 8, "train",
                               bucket(p.batch_size, 8)) for b in blocks]

    def step(pl):
        i32 = torch.from_numpy(pl.i32).to(DEV)
        f32 = torch.from_numpy(pl.f32).to(DEV)
        batch, slots, _ = unpack_panel(i32, f32, pl.b_cap, pl.d2, pl.u_cap,
                                       binary=pl.binary)
        store.state, objv, auc = ln._train_step(store.state, batch, slots)
        return objv

    if any(pl.layout != "panel" for pl in payloads):
        raise AssertionError("the Criteo batches did not pack as panels")
    for pl in payloads:
        step(pl)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pl in payloads:
            step(pl)
        sync()
        wall = (time.perf_counter() - t0) * 1e3 / len(payloads)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / len(payloads)
    if DEV == "cuda" and busy <= 0:
        raise RuntimeError("torch.profiler recorded no device activity")
    kernels = sum(e.count for e in dev) / len(payloads)
    log(f"  train step (1000 Criteo rows, u_cap {payloads[0].u_cap}): wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms "
        f"({1 - busy / wall:.1%} idle), {kernels:.0f} kernels per step")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3 / len(payloads):8.4f} ms "
            f"x{e.count // len(payloads):4d}  {e.key[:90]}")

    # the scatter kernel at the main path's own inputs
    from difacto_tpu_torch.losses import FMParams
    epi = epilogue_spec(store.param, C)
    plain = functools.partial(row_epilogue, store.param, C)
    table = store.state.VVg
    args, plain_args, lib_args, n_real = [], [], [], []
    for pl in payloads:
        i32 = torch.from_numpy(pl.i32).to(DEV)
        f32 = torch.from_numpy(pl.f32).to(DEV)
        batch, slots, _ = unpack_panel(i32, f32, pl.b_cap, pl.d2, pl.u_cap,
                                       binary=pl.binary)
        fns = store.fns
        rows = fns.pull_rows(store.state, slots)
        w, V, vm = fns.rows_to_params(store.state, rows)
        params = FMParams(w=w, V=V, v_mask=vm)
        pred, xv = ln.loss.predict_xv(params, batch)
        gw, gV = ln.loss.calc_grad(params, batch, pred, xv)
        gw, gV = gw.contiguous(), gV.contiguous()
        args.append((table, slots, rows, gw, gV, vm, epi))
        plain_args.append((table, slots, rows, gw, gV, vm, plain))
        n = int((slots < C).sum())
        n_real.append(n)
        new = row_epilogue(store.param, C, rows, gw, gV, vm)
        lib_args.append((table, slots[:n].long(), new[:n].contiguous()))

    def library(t, s, r):
        return t.index_copy_(0, s, r)

    ms, plain_ms, library_ms = (
        device_ms(fn, a) for fn, a in (
            (fused.fm_update_rows_cuda, args),
            (fused.fm_update_rows_ref, plain_args), (library, lib_args)))
    u_cap = payloads[0].u_cap
    row_bytes = table.shape[1] * table.element_size()
    real = float(np.mean(n_real))
    k = store.param.V_dim
    moved = 4 * u_cap + real * (2 * row_bytes + 4 * (2 + k))
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"  scatter+epilogue at the main path's shape: table [{C}, "
        f"{table.shape[1]}] {table.dtype}, u_cap {u_cap}, {real:.0f} real "
        f"rows on average: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"index_copy_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({moved / 1e6:.2f} MB at 3.35 TB/s) -> "
        f"{bound_ms / ms:.1%} of the bound")
    log("phase 8 ok: measured")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "wall_ms": wall, "busy_ms": busy,
            "kernels_per_step": kernels}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        import difacto_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run it "
              "from the root of the repository", file=sys.stderr)
        return 2
    from difacto_tpu_torch.config import parse_config_file
    from difacto_tpu_torch.updaters.sgd_updater import SGDUpdaterParam

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_card()
        conf = parse_config_file(CONF)
        if DEV == "cpu":        # a rehearsal's table: the CPU holds less
            conf.append(("hash_capacity", "8192"))
        uparam, rest = SGDUpdaterParam.init_allow_unknown(conf)
        C, k = uparam.hash_capacity, uparam.V_dim
        batch = int(dict(rest)["batch_size"])
        log(f"config {CONF}: V_dim {k}, hash_capacity {C}, batch_size "
            f"{batch}, data_format {dict(rest)['data_format']} (mesh keys "
            "ignored: one card)")
        gather_err = phase_kernel_vs_plain(C)
        t0 = time.monotonic()
        arrays = synthetic_model(C, k, SEED)
        text = synthetic_criteo(N_ROWS, SEED + 1)
        log(f"  synthetic model + {N_ROWS} criteo rows in "
            f"{time.monotonic() - t0:.1f} s")
        store, lines, pred_launches, windows = phase_pred(
            work, conf, uparam, arrays, text)
        serve_launches = phase_serve(store, lines, text, batch)
        g = phase_measure(store, windows)
        del store, arrays
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        scatter_err = phase_scatter_vs_plain(uparam)
        tr = phase_train(work, conf, uparam)
        m = phase_measure_train(tr["learner"], tr["data_in"])
        if "jax" in sys.modules or "difacto_tpu" in sys.modules:
            raise AssertionError("the smoke imported JAX or difacto_tpu")
        tl = tr["launches"]
        kernels = []
        for name, launches, err, t in (
                ("gather_rows", pred_launches + serve_launches
                 + tl["gather_rows_cuda"], gather_err, g),
                ("scatter_epilogue", tl["fm_update_rows_cuda"]
                 + tl["scatter_rows_cuda"], scatter_err, m)):
            kernels.append({
                "name": name, "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1], "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": "bytes",
                "library_ms": t["library_ms"]})
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
