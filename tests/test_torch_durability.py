"""The port's durable training state against the JAX package's, on the
CPU: the write-ahead delta log, peer replicas and the recovery ladder.

- WAL segments are byte-identical to JAX's for the same meta and rows
  (fp32 fused rows, the flat columns, bf16, int8 and fp8 containers), and
  each package reads the other's; the corrupt-segment matrix (torn tail,
  bit flip, bad magic, short file) raises the typed ``WalCorrupt``;
- the writer's rebase and adopt keep JAX's chain; ``wal_touched_rows`` /
  ``apply_wal_rows`` round-trip bit for bit; replay applies a chain to
  its head and stops typed (gap, torn, geometry) at the verified prefix,
  on the same segments JAX wrote;
- the learner's gates raise JAX's texts; a WAL-on run leaves the WAL-off
  run's model bit for bit;
- each armed fault point (``wal.append`` err and truncate, ``wal.replay``
  truncate, ``replica.push`` err then the scrub, ``replica.fetch`` err
  then the next peer) degrades as in JAX;
- ``prune_checkpoints(protect=)`` removes what JAX's removes, ``ckpt_keep``
  never retires the live WAL base, the replicator's lag gauge drains;
- the ladder's ``wal`` rung (a mid-window crash) and its ``peer`` + ``wal``
  rungs after a disk loss, simulated in process, finish with the model of
  an unkilled run bit for bit. The real SIGKILL runs in chip_smoke.py
  phase 15.
"""

import glob
import json
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from difacto_tpu.durability import wal as jwal
from difacto_tpu.learners.sgd import SGDLearner as JLearner
from difacto_tpu.store.local import SlotStore as JStore
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu.utils import faultinject as jfi
from difacto_tpu.utils import manifest as jmft
from difacto_tpu_torch.__main__ import main
from difacto_tpu_torch.durability import replicate, wal
from difacto_tpu_torch.durability.replicate import Replicator
from difacto_tpu_torch.durability.wal import WalCorrupt, WalWriter
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.store.local import K_FEACOUNT, K_GRADIENT, SlotStore
from difacto_tpu_torch.updaters import sgd_updater as T
from difacto_tpu_torch.utils import faultinject
from difacto_tpu_torch.utils import manifest as mft

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(_ROOT, "tests", "data", "rcv1_100.libsvm")
FLUSH = 4


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faultinject.configure("")
    jfi.configure("")


def train_args(model, epochs=3, extra=()):
    """rcv1's 100 rows in batches of 10: a FLUSH=4 window seals at steps
    4, 8 and the epoch boundary (10)."""
    return [f"data_in={RCV1}", "lr=1", "l1=1", "l2=1", "batch_size=10",
            f"max_num_epochs={epochs}", "shuffle=0", "num_jobs_per_epoch=1",
            "report_interval=0", "stop_rel_objv=0", "hash_capacity=4096",
            "producer_mode=thread", "device=cpu", f"model_out={model}",
            *extra]


def _kv(args):
    return [tuple(a.split("=", 1)) for a in args if not a.startswith(
        "device=")]


def _learner(args):
    ln = SGDLearner(device="cpu")
    ln.init(_kv(args))
    return ln


def _mk(**kw):
    base = dict(hash_capacity=64, V_dim=4, V_threshold=0, lr=0.1, V_lr=0.1)
    base.update(kw)
    args = [(k, str(v)) for k, v in base.items()]
    tp, rest = T.SGDUpdaterParam.init_allow_unknown(args)
    assert rest == []
    return SlotStore(tp, device="cpu")


def _train(st, keys, rounds=3, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        k = np.sort(rng.choice(keys, size=min(8, len(keys)), replace=False))
        st.push(k, K_FEACOUNT, np.ones(len(k), np.float32))
        g = rng.standard_normal(len(k)).astype(np.float32) * 0.1
        gV = None if st.param.V_dim == 0 else rng.standard_normal(
            (len(k), st.param.V_dim)).astype(np.float32) * 0.01
        st.push(k, K_GRADIENT, g, gV,
                None if gV is None else np.ones(len(k), bool))


def _touched(st, keys):
    slots = np.unique(st.lookup(keys))
    return slots[(slots >= 0) & (slots < st.state.capacity)]


def _table(st):
    s = st.state
    if st.param.V_dim:
        return s.VVg.view(torch.int8).numpy().tobytes()
    return b"".join(getattr(s, c).numpy().tobytes()
                    for c in ("w", "z", "sqrt_g", "cnt", "v_live"))


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
            b[k].tobytes(), k


# ------------------------------------------------- WAL segment format
META = {"generation": 2, "seq": 0, "rank": 0, "epoch": 1, "step_lo": 0,
        "step_hi": 4, "boundary": False, "hash_capacity": 64,
        "capacity": 64, "V_dim": 4, "slot_dtype": "fp32", "row_width": 10}


def _sections(kind):
    """(numpy sections for JAX, the port's sections) of one kind."""
    rng = np.random.RandomState(3)
    slots = np.array([1, 5, 9, 11], np.int32)
    if kind == "flat":
        s = {"slots": slots[:2], "w": rng.randn(2).astype(np.float32),
             "z": rng.randn(2).astype(np.float32),
             "sqrt_g": rng.rand(2).astype(np.float32),
             "cnt": np.array([3.0, 7.0], np.float32),
             "v_live": np.array([True, False])}
        return s, s
    if kind == "fp32":
        s = {"slots": slots, "VVg": rng.randn(4, 10).astype(np.float32)}
        return s, s
    if kind == "int8":
        s = {"slots": slots,
             "VVg": rng.randint(-128, 128, (4, 40)).astype(np.int8)}
        return s, s
    dt, tdt, bits = {"bf16": (ml_dtypes.bfloat16, torch.bfloat16, np.int16),
                     "fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn,
                             np.int8)}[kind]
    rows = rng.randn(4, 16).astype(np.float32).astype(dt)
    port = torch.from_numpy(rows.view(bits).copy()).view(tdt)
    return {"slots": slots, "VVg": rows}, {"slots": slots, "VVg": port}


@pytest.mark.parametrize("kind", ["fp32", "flat", "bf16", "int8", "fp8"])
def test_segments_are_the_jax_bytes_and_read_both_ways(tmp_path, kind):
    jsects, tsects = _sections(kind)
    pj, pt = str(tmp_path / "j.dfwal"), str(tmp_path / "t.dfwal")
    nj = jwal.write_segment(pj, META, jsects)
    nt = wal.write_segment(pt, META, tsects)
    assert nj == nt == os.path.getsize(pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    meta, got = wal.read_segment(pj)          # the port reads JAX's
    jmeta, jgot = jwal.read_segment(pt)       # JAX reads the port's
    assert meta == jmeta == META
    for name, a in jsects.items():
        g = got[name]
        if isinstance(g, torch.Tensor):
            assert g.dtype == tsects[name].dtype
            g = g.view(torch.int16 if g.element_size() == 2
                       else torch.int8).numpy()
        assert g.tobytes() == np.asarray(a).tobytes(), name
        assert jgot[name].dtype == np.asarray(a).dtype
        assert jgot[name].tobytes() == np.asarray(a).tobytes(), name


@pytest.mark.parametrize("shape", ["torn", "flip", "magic", "short"])
def test_corrupt_segments_raise_typed(tmp_path, shape):
    good = str(tmp_path / "good.dfwal")
    wal.write_segment(good, {"epoch": 0, "step_lo": 0, "step_hi": 1}, {
        "slots": np.arange(8, dtype=np.int32),
        "VVg": np.ones((8, 4), np.float32)})
    buf = open(good, "rb").read()
    bad = bytearray(buf)
    if shape == "torn":
        bad = bad[:len(buf) // 2]
    elif shape == "flip":
        bad[-3] ^= 0xFF
    elif shape == "magic":
        bad[:8] = b"NOTAWAL!"
    else:
        bad = bad[:4]
    p = str(tmp_path / f"{shape}.dfwal")
    open(p, "wb").write(bytes(bad))
    with pytest.raises(WalCorrupt) as ei:
        wal.read_segment(p)
    assert p in str(ei.value)
    with pytest.raises(jwal.WalCorrupt):
        jwal.read_segment(p)
    wal.read_segment(good)


def test_writer_chain_rebase_adopt_as_jax(tmp_path):
    names = {}
    for who, W, mod in (("port", WalWriter, wal), ("jax", jwal.WalWriter,
                                                    jwal)):
        d = str(tmp_path / who / "m.wal")
        w = W(d, rank=0, geom={"capacity": 64}, generation=3)
        rows = np.ones((2, 4), np.float32)
        for i in range(3):
            w.append(np.array([i, i + 1], np.int32), {"VVg": rows},
                     epoch=0, step_lo=i * 4, step_hi=(i + 1) * 4)
        assert [s for s, _ in mod.chain_segments(d, 0, 3)] == [0, 1, 2]
        assert w.append(np.array([], np.int32), {}, 0, 12, 12) is None
        assert w.append(np.array([], np.int32), {}, 0, 12, 12,
                        boundary=True) is not None
        w.rebase(5, epoch=1)
        assert (w.generation, w.seq, w.base_epoch) == (5, 0, 1)
        assert mod.chain_generations(d, 0) == []
        w.append(np.array([1], np.int32), {"VVg": rows[:1]}, 1, 0, 4)
        w.append(np.array([2], np.int32), {"VVg": rows[:1]}, 1, 4, 8)
        w2 = W(d, rank=0, geom={"capacity": 64})
        w2.adopt(5, next_seq=1, base_epoch=1)
        assert [s for s, _ in mod.chain_segments(d, 0, 5)] == [0]
        assert (w2.generation, w2.seq, w2.base_epoch) == (5, 1, 1)
        names[who] = {n: open(os.path.join(d, n), "rb").read()
                      for n in os.listdir(d)}
    assert names["port"] == names["jax"]


# ------------------------------------------------- store hooks + replay
@pytest.mark.parametrize("kw", [dict(V_dim=4), dict(V_dim=0),
                                dict(V_dim=4, slot_dtype="bf16"),
                                dict(V_dim=4, slot_dtype="fp8")])
def test_wal_rows_round_trip(kw):
    keys = np.arange(2, 40, dtype=np.uint64)
    src = _mk(**kw)
    _train(src, keys)
    slots = _touched(src, keys)
    rows = src.wal_touched_rows(slots)
    dst = _mk(**kw)
    assert dst.apply_wal_rows(slots, rows) == len(slots)
    assert _table(dst) == _table(src)
    assert src.wal_geometry() == dst.wal_geometry()


def _chain(tmp_path, store_kw=None):
    """A 3-segment chain written by the port over a trained store, and
    the table after each segment."""
    src = _mk(**(store_kw or {}))
    keys = np.arange(2, 40, dtype=np.uint64)
    d = str(tmp_path / "m.wal")
    w = WalWriter(d, rank=0, geom=src.wal_geometry(), generation=1)
    snaps = []
    for i in range(3):
        _train(src, keys, rounds=1, seed=i)
        slots = _touched(src, keys)
        w.append(slots, src.wal_touched_rows(slots), epoch=0,
                 step_lo=i * FLUSH, step_hi=(i + 1) * FLUSH)
        snaps.append(_table(src))
    return d, snaps


@pytest.mark.parametrize("case", ["head", "gap", "torn", "geometry"])
def test_replay_applies_the_chain_and_stops_typed(tmp_path, case):
    d, snaps = _chain(tmp_path)
    segs = wal.chain_segments(d, 0, 1)
    if case in ("gap", "torn"):
        cut = str(tmp_path / case)
        os.makedirs(cut)
        for seq, p in segs:
            q = os.path.join(cut, os.path.basename(p))
            buf = open(p, "rb").read()
            if case == "gap" and seq == 1:
                continue
            open(q, "wb").write(buf[:len(buf) // 2]
                                if case == "torn" and seq == 2 else buf)
        d = cut
    dst = _mk(hash_capacity=128) if case == "geometry" else _mk()
    res = wal.replay(dst, d, 0, 1, base_epoch=-1)
    want = {"head": (3, 3 * FLUSH, ""), "gap": (1, FLUSH, "gap"),
            "torn": (2, 2 * FLUSH, "torn"), "geometry": (0, 0, "geometry")}
    assert (res.segments, res.batches, res.stopped) == want[case]
    if res.segments:
        assert _table(dst) == snaps[res.segments - 1]
    # JAX's replay stops at the same place on the same files
    tp, rest = J.SGDUpdaterParam.init_allow_unknown(
        [("hash_capacity", "128" if case == "geometry" else "64"),
         ("V_dim", "4"), ("V_threshold", "0"), ("lr", "0.1"),
         ("V_lr", "0.1")])
    jres = jwal.replay(JStore(tp), d, 0, 1, base_epoch=-1)
    assert (jres.segments, jres.batches, jres.stopped, jres.step) == \
        (res.segments, res.batches, res.stopped, res.step)


# ----------------------------------------------------- learner gating
@pytest.mark.parametrize("extra,match", [
    (("model_out=",), "requires model_out"),
    (("hash_capacity=0",), "hashed store"),
    (("evict_occupancy=0.5",), "evict_occupancy"),
    (("V_dim=4", "cold_tier_rows=64"), "cold_tier_rows"),
    (("device_dedup=1",), "device_dedup")])
def test_wal_gates_raise_the_jax_texts(tmp_path, extra, match):
    args = train_args(str(tmp_path / "m"),
                      extra=("wal_flush_batches=4",) + extra)
    with pytest.raises(ValueError, match=match) as terr:
        _learner(args)
    with pytest.raises(ValueError, match=match) as jerr:
        JLearner().init(_kv(args))
    assert str(terr.value) == str(jerr.value)


def test_wal_on_forces_the_cache_off_and_off_builds_nothing(tmp_path):
    ln = _learner(train_args(str(tmp_path / "m")))
    assert ln._wal is None and ln._replica is None
    ln.stop()
    ln = _learner(train_args(str(tmp_path / "m"),
                             extra=("wal_flush_batches=4",
                                    f"replica_peers={tmp_path / 'p'}")))
    assert ln._wal is not None and ln.param.device_cache_mb == 0
    assert ln._replica is not None
    ln.stop()


@pytest.mark.parametrize("extra", [(), ("V_dim=8",)])
def test_trajectory_is_the_same_with_the_wal_on(tmp_path, extra):
    off, on = str(tmp_path / "off"), str(tmp_path / "on")
    base = ("device_cache_mb=0",) + extra
    assert main(train_args(off, extra=base)) == 0
    assert main(train_args(on, extra=base + (
        "ckpt_interval=1", f"wal_flush_batches={FLUSH}",
        "auto_resume=1"))) == 0
    _same_arrays(_npz(off + "_part-0"), _npz(on + "_part-0"))
    gens = wal.chain_generations(wal.wal_dir(on), 0)
    assert gens
    for g in gens:
        for _, p in wal.chain_segments(wal.wal_dir(on), 0, g):
            jwal.read_segment(p)   # JAX reads every segment too


# ------------------------------------------------ armed fault points
def test_fault_wal_append_err_retains_the_window(tmp_path):
    d = str(tmp_path / "m.wal")
    w = WalWriter(d, 0, {"capacity": 64})
    faultinject.configure("wal.append:err@1")
    with pytest.raises(faultinject.FaultInjected):
        w.append(np.array([1], np.int32),
                 {"VVg": np.ones((1, 4), np.float32)}, 0, 0, 4)
    assert faultinject.stats() == {"wal.append": 1}
    assert w.seq == 0 and wal.chain_segments(d, 0, 0) == []
    faultinject.configure("")
    w.append(np.array([1], np.int32),
             {"VVg": np.ones((1, 4), np.float32)}, 0, 0, 8)
    assert [s for s, _ in wal.chain_segments(d, 0, 0)] == [0]


def test_fault_wal_append_err_in_the_learner_keeps_the_window(tmp_path):
    """An append that fails in the learner keeps its slots: the next
    flush logs them, and the model is the unfaulted one."""
    ref, model = str(tmp_path / "ref"), str(tmp_path / "m")
    assert main(train_args(ref, epochs=1)) == 0
    faultinject.configure("wal.append:err@1:1")   # every 2nd append fails
    assert main(train_args(model, epochs=1, extra=(
        f"wal_flush_batches={FLUSH}",))) == 0
    assert faultinject.stats()["wal.append"] >= 1
    faultinject.configure("")
    _same_arrays(_npz(ref + "_part-0"), _npz(model + "_part-0"))
    segs = wal.chain_segments(wal.wal_dir(model), 0, 0)
    metas = [wal.read_segment(p)[0] for _, p in segs]
    # the windows still tile the epoch: each segment starts where the
    # last one that landed ended
    assert [m["step_lo"] for m in metas][0] == 0
    for a, b in zip(metas, metas[1:]):
        assert b["step_lo"] == a["step_hi"]
    # a failed window widened the next one that landed
    assert any(m["step_hi"] - m["step_lo"] > FLUSH for m in metas)


def test_fault_wal_append_truncate_is_rejected_at_replay(tmp_path):
    st = _mk()
    d = str(tmp_path / "m.wal")
    w = WalWriter(d, 0, st.wal_geometry())
    faultinject.configure("wal.append:truncate@1")
    p = w.append(np.array([1, 2], np.int32),
                 st.wal_touched_rows(np.array([1, 2], np.int32)), 0, 0, 4)
    faultinject.configure("")
    assert p is not None and os.path.exists(p)
    with pytest.raises(WalCorrupt):
        wal.read_segment(p)
    res = wal.replay(_mk(), d, 0, 0, base_epoch=-1)
    assert (res.segments, res.stopped) == (0, "torn")


def test_fault_wal_replay_truncate_stops_at_the_prefix(tmp_path):
    d, snaps = _chain(tmp_path)
    faultinject.configure("wal.replay:truncate@1:1")
    dst = _mk()
    res = wal.replay(dst, d, 0, 1, base_epoch=-1)
    assert faultinject.stats() == {"wal.replay": 1}
    assert (res.segments, res.batches, res.stopped) == (1, FLUSH, "torn")
    assert _table(dst) == snaps[0]


def test_fault_replica_push_err_then_the_scrub_repairs(tmp_path):
    root, peer = tmp_path / "local", tmp_path / "peer"
    root.mkdir(), peer.mkdir()
    model = str(root / "m")
    w = WalWriter(wal.wal_dir(model), 0, {"capacity": 64})
    seg = w.append(np.array([1], np.int32),
                   {"VVg": np.ones((1, 4), np.float32)}, 0, 0, 4)
    with open(model + ".meta", "w") as f:
        f.write(json.dumps({"last_epoch": 0}))
    from difacto_tpu_torch.obs import counter
    fail_c = counter("replica_push_failures_total")
    before = fail_c.value()
    r = Replicator([str(peer)], k=1, rank=0, root=str(root))
    peer_seg = peer / "m.wal" / os.path.basename(seg)
    try:
        faultinject.configure("replica.push:err@1")
        r.push([seg, model + ".meta"], generation=1, epoch=0)
        assert r.flush(timeout=30)
        assert faultinject.stats()["replica.push"] >= 1
        assert fail_c.value() >= before + 2
        assert not peer_seg.exists()
        faultinject.configure("")
        assert r.scrub(model) == 2
        assert open(peer / "m.meta").read() == open(model + ".meta").read()
        wal.read_segment(str(peer_seg))
        faultinject.configure("replica.push:truncate@1")
        replicate.push_file(seg, str(peer), str(root))
        faultinject.configure("")
        with pytest.raises(WalCorrupt):
            wal.read_segment(str(peer_seg))
        assert r.scrub(model) == 1
        wal.read_segment(str(peer_seg))
        assert r.scrub(model) == 0
    finally:
        r.close()


def test_fault_replica_fetch_err_tries_the_next_peer(tmp_path):
    model = str(tmp_path / "src" / "m")
    os.makedirs(tmp_path / "src")
    assert main(train_args(model, extra=("ckpt_interval=1",))) == 0
    pbad, pgood = tmp_path / "z_bad_peer", tmp_path / "a_good_peer"
    pbad.mkdir(), pgood.mkdir()
    fam = replicate.family_files(model)
    assert fam
    for peer in (pbad, pgood):
        for f in fam:
            replicate.push_file(f, str(peer), str(tmp_path / "src"))
    faultinject.configure("replica.fetch:err@1")
    lost = str(tmp_path / "lost" / "m")
    os.makedirs(tmp_path / "lost")
    assert replicate.fetch_family(lost, [str(pbad), str(pgood)]) is None
    assert faultinject.stats()["replica.fetch"] >= 1
    faultinject.configure("")
    os.remove(pbad / "m_iter-2_part-0")
    os.mkdir(pbad / "m_iter-2_part-0")
    assert replicate.fetch_family(lost, [str(pbad), str(pgood)]) == \
        str(pgood)
    for f in fam:
        rel = os.path.relpath(f, str(tmp_path / "src"))
        assert open(os.path.join(tmp_path / "lost", rel), "rb").read() \
            == open(f, "rb").read()


# ------------------------------------------------------------- pruning
@pytest.mark.parametrize("keep,protect", [(1, {1}), (2, {0}), (1, set()),
                                          (2, {0, 1, 2})])
def test_prune_checkpoints_protect_removes_what_jax_removes(tmp_path, keep,
                                                            protect):
    left = {}
    for who, mod in (("port", mft), ("jax", jmft)):
        d = tmp_path / who
        d.mkdir()
        for e in range(4):
            for suf in ("", ".manifest.json"):
                (d / f"m_iter-{e}_part-0{suf}").write_text("x")
        removed = mod.prune_checkpoints(str(d / "m"), keep,
                                        protect=protect)
        left[who] = (sorted(os.listdir(d)),
                     sorted(os.path.basename(p) for p in removed))
    assert left["port"] == left["jax"]
    assert all(f"m_iter-{e}_part-0" in left["port"][0] for e in protect)


def test_ckpt_keep_never_retires_the_live_wal_base(tmp_path):
    model = str(tmp_path / "m")
    ln = _learner(train_args(model, extra=(
        "ckpt_interval=1", "ckpt_keep=1", f"wal_flush_batches={FLUSH}")))
    try:
        ln._save_checkpoint(0)
        assert ln._wal.base_epoch == 0
        ln._save_checkpoint(1)
        assert os.path.exists(f"{model}_iter-0_part-0")
        assert ln._wal.base_epoch == 1
        ln._save_checkpoint(2)
        assert not os.path.exists(f"{model}_iter-0_part-0")
        assert os.path.exists(f"{model}_iter-1_part-0")
        assert os.path.exists(f"{model}_iter-2_part-0")
    finally:
        ln.stop()


def test_replicator_lag_and_protected_epochs(tmp_path):
    root, peer = tmp_path / "r", tmp_path / "p"
    root.mkdir(), peer.mkdir()
    f1 = str(root / "a.bin")
    open(f1, "wb").write(os.urandom(1 << 12))
    from difacto_tpu_torch.obs import gauge
    lag = gauge("replica_lag_generations")
    faultinject.configure("replica.push:delay_ms=200@1")
    r = Replicator([str(peer)], k=1, rank=0, root=str(root))
    try:
        r.push([f1], generation=3, epoch=7)
        # still copying: the epoch is protected and the peer lags
        assert r.protected_epochs() == {7}
        assert lag.value(peer="p") == 3
        assert r.flush(timeout=30)
        assert r.protected_epochs() == set()
        assert open(peer / "a.bin", "rb").read() == open(f1, "rb").read()
        assert lag.value(peer="p") == 0
    finally:
        r.close()


# ----------------------------------------------------- recovery ladder
def _crash_in_epoch_2(model: str) -> None:
    """Leave ``model``'s family as a crash in epoch 2's third window would:
    no epoch-2 checkpoint, no final model, and the chain rooted at epoch
    1's checkpoint without its last (boundary) segment."""
    gen = int(mft.read(model + "_iter-1_part-0")["generation"])
    for f in glob.glob(model + "_iter-2_*") + glob.glob(model + "_part-*"):
        os.remove(f)
    d = wal.wal_dir(model)
    for g in wal.chain_generations(d, 0):
        if g > gen:
            for _, p in wal.chain_segments(d, 0, g):
                os.remove(p)
    chain = wal.chain_segments(d, 0, gen)
    assert len(chain) == 3
    os.remove(chain[-1][1])


def test_ladder_wal_rung_mid_window_finishes_the_unkilled_model(tmp_path):
    """A crash mid-window of epoch 2, in process: the full run's last
    checkpoint, final model and newest segment are removed. The rerun
    climbs local -> wal, skips the replayed batches and finishes with the
    unkilled run's model bit for bit."""
    model = str(tmp_path / "m")
    args = train_args(model, extra=("ckpt_interval=1", "auto_resume=1",
                                    f"wal_flush_batches={FLUSH}",
                                    "V_dim=4"))
    assert main(args) == 0
    ref = _npz(model + "_part-0")
    _crash_in_epoch_2(model)
    ln = _learner(args)
    try:
        resumed = ln._try_resume()
        stamp = json.load(open(model + ".recovery.json"))
        assert stamp["rungs"] == ["local", "wal"]
        assert resumed == stamp["resumed_epoch"] == 1
        assert ln._wal_skip == stamp["skip_batches"] == 2 * FLUSH
        assert stamp["wal_replay_batches"] == 2 * FLUSH
        assert stamp["head"] == {"epoch": 2, "step": 2 * FLUSH,
                                 "boundary": False}
    finally:
        ln.stop()
    assert main(args) == 0
    _same_arrays(ref, _npz(model + "_part-0"))


def test_ladder_peer_rung_after_disk_loss(tmp_path):
    """Disk loss mid-epoch 2, in process: every local file is gone and the
    peers hold the family up to epoch 1's checkpoint plus epoch 2's first
    two windows. The rerun fetches from a peer, replays the chain and
    finishes with the unkilled run's model bit for bit."""
    peers = [tmp_path / "p1", tmp_path / "p2"]
    model = str(tmp_path / "m")
    args = train_args(model, extra=(
        "ckpt_interval=1", "auto_resume=1", f"wal_flush_batches={FLUSH}",
        f"replica_peers={peers[0]},{peers[1]}", "replica_k=2", "V_dim=4"))
    assert main(args) == 0
    ref = _npz(model + "_part-0")
    for peer in peers:
        _crash_in_epoch_2(str(peer / "m"))
    shutil.rmtree(wal.wal_dir(model))
    for f in glob.glob(model + "*"):
        os.remove(f)
    ln = _learner(args)
    try:
        resumed = ln._try_resume()
        stamp = json.load(open(model + ".recovery.json"))
        assert stamp["rungs"] == ["peer", "wal"]
        assert resumed == 1 and 0 < stamp["skip_batches"] <= 2 * FLUSH
    finally:
        ln.stop()
    assert main(args) == 0
    _same_arrays(ref, _npz(model + "_part-0"))
    # and every peer converges: the scrub has nothing left to repair
    r = Replicator([str(p) for p in peers], k=2, rank=0,
                   root=str(tmp_path))
    try:
        assert r.scrub(model) == 0
    finally:
        r.close()


def test_ladder_with_nothing_to_recover_starts_fresh(tmp_path):
    model = str(tmp_path / "m")
    ln = _learner(train_args(model, extra=(
        "auto_resume=1", f"wal_flush_batches={FLUSH}",
        f"replica_peers={tmp_path / 'p'}")))
    try:
        assert ln._try_resume() is None
        stamp = json.load(open(model + ".recovery.json"))
        assert stamp == {"rungs": [], "resumed_epoch": None}
    finally:
        ln.stop()


def test_jax_replays_the_port_chain(tmp_path):
    """A port run's chain, replayed by JAX onto JAX's load of the same
    base checkpoint, reaches the port's own replayed table."""
    model = str(tmp_path / "m")
    args = train_args(model, epochs=2, extra=(
        "ckpt_interval=1", f"wal_flush_batches={FLUSH}", "V_dim=4"))
    assert main(args) == 0
    base = model + "_iter-0_part-0"
    gen = int(mft.read(base)["generation"])
    tp, _ = T.SGDUpdaterParam.init_allow_unknown(
        [("hash_capacity", "4096"), ("V_dim", "4")])
    jp, _ = J.SGDUpdaterParam.init_allow_unknown(
        [("hash_capacity", "4096"), ("V_dim", "4")])
    port = SlotStore(tp, device="cpu")
    port.load(base, weights_only=False)
    ref = JStore(jp)
    ref.load(base, weights_only=False)
    d = wal.wal_dir(model)
    res = wal.replay(port, d, 0, gen, base_epoch=0)
    jres = jwal.replay(ref, d, 0, gen, base_epoch=0)
    assert res.segments == jres.segments > 0 and res.boundary
    assert (res.epoch, res.step) == (jres.epoch, jres.step) == (1, 10)
    assert np.asarray(ref.state.VVg).tobytes() == \
        port.state.VVg.numpy().tobytes()
    # the replayed head is epoch 1's end: the interval checkpoint's table
    chk = SlotStore(tp, device="cpu")
    chk.load(model + "_iter-1_part-0", weights_only=False)
    assert torch.equal(chk.state.VVg.view(torch.int32),
                       port.state.VVg.view(torch.int32))
