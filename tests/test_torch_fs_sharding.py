"""The port's fs-sharded slot table against its flat table and against the
JAX package's sharded store (the counterparts of tests/test_fs_sharding.py
and tests/test_parallel.py), on the CPU.

The port runs with ``device="cpu"`` and ``DIFACTO_TORCH_VIRTUAL_DEVICES``
set by monkeypatch; JAX runs on the suite's 8 virtual CPU devices
(tests/conftest.py) through its jnp table backend. Covered:

- ``mesh_force`` at 1 x 1 and ``mesh_fs=4`` leave the port's flat table
  bit for bit (the sharded gather and push move bits, never values);
- ``mesh_fs=4`` tracks JAX's ``mesh_fs=4`` run on rcv1 within 1e-5;
- per-key-range checkpoints (members ``_fs-<i>-of-<n>`` and the stub
  written last) round-trip into any fs, and load both ways with JAX array
  for array, optimizer state included; an interval checkpoint resumes
  the trajectory bit for bit; a corrupt or missing member fails typed
  and walks back;
- ``serve_mesh_fs`` 1/2/4 scores are byte-identical, the reload keeps
  the fs degree, and task=serve threads it into its reloader;
- the shard stats and their gauges; the capacity scaling report's legs.
"""

import gc
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from difacto_tpu.learners.sgd import SGDLearner as JLearner
from difacto_tpu.parallel import make_mesh as jmake_mesh
from difacto_tpu.store.local import SlotStore as JStore
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu_torch.learners.sgd import SGDLearner, SGDLearnerParam
from difacto_tpu_torch.parallel import make_mesh
from difacto_tpu_torch.store.convert import (fs_shard_path,
                                             state_from_jax_table)
from difacto_tpu_torch.store.local import SlotStore
from difacto_tpu_torch.updaters import sgd_updater as T
from difacto_tpu_torch.utils import manifest as mft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(ROOT, "tests", "data", "rcv1_100.libsvm")
JAX_THREADS = [("num_producers", "1"), ("producer_mode", "thread"),
               ("fused_kernel", "jnp")]
LOGICAL = ("w", "z", "sqrt_g", "cnt", "v_live", "V", "Vg")


@pytest.fixture(autouse=True)
def _eight_devices(monkeypatch):
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")


def _kw(**over):
    args = [("data_in", RCV1), ("V_dim", "2"), ("V_threshold", "2"),
            ("lr", "0.1"), ("l1", "0.1"), ("l2", "0"),
            ("num_jobs_per_epoch", "1"), ("batch_size", "100"),
            ("max_num_epochs", "3"), ("shuffle", "0"),
            ("report_interval", "0"), ("stop_rel_objv", "0"),
            ("hash_capacity", "4096")]
    return args + [(k, str(v)) for k, v in over.items()]


def jax_init(kwargs):
    """The port store's init provider drawing JAX's init table."""
    _, rest = SGDLearnerParam.init_allow_unknown(kwargs)
    tp, _ = T.SGDUpdaterParam.init_allow_unknown(rest)
    jp, _ = J.SGDUpdaterParam.init_allow_unknown(rest)
    return lambda C: state_from_jax_table(
        tp, np.asarray(J.init_state(jp, C).VVg), "cpu")


def run_port(kwargs, init=None):
    ln = SGDLearner(device="cpu", table_init=init)
    assert ln.init(kwargs) == []
    seen = []
    ln.add_epoch_end_callback(lambda e, t, v: seen.append(t.loss))
    ln.run()
    return ln, seen


def run_jax(kwargs):
    ln = JLearner()
    assert ln.init(kwargs + JAX_THREADS) == []
    seen = []
    ln.add_epoch_end_callback(lambda e, t, v: seen.append(t.loss))
    ln.run()
    return ln, seen


def _bits(store) -> np.ndarray:
    return store.state.VVg.contiguous().view(torch.int32).numpy()


def _cols(store) -> dict:
    return store._logical_np(LOGICAL)


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("over", [dict(mesh_force=1), dict(mesh_fs=4),
                                  dict(mesh_fs=8)])
def test_mesh_leaves_the_flat_table_bit_for_bit(over):
    flat, seen0 = run_port(_kw())
    ln, seen = run_port(_kw(**over))
    assert flat.mesh is None and ln.mesh is not None
    assert ln.store.fs_count == over.get("mesh_fs", 1)
    assert seen == seen0                 # float equality, not allclose
    np.testing.assert_array_equal(_bits(ln.store), _bits(flat.store))


def test_fs4_tracks_jax_fs4():
    kw = _kw(mesh_fs=4)
    port, seen = run_port(kw, jax_init(kw))
    jln, jseen = run_jax(kw)
    assert port.store.fs_count == jln.store.fs_count == 4
    np.testing.assert_allclose(seen, jseen, rtol=1e-5)
    got, want = _cols(port.store), jln.store._logical_np(keys=LOGICAL)
    for f in ("cnt", "v_live"):
        np.testing.assert_array_equal(got[f], want[f])
    for f in ("w", "z", "sqrt_g", "V", "Vg"):
        scale = max(float(np.abs(want[f]).max()), 1e-30)
        assert float(np.abs(got[f] - want[f]).max()) <= 1e-5 * scale, f


# ----------------------------------------------------- shard checkpoints
def _param(cap=2048, V_dim=2):
    return dict(V_dim=V_dim, hash_capacity=cap, l1=0.0, V_threshold=0)


def _fill(store, seed=7, V_dim=2):
    rng = np.random.RandomState(seed)
    keys = rng.randint(1, 1 << 62, 300).astype(np.uint64)
    store.push(keys, 1, np.ones(len(keys), np.float32))
    store.push(keys, 3, rng.randn(len(keys)).astype(np.float32),
               rng.randn(len(keys), V_dim).astype(np.float32),
               np.ones(len(keys), np.float32))
    return store


def _port_store(fs, **kw):
    mesh = None if fs == 1 else make_mesh(dp=1, fs=fs, device="cpu")
    return SlotStore(T.SGDUpdaterParam(**_param(**kw)), device="cpu",
                     mesh=mesh)


def test_sharded_checkpoint_roundtrip(tmp_path):
    """fs=4 save writes one verified member per key range and the stub;
    only the stub is a load entry point; the table loads bit for bit into
    fs 4, 2 and 1 (unsharded) stores."""
    s = _fill(_port_store(4))
    path = str(tmp_path / "model")
    n = s.save(path, save_aux=True)
    assert n > 0
    for i in range(4):
        man = mft.verify(fs_shard_path(path, i, 4), require_manifest=True)
        assert man["fs_shard"] == i and man["fs_count"] == 4
    stub = mft.verify(path, require_manifest=True)
    assert stub["fs_count"] == 4 and stub["rows"] == n
    assert mft.generation_paths(path) == [path]
    for fs in (4, 2, 1):
        fresh = _port_store(fs)
        assert fresh.load(path, weights_only=False) == n
        np.testing.assert_array_equal(_bits(fresh), _bits(s))
    flat = _port_store(1)
    flat.state = s.state
    flat.save(str(tmp_path / "flat"), save_aux=True)
    back = _port_store(4)
    back.load(str(tmp_path / "flat"), weights_only=False)
    np.testing.assert_array_equal(_bits(back), _bits(s))


@pytest.mark.parametrize("writer,fs_w,fs_r", [
    ("port", 4, 1), ("port", 4, 2), ("port", 2, 4),
    ("jax", 4, 1), ("jax", 4, 2), ("jax", 2, 4)])
def test_sharded_checkpoints_both_ways_with_jax(tmp_path, writer, fs_w,
                                                fs_r):
    """A per-key-range checkpoint (with its optimizer state) written by
    one package loads into the other at any fs, array for array."""
    path = str(tmp_path / "model")
    if writer == "port":
        src = _fill(_port_store(fs_w))
        src.save(path, save_aux=True)
        want = _cols(src)
        dst = JStore(J.SGDUpdaterParam(**_param()),
                     mesh=None if fs_r == 1 else jmake_mesh(dp=1, fs=fs_r))
        dst.load(path, weights_only=False)
        got = dst._logical_np(keys=LOGICAL)
    else:
        src = _fill(JStore(J.SGDUpdaterParam(**_param()),
                           mesh=jmake_mesh(dp=1, fs=fs_w)))
        src.save(path, save_aux=True)
        want = src._logical_np(keys=LOGICAL)
        dst = _port_store(fs_r)
        dst.load(path, weights_only=False)
        got = _cols(dst)
    assert os.path.exists(fs_shard_path(path, fs_w - 1, fs_w))
    assert want["z"].any() and want["sqrt_g"].any()
    for f in LOGICAL:
        np.testing.assert_array_equal(np.asarray(got[f]),
                                      np.asarray(want[f]), err_msg=f)


def test_sharded_interval_checkpoint_resumes_bit_for_bit(tmp_path):
    """A mesh_fs=4 run with sharded interval checkpoints stopped after
    epoch 1 and resumed with auto_resume ends on the straight run's table
    bit for bit."""
    kw = _kw(mesh_fs=4, device_cache_mb=0, has_aux=1)
    straight, seen = run_port(kw + [("model_out", str(tmp_path / "a"))])
    m = str(tmp_path / "b")
    run_port(kw + [("model_out", m), ("ckpt_interval", "1"),
                   ("max_num_epochs", "2")])
    assert os.path.exists(fs_shard_path(m + "_iter-1_part-0", 3, 4))
    resumed, seen2 = run_port(kw + [("model_out", m), ("ckpt_interval", "1"),
                                    ("auto_resume", "1")])
    assert seen2 == seen[2:]
    np.testing.assert_array_equal(_bits(resumed.store),
                                  _bits(straight.store))


def test_corrupt_one_shard_fails_typed_and_walks_back(tmp_path):
    """A bit flip inside ONE member: the load raises CheckpointCorrupt
    before any state commits; serving walks back to the previous verified
    generation; auto_resume walks back to the previous epoch."""
    from difacto_tpu_torch.serve.model import open_serving_store
    s = _fill(_port_store(4))
    path = str(tmp_path / "model")
    s.save(path)                                   # generation 1 (good)
    s.push(np.array([123456789], np.uint64), 3, np.ones(1, np.float32),
           np.ones((1, 2), np.float32), np.ones(1, np.float32))
    s.save(path + "_iter-1")                       # generation 2
    sp = fs_shard_path(path + "_iter-1", 2, 4)
    with open(sp, "r+b") as f:
        data = f.read()
        f.seek(data.find(b"w.npy") + 200)
        f.write(b"\xff\xff\xff")
    fresh = _port_store(4)
    init_bits = _bits(fresh).copy()
    with pytest.raises(mft.CheckpointCorrupt):
        fresh.load(path + "_iter-1")
    np.testing.assert_array_equal(_bits(fresh), init_bits)
    store, meta, _ = open_serving_store(
        path + "_iter-1", [("serve_mesh_fs", "2")], device="cpu")
    assert meta["path"] == path and store.fs_count == 2
    np.testing.assert_array_equal(store._logical_np(("w",))["w"],
                                  _load_w(path))
    # the learner's resume walk: epoch 1's sharded checkpoint is corrupt,
    # epoch 0's verifies
    kw = _kw(mesh_fs=4, device_cache_mb=0, max_num_epochs=1)
    m = str(tmp_path / "r")
    run_port(kw + [("model_out", m), ("ckpt_interval", "1")])
    ln = SGDLearner(device="cpu")
    ln.init(kw + [("model_out", m)])
    ln.store.save(m + "_iter-1_part-0", save_aux=True, epoch=1)
    sp = fs_shard_path(m + "_iter-1_part-0", 0, 4)
    with open(sp, "r+b") as f:
        data = f.read()
        f.seek(data.find(b"w.npy") + 150)
        f.write(b"\xff\xff\xff")
    assert ln._try_resume_base() == (0, m + "_iter-0_part-0")


def _load_w(path):
    s = _port_store(1)
    s.load(path)
    return s._logical_np(("w",))["w"]


def test_missing_shard_member_is_corrupt(tmp_path):
    s = _fill(_port_store(2))
    path = str(tmp_path / "model")
    s.save(path)
    os.remove(fs_shard_path(path, 1, 2))
    os.remove(fs_shard_path(path, 1, 2) + ".manifest.json")
    with pytest.raises(mft.CheckpointCorrupt, match="missing"):
        _port_store(2).load(path)


def test_cold_tier_refuses_a_mesh_as_jax():
    param = T.SGDUpdaterParam(V_dim=2, hash_capacity=2048,
                              cold_tier_rows=512)
    with pytest.raises(ValueError, match="single-device only") as got:
        SlotStore(param, device="cpu",
                  mesh=make_mesh(dp=1, fs=2, device="cpu"))
    with pytest.raises(ValueError, match="single-device only") as want:
        JStore(J.SGDUpdaterParam(V_dim=2, hash_capacity=2048,
                                 cold_tier_rows=512),
               mesh=jmake_mesh(dp=1, fs=2))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="divisible"):
        SlotStore(T.SGDUpdaterParam(V_dim=2, hash_capacity=1002),
                  device="cpu", mesh=make_mesh(dp=1, fs=4, device="cpu"))


# ---------------------------------------------------------------- serve
@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A mesh_fs=2 model of rcv1, saved per key range."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")
    try:
        m = str(tmp_path_factory.mktemp("fsmodel") / "model")
        run_port(_kw(mesh_fs=2, model_out=m))
    finally:
        mp.undo()
    assert os.path.exists(m + "_part-0_fs-0-of-2")
    return m


def test_serve_mesh_fs_scores_byte_identical(model):
    from difacto_tpu.serve.executor import PredictExecutor as JExecutor
    from difacto_tpu.serve.model import open_serving_store as jopen
    from difacto_tpu_torch.data.reader import Reader
    from difacto_tpu_torch.serve.executor import PredictExecutor
    from difacto_tpu_torch.serve.model import open_serving_store
    blk = next(iter(Reader(RCV1, "libsvm", 0, 1)))
    scores = {}
    for fs in (1, 2, 4):
        store, _, _ = open_serving_store(
            model, [("serve_mesh_fs", str(fs))], device="cpu")
        assert store.fs_count == fs and store.read_only
        ex = PredictExecutor(store)
        scores[fs] = ex.predict(blk)[0]
        st = ex.stats()
        assert st["dispatches"] == 1
        assert st.get("fs", 1) == fs
    assert scores[1].any()
    np.testing.assert_array_equal(scores[1], scores[2])
    np.testing.assert_array_equal(scores[1], scores[4])
    from difacto_tpu.data.reader import Reader as JReader
    jstore, _, _ = jopen(model, [("serve_mesh_fs", "2")])
    want = JExecutor(jstore).predict(next(iter(JReader(RCV1, "libsvm",
                                                       0, 1))))[0]
    np.testing.assert_allclose(scores[4], np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_hot_reload_geometry_check_covers_fs(tmp_path):
    from difacto_tpu_torch.serve.executor import PredictExecutor
    from difacto_tpu_torch.serve.model import open_serving_store
    from difacto_tpu_torch.serve.reload import ModelReloader
    s = _fill(_port_store(2))
    path = str(tmp_path / "model")
    s.save(path)
    store, _, _ = open_serving_store(path, [("serve_mesh_fs", "2")],
                                     device="cpu")
    ex = PredictExecutor(store)
    flat, _, _ = open_serving_store(path, [], device="cpu")
    with pytest.raises(ValueError, match="fs=2"):
        ex.swap_store(flat)
    rl = ModelReloader(ex, path, kwargs=[("serve_mesh_fs", "2")])
    s.save(path)    # the next generation
    gone = weakref.ref(ex.store)
    res = rl.reload()
    assert res["ok"], res
    assert ex.store.fs_count == 2
    # the executor's store functions hold no store: the swapped-out table
    # is freed (a reload must not keep the old model alive)
    del store, flat
    gc.collect()
    assert gone() is None


def test_run_serve_threads_mesh_into_reloader(model, tmp_path):
    """task=serve with serve_mesh_fs=2 answers over TCP from the per-shard
    files, ``#stats`` reports fs, and a ``#reload`` keeps the mesh."""
    from difacto_tpu_torch.serve import ServeClient, run_serve
    ready = str(tmp_path / "ready")
    t = threading.Thread(target=run_serve, args=([
        ("model_in", model), ("serve_mesh_fs", "2"),
        ("serve_ready_file", ready), ("serve_max_seconds", "4"),
        ("serve_batch_size", "100"), ("serve_max_delay_ms", "50")],),
        kwargs={"device": "cpu"}, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while not os.path.exists(ready):
        assert time.monotonic() < deadline, "server never became ready"
        time.sleep(0.05)
    host, port = open(ready).read().split()
    lines = [x.encode() for x in open(RCV1).read().splitlines()[:20]]
    with ServeClient(host, int(port)) as c:
        out = c.score_lines(lines)
        res = c.reload()
        st = c.stats()
    assert len(out) == 20 and not any(o.startswith(b"!") for o in out)
    assert res["ok"], res
    assert st["fs"] == 2
    t.join(timeout=30)


# ------------------------------------------------- stats + capacity legs
def test_shard_stats_and_gauges():
    from difacto_tpu_torch.obs import REGISTRY
    s = _fill(_port_store(4))
    stats = s.shard_stats()
    assert [st["shard"] for st in stats] == [0, 1, 2, 3]
    assert [(st["row_lo"], st["row_hi"]) for st in stats] == \
        [(0, 512), (512, 1024), (1024, 1536), (1536, 2048)]
    w = _cols(s)["w"]
    assert sum(st["rows"] for st in stats) == int((w != 0).sum()) > 0
    per_shard = T.state_bytes(s.param, s.state.capacity) // 4
    assert all(st["table_bytes"] == per_shard for st in stats)
    assert s.publish_shard_stats() == stats
    snap = REGISTRY.snapshot()["gauges"].get("store_shard_rows", {})
    got = {dict(k)["shard"]: v for k, v in snap.items()}
    for st in stats:
        assert got[str(st["shard"])] == st["rows"]
    # the mesh's one device holds every shard: the whole table
    cs = s.capacity_stats()
    assert cs["effective_rows_per_device"] == 2048
    assert cs["table_bytes_per_device"] == T.state_bytes(s.param, 2048)


def test_capacity_scaling_report_legs():
    from difacto_tpu_torch.parallel.capacity import capacity_scaling_report
    rep = capacity_scaling_report(fs_values=[1, 2], base_capacity=512,
                                  V_dim=2, batch=64, nnz_per_row=4,
                                  steps=2, device="cpu")
    assert [leg["fs"] for leg in rep["legs"]] == [1, 2]
    l1, l2 = rep["legs"]
    assert l2["hash_capacity"] == 2 * l1["hash_capacity"]
    assert l2["table_bytes_per_shard"] == l1["table_bytes_per_shard"]
    assert l2["table_bytes_per_device"] == l2["table_bytes_total"] == \
        2 * l1["table_bytes_per_device"]
    assert rep["capacity_scaling"] == 2.0
    assert rep["scaling_efficiency"] == 1.0
    assert all(leg["examples_per_sec"] > 0 for leg in rep["legs"])
    assert rep["n_devices"] == 8 and rep["skipped_fs"] == []
    assert capacity_scaling_report(fs_values=[16], base_capacity=64,
                                   device="cpu")["skipped_fs"] == [16]
