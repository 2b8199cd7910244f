"""The (dp, fs) mesh over several devices, on eight logical CPU devices
(``DIFACTO_TORCH_VIRTUAL_DEVICES=8`` by monkeypatch; JAX on the suite's
8 virtual CPU devices): every key-range shard is an allocation of its own
on its logical device, and every move between logical devices a copy.

- each shard's leaves are distinct storages of ``C/fs`` rows, and after a
  2 x 4 training run no tensor of ``C`` rows exists;
- ``capacity_stats()`` equals the JAX store's on its 8-device mesh (the
  per-device figures ``total // fs``), read from the allocations;
- 2 x 4 runs (hashed, and dictionary with growth from 64 rows) repeat bit
  for bit and stay within 1e-5 of JAX's per epoch; ``mesh_fs=4`` leaves
  the flat table bit for bit through the KV pushes of both layouts
  (``V_dim`` 0 and fused rows), a growth that re-lays the rows, an
  eviction and a dictionary load, and the dictionary's growth loses no
  row;
- per-shard checkpoints round-trip both ways with JAX, member by member;
- ``make_mesh`` over four given ``cuda`` devices lays shard ``f`` on card
  ``f`` without touching a card, and the routing sends each shard's local
  slots to its shard's device.
"""

import gc
import os

import numpy as np
import pytest
import torch

from difacto_tpu.learners.sgd import SGDLearner as JLearner
from difacto_tpu.parallel import make_mesh as jmake_mesh
from difacto_tpu.store.local import SlotStore as JStore
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu_torch.learners.sgd import SGDLearner, SGDLearnerParam
from difacto_tpu_torch.parallel import make_mesh, sharded
from difacto_tpu_torch.store.convert import state_from_jax_table
from difacto_tpu_torch.store.local import SlotStore
from difacto_tpu_torch.updaters import sgd_updater as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(ROOT, "tests", "data", "rcv1_100.libsvm")
JAX_THREADS = [("num_producers", "1"), ("producer_mode", "thread"),
               ("fused_kernel", "jnp")]
LOGICAL = ("w", "z", "sqrt_g", "cnt", "v_live", "V", "Vg")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _eight_devices(monkeypatch):
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")


def _kw(**over):
    args = [("data_in", RCV1), ("V_dim", "2"), ("V_threshold", "2"),
            ("lr", "0.1"), ("l1", "0.1"), ("l2", "0"),
            ("num_jobs_per_epoch", "1"), ("batch_size", "50"),
            ("max_num_epochs", "3"), ("shuffle", "0"),
            ("report_interval", "0"), ("stop_rel_objv", "0"),
            ("mesh_dp", "2"), ("mesh_fs", "4")]
    return args + [(k, str(v)) for k, v in over.items()]


def jax_init(kwargs):
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


def _bits(state) -> np.ndarray:
    return sharded.host_state(state).VVg.contiguous().view(
        torch.int32).numpy()


def _store(fs, **kw):
    mesh = None if fs == 1 else make_mesh(dp=1, fs=fs, device="cpu")
    return SlotStore(T.SGDUpdaterParam(**kw), device="cpu", mesh=mesh)


def _push(store, seed, V_dim, n=300):
    rng = np.random.RandomState(seed)
    keys = rng.randint(1, 1 << 62, n).astype(np.uint64)
    store.push(keys, 1, np.ones(n, np.float32))
    gV = rng.randn(n, V_dim).astype(np.float32) if V_dim else None
    store.push(keys, 3, rng.randn(n).astype(np.float32), gV,
               np.ones(n, np.float32) if V_dim else None)
    return keys


def _cols(store) -> dict:
    return store._state_np(LOGICAL)


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("kw", [dict(V_dim=2), dict(V_dim=0),
                                dict(V_dim=3, slot_dtype="int8")])
def test_each_shard_is_its_own_allocation_of_c_over_fs_rows(kw):
    C, fs = 1024, 4
    s = _store(fs, hash_capacity=C, **kw)
    st = s.state
    assert isinstance(st, sharded.ShardedState) and st.capacity == C
    storages = set()
    for shard in st.shards:
        table = shard.VVg if kw["V_dim"] else shard.w
        assert table.shape[0] == C // fs
        for t in shard:
            assert t.shape[0] in (0, C // fs)      # placeholders are empty
            if t.numel():
                storages.add(t.untyped_storage().data_ptr())
    n_leaves = sum(1 for t in st if t.numel())
    assert len(storages) == n_leaves
    assert not any(t.shape[0] == C for t in st)
    assert s.device_bytes() == [T.state_bytes(s.param, C) // fs] * fs


def test_no_whole_table_tensor_after_a_2x4_run():
    C = 4096
    ln, seen = run_port(_kw(hash_capacity=C))
    assert ln.mesh.shape == {"dp": 2, "fs": 4}
    gc.collect()
    whole = [tuple(o.shape) for o in gc.get_objects()
             if isinstance(o, torch.Tensor) and o.dim() >= 1
             and o.shape[0] == C]
    assert whole == []
    assert len(seen) == 3


@pytest.mark.parametrize("kw", [dict(V_dim=2), dict(V_dim=0),
                                dict(V_dim=4, slot_dtype="bf16"),
                                dict(V_dim=3, slot_dtype="int8")])
def test_capacity_stats_equal_jax(kw):
    C = 2048
    port = _store(4, hash_capacity=C, **kw)
    jp = J.SGDUpdaterParam(hash_capacity=C, **kw)
    jstore = JStore(jp, mesh=jmake_mesh(dp=2, fs=4))
    assert port.capacity_stats() == jstore.capacity_stats()
    assert port.capacity_stats()["table_bytes_per_device"] == \
        T.state_bytes(port.param, C) // 4


# ---------------------------------------------------- the mesh's training
@pytest.mark.parametrize("store", ["hashed", "dictionary"])
def test_2x4_repeats_bit_for_bit_and_tracks_jax(store):
    over = dict(hash_capacity=4096) if store == "hashed" \
        else dict(init_capacity=64)
    kw = _kw(**over)
    init = jax_init(kw)
    a, seen_a = run_port(kw, init)
    b, seen_b = run_port(kw, init)
    assert seen_a == seen_b
    np.testing.assert_array_equal(_bits(a.store.state),
                                  _bits(b.store.state))
    j, jseen = run_jax(kw)
    np.testing.assert_allclose(seen_a, jseen, rtol=TOL)
    if store == "dictionary":
        assert a.store.state.capacity > 64
        assert a.store.state.capacity == j.store.state.capacity
        np.testing.assert_array_equal(a.store._keys, j.store._keys)


def test_dictionary_growth_on_the_mesh_loses_no_row():
    """Streamed (``device_cache_mb=0``) dictionary runs grow from 64 rows
    through the same capacities as the flat table: at ``mesh_fs=4`` to
    the flat table bit for bit, keys included; at 2 x 4 (whose dp partials
    sum in dp order) to the same keys and every row within 1e-5."""
    kw = _kw(init_capacity=64, device_cache_mb=0)
    flat, seen0 = run_port(kw + [("mesh_dp", "1"), ("mesh_fs", "1")])
    fs4, seen4 = run_port(kw + [("mesh_dp", "1")])
    mesh, seen = run_port(kw)
    assert flat.mesh is None and fs4.store.fs_count == 4
    for ln in (fs4, mesh):
        assert ln.store.state.capacity == flat.store.state.capacity > 64
        np.testing.assert_array_equal(ln.store._keys, flat.store._keys)
    assert seen4 == seen0
    np.testing.assert_array_equal(_bits(fs4.store.state),
                                  _bits(flat.store.state))
    np.testing.assert_allclose(seen, seen0, rtol=TOL)
    got, want = _cols(mesh.store), _cols(flat.store)
    for f in LOGICAL:
        scale = max(float(np.abs(want[f]).max()), 1e-30)
        assert float(np.abs(got[f].astype(np.float64)
                            - want[f]).max()) <= TOL * scale, f


@pytest.mark.parametrize("kw", [dict(V_dim=0), dict(V_dim=2),
                                dict(V_dim=3, slot_dtype="int8")])
def test_fs4_kv_pushes_equal_the_flat_table(kw):
    C = 1024
    flat, mesh = _store(1, hash_capacity=C, **kw), \
        _store(4, hash_capacity=C, **kw)
    for seed in (1, 2):
        keys = _push(flat, seed, kw["V_dim"])
        assert _push(mesh, seed, kw["V_dim"]).tolist() == keys.tolist()
    for f, a in _cols(flat).items():
        np.testing.assert_array_equal(_cols(mesh)[f], a, err_msg=f)
    got, want = mesh.pull(keys), flat.pull(keys)
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(g, w)
    assert [float(x) for x in mesh.evaluate()] == pytest.approx(
        [float(x) for x in flat.evaluate()], rel=TOL)


@pytest.mark.parametrize("kw", [dict(V_dim=2),
                                dict(V_dim=3, pad_v_rows_max_mb=1)])
def test_fs4_growth_equals_the_flat_growth(kw):
    """A dictionary store's doubling moves rows between shards: 256 ->
    4096 rows (with ``pad_v_rows_max_mb=1`` the layout crosses at 2048
    rows and the old rows are re-laid out) leaves the flat table's rows
    bit for bit, as does an eviction afterwards."""
    kw = dict(kw, init_capacity=256, evict_occupancy=0.01)
    flat, mesh = _store(1, **kw), _store(4, **kw)
    for st in (flat, mesh):
        _push(st, 5, kw["V_dim"], n=200)
        st.grow_to(4096)
        _push(st, 6, kw["V_dim"], n=200)
    assert isinstance(mesh.state, sharded.ShardedState)
    assert mesh.state.rows == 1024
    np.testing.assert_array_equal(_bits(mesh.state), _bits(flat.state))
    assert mesh.maybe_evict() == flat.maybe_evict() > 0
    np.testing.assert_array_equal(_bits(mesh.state), _bits(flat.state))


def test_fs4_dictionary_load_equals_the_flat_load(tmp_path):
    kw = dict(V_dim=2, init_capacity=64)
    src = _store(1, **kw)
    _push(src, 3, 2, n=150)
    path = str(tmp_path / "dict")
    src.save(path, save_aux=True)
    flat, mesh = _store(1, **kw), _store(4, **kw)
    assert flat.load(path, weights_only=False) == \
        mesh.load(path, weights_only=False) == 150
    assert mesh.state.capacity == flat.state.capacity == 256
    np.testing.assert_array_equal(_bits(mesh.state), _bits(flat.state))


# ------------------------------------------------------- checkpoints x JAX
def test_per_shard_checkpoints_round_trip_with_jax(tmp_path):
    C, kw = 2048, dict(V_dim=2, l1=0.0, V_threshold=0)
    port = _store(4, hash_capacity=C, **kw)
    _push(port, 11, 2)
    path = str(tmp_path / "port")
    n = port.save(path, save_aux=True)
    jstore = JStore(J.SGDUpdaterParam(hash_capacity=C, **kw),
                    mesh=jmake_mesh(dp=1, fs=4))
    assert jstore.load(path, weights_only=False) == n
    want = jstore._logical_np(keys=LOGICAL)
    got = port._state_np(LOGICAL)
    for f in LOGICAL:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    jpath = str(tmp_path / "jax")
    jstore.save(jpath, save_aux=True)
    for fs in (4, 2):
        back = _store(fs, hash_capacity=C, **kw)
        assert back.load(jpath, weights_only=False) == n
        np.testing.assert_array_equal(_bits(back.state), _bits(port.state))


# ----------------------------------------------------------------- cards
def test_make_mesh_over_four_cards_lays_shard_f_on_card_f():
    cards = [torch.device("cuda", i) for i in range(4)]
    m = make_mesh(dp=1, fs=4, devices=cards)
    assert m.shard_devices == cards and m.home == cards[0]
    assert "cuda:3" in repr(m)
    m = make_mesh(dp=2, fs=2, devices=cards)
    assert m.shard_devices == cards[:2]
    # the routing sends each run's local slots to its shard's device
    host = np.array([1, 5, 300, 700, 1000, 1030, 1031], np.int32)
    cpus = [torch.device("cpu")] * 4
    ss = sharded.route(torch.from_numpy(host), host, 1024, 4, cpus)
    assert ss.offsets == (0, 2, 3, 4, 7)
    assert [t.tolist() for t in ss.local] == [[1, 5], [44], [188],
                                              [232, 262, 263]]
