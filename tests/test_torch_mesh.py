"""The port's single-process mesh (difacto_tpu_torch/parallel/) on the CPU.

- ``make_mesh``: its (dp, fs) shapes over the logical devices of
  ``DIFACTO_TORCH_VIRTUAL_DEVICES`` (set here with monkeypatch), its
  power-of-two and device-count errors (the JAX package's texts), and the
  multi-process stub;
- ``fs_shard_bounds``, ``validate_fs_capacity`` and ``mesh_dim_min`` equal
  the JAX package's on the same arguments;
- the routing of parallel/sharded.py equals the flat plain gather and
  push bit for bit (the table compared through its int32 view, so NaN
  payloads and -0.0 count): shards with empty runs, an all-OOB slot
  vector, a pad tail, one real row, and a shard boundary inside the
  vector.
"""

import functools

import numpy as np
import pytest
import torch

from difacto_tpu import parallel as jpar
from difacto_tpu.ops import batch as jbatch
from difacto_tpu_torch import parallel as tpar
from difacto_tpu_torch.ops import batch as tbatch
from difacto_tpu_torch.ops import fused
from difacto_tpu_torch.parallel import mesh as tmesh
from difacto_tpu_torch.parallel import sharded
from difacto_tpu_torch.store.slots import pad_slots_oob
from difacto_tpu_torch.updaters import sgd_updater as T
from difacto_tpu_torch.utils import platform


# ----------------------------------------------------------------- mesh
@pytest.mark.parametrize("dp,fs", [(1, 1), (2, 4), (1, 8), (8, 1), (2, 2)])
def test_make_mesh_shapes(monkeypatch, dp, fs):
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")
    m = tpar.make_mesh(dp=dp, fs=fs, device="cpu")
    assert m.shape == {"dp": dp, "fs": fs}
    assert (m.dp, m.fs) == (dp, fs)
    assert len(m.devices) == dp and all(len(r) == fs for r in m.devices)
    assert all(d == torch.device("cpu") for r in m.devices for d in r)
    assert m.home == torch.device("cpu")
    # the JAX mesh over the suite's 8 virtual CPU devices, same shape
    assert dict(jpar.make_mesh(dp=dp, fs=fs).shape) == m.shape


def test_make_mesh_errors(monkeypatch):
    monkeypatch.delenv("DIFACTO_TORCH_VIRTUAL_DEVICES", raising=False)
    with pytest.raises(ValueError, match="need 8 devices, have 1"):
        tpar.make_mesh(dp=2, fs=4, device="cpu")
    for dp, fs in ((1, 3), (3, 1), (0, 2)):
        with pytest.raises(ValueError, match="power of two"):
            tpar.make_mesh(dp=dp, fs=fs, device="cpu")
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "4")
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        tpar.make_mesh(dp=2, fs=4, device="cpu")
    assert tpar.make_mesh(dp=2, fs=2, device="cpu").shape == {"dp": 2,
                                                             "fs": 2}
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "zero")
    with pytest.raises(ValueError, match="not an integer"):
        tpar.make_mesh(dp=2, fs=1, device="cpu")
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "0")
    with pytest.raises(ValueError, match=">= 1"):
        tpar.make_mesh(dp=2, fs=1, device="cpu")


def test_mesh_over_several_cards_raises():
    """A mesh lies on one physical device; one over several cards is a
    follow-up and raises (no card is touched: the devices are given)."""
    cards = [torch.device("cuda", i) for i in range(4)]
    with pytest.raises(NotImplementedError, match="4 physical devices"):
        tpar.make_mesh(dp=1, fs=4, devices=cards)
    with pytest.raises(NotImplementedError, match="VIRTUAL_DEVICES"):
        tpar.make_mesh(dp=2, fs=1, devices=cards[:2])
    m = tpar.make_mesh(dp=2, fs=2, devices=[cards[0]] * 4)
    assert m.home == cards[0]


def test_mesh_devices_map_logical_to_physical(monkeypatch, caplog):
    import logging
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")
    with caplog.at_level(logging.INFO, logger="difacto_tpu_torch"):
        devs = platform.mesh_devices(6, "cpu")
        platform.mesh_devices(6, "cpu")
    assert devs == [torch.device("cpu")] * 6
    lines = [r.getMessage() for r in caplog.records
             if "logical devices" in r.getMessage()]
    assert len(lines) <= 1          # once per mapping (maybe logged earlier)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            platform.mesh_devices(1, "cuda")


def test_more_than_one_process_raises(monkeypatch):
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 11b"):
        tpar.make_mesh(dp=1, fs=1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11b"):
        tpar.put_global(np.zeros(4), lambda x: x)


@pytest.mark.parametrize("cap,fs", [(1024, 1), (1024, 4), (4096, 8),
                                    (4194304, 4), (12, 4), (6, 2)])
def test_shard_bounds_equal_jax(cap, fs):
    assert tpar.fs_shard_bounds(cap, fs) == jpar.fs_shard_bounds(cap, fs)
    tpar.validate_fs_capacity(cap, fs)


@pytest.mark.parametrize("cap,fs", [(1002, 4), (4095, 8), (10, 4)])
def test_validate_fs_capacity_raises_as_jax(cap, fs):
    with pytest.raises(ValueError, match="divisible") as got:
        tpar.validate_fs_capacity(cap, fs)
    with pytest.raises(ValueError, match="divisible") as want:
        jpar.validate_fs_capacity(cap, fs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("floor", [8, 12, 64])
def test_mesh_dim_min_equals_jax(dp, floor):
    got = tbatch.mesh_dim_min(dp, floor)
    assert got == jbatch.mesh_dim_min(dp, floor)
    for n in (1, 7, 100, 1000, 50_000):
        assert tbatch.bucket(n, got) % dp == 0


def test_placements_split_and_view(monkeypatch):
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")
    m = tpar.make_mesh(dp=2, fs=4, device="cpu")
    x = torch.arange(32.0).view(16, 2)
    shards = tpar.state_sharding(m)(x)
    assert [s.shape[0] for s in shards] == [4, 4, 4, 4]
    assert all(s.data_ptr() == x[4 * i].data_ptr()
               for i, s in enumerate(shards))           # views, no copy
    blocks = tpar.put_dp_local(np.arange(8, dtype=np.float32), m)
    assert [b.tolist() for b in blocks] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="dp=2"):
        tpar.batch_sharding(m)(torch.zeros(3))
    assert tpar.replicated(m)(x) is x
    assert len(tpar.put_global(np.zeros(()), tpar.batch_sharding(m))) == 2


# ----------------------------------------------------------- routing
C, FS = 64, 4
PARAM = T.SGDUpdaterParam(V_dim=4, hash_capacity=C, l1=0.01, V_threshold=0)


def _table(seed: int) -> torch.Tensor:
    """A fused fp32 table of PARAM's layout with random bits in every
    lane (NaN payloads and -0.0 among them)."""
    t = T.init_state(PARAM, C, torch.device("cpu")).VVg
    bits = np.random.RandomState(seed).randint(
        -2 ** 31, 2 ** 31 - 1, size=tuple(t.shape), dtype=np.int64)
    bits[::7, 1] = 0x7FC00001          # a NaN payload
    bits[::5, 2] = -2 ** 31            # -0.0
    out = torch.from_numpy(bits.astype(np.int32)).view(torch.float32)
    # the scalar lanes hold sane FTRL state so the epilogue stays finite
    _, _, _, off = T.row_layout(PARAM, C)
    good = T.init_state(PARAM, C, torch.device("cpu")).VVg
    out[:, off:] = good[:, off:]
    return out.contiguous()


SLOTS = {
    "boundary": np.array([3, 15, 16, 17, 40, 63]),      # runs cross shards
    "empty_shards": np.array([33, 34, 40]),             # shards 0, 1, 3 empty
    "all_oob": np.zeros(0, np.int64),
    "one_real": np.array([16]),
    "pad_tail": np.array([1, 2, 50]),
}


def _vector(name: str, u_cap: int) -> np.ndarray:
    return pad_slots_oob(SLOTS[name].astype(np.int32), u_cap, C)


def _route(host: np.ndarray) -> sharded.ShardedSlots:
    return sharded.route(torch.from_numpy(host), host, C, FS)


def _shards(table: torch.Tensor) -> list:
    n = C // FS
    return [table[f * n:(f + 1) * n] for f in range(FS)]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().copy()


@pytest.mark.parametrize("name", sorted(SLOTS))
@pytest.mark.parametrize("u_cap", [8, 12])
def test_plan_offsets_and_local_slots(name, u_cap):
    host = _vector(name, u_cap)
    offsets, local = sharded.plan_slots(host, C, FS)
    assert offsets[0] == 0 and offsets[-1] == u_cap
    assert list(offsets) == sorted(offsets)
    n = C // FS
    for j, s in enumerate(host):
        f = min(int(s) // n, FS - 1)
        assert offsets[f] <= j < offsets[f + 1]
        assert local[j] == s - f * n
    # the pad lanes fall past the last shard: its kernel zeroes and drops
    assert (local[len(SLOTS[name]):] >= n).all()


@pytest.mark.parametrize("name", sorted(SLOTS))
def test_sharded_gather_equals_flat_bit_for_bit(name):
    table = _table(1)
    host = _vector(name, 8)
    ss = _route(host)
    want = fused.gather_rows_ref(table, torch.from_numpy(host))
    got = sharded.sharded_gather(_shards(table), ss)
    ref = sharded.sharded_gather_ref(_shards(table), ss)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(ref), _bits(want))
    # the one-shard route of mesh_force is the flat gather itself
    one = sharded.route(torch.from_numpy(host), host, C, 1)
    np.testing.assert_array_equal(
        _bits(sharded.sharded_gather([table], one)),
        _bits(want))


@pytest.mark.parametrize("name", sorted(SLOTS))
@pytest.mark.parametrize("u_cap", [8, 12])
def test_sharded_push_equals_flat_bit_for_bit(name, u_cap):
    rng = np.random.RandomState(3)
    host = _vector(name, u_cap)
    slots = torch.from_numpy(host)
    epi = T.epilogue_spec(PARAM, C)
    epilogue = functools.partial(T.row_epilogue, PARAM, C)
    base = T.init_state(PARAM, C, torch.device("cpu")).VVg
    rows = fused.gather_rows_ref(base, slots)
    gw = torch.from_numpy(rng.randn(u_cap).astype(np.float32))
    gV = torch.from_numpy(rng.randn(u_cap, 4).astype(np.float32))
    vmask = torch.from_numpy((rng.rand(u_cap) > 0.3).astype(np.float32))
    want = fused.fm_update_rows_ref(base.clone(), slots, rows, gw, gV,
                                    vmask, epilogue)
    table = base.clone()
    sharded.sharded_push(_shards(table), _route(host), rows, gw, gV, vmask,
                         epi, epilogue)
    np.testing.assert_array_equal(_bits(table), _bits(want))
    ref = base.clone()
    sharded.sharded_push_ref(_shards(ref), _route(host), rows, gw, gV,
                             vmask, epilogue)
    np.testing.assert_array_equal(_bits(ref), _bits(want))


@pytest.mark.parametrize("name", sorted(SLOTS))
def test_sharded_scatter_equals_flat_bit_for_bit(name):
    host = _vector(name, 12)
    slots = torch.from_numpy(host)
    rows = _table(5)[:12].clone()
    want = fused.scatter_rows_ref(_table(2), slots, rows)
    table = _table(2)
    sharded.sharded_scatter(_shards(table), _route(host), rows)
    np.testing.assert_array_equal(_bits(table), _bits(want))
    ref = _table(2)
    sharded.sharded_push_ref(_shards(ref), _route(host), rows, None, None,
                             None, None)
    np.testing.assert_array_equal(_bits(ref), _bits(want))


def test_store_routes_through_the_shards(monkeypatch):
    """A store on a 1 x 4 mesh launches the gather once per non-empty
    shard run (counted on the plain version here)."""
    from difacto_tpu_torch.store.local import SlotStore
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "4")
    calls = []
    real = fused.gather_rows_ref

    def counting(table, slots, out=None):
        calls.append(table.shape[0])
        return real(table, slots, out)
    monkeypatch.setattr(fused, "gather_rows_ref", counting)
    store = SlotStore(PARAM, device="cpu",
                      mesh=tpar.make_mesh(dp=1, fs=4, device="cpu"))
    host = _vector("empty_shards", 8)
    ss = store.shard_slots(torch.from_numpy(host), host, C)
    store.fns.pull_rows(store.state, ss)
    # shard 2's run and the pad tail in the last shard's; 0 and 1 launch
    # nothing
    assert ss.offsets == (0, 0, 0, 3, 8)
    assert calls == [C // FS, C // FS]
