"""The port's capacity levers against the JAX package's, on the CPU:
count-min admission, the host-RAM cold tier and occupancy eviction.

- ``CountMinSketch`` estimates and ``AdmissionFilter`` outputs equal JAX's
  exactly for the same seeds and token streams, and ``make_admission``
  mixes (seed, epoch, part) the same way;
- ``prepare_hashed(admit=...)`` packs JAX's buffers byte for byte (panel
  and COO); the port's thread and process producers admit the same
  tokens and leave the same table bit for bit;
- ``ColdTier.route`` fed the same slot vectors on both sides, from the
  same device table and the same virgin V (JAX's, injected): ``routed``,
  ``order``, ``perm``, the residency maps, the LRU clock and the host rows
  equal exactly, and the device table bit for bit, in fp32, bf16, int8
  and fp8 containers; so after armed ``store.promote`` / ``store.demote``
  faults;
- ``logical_cols`` / ``load_cold``, tiered checkpoints both ways (tiered
  into untiered and the reverse), ``maybe_evict`` with and without a
  tier, ``capacity_stats`` and the store's gates (JAX's texts) match;
- a tiered learner run tracks JAX's tiered run within 1e-5 per epoch and
  1e-5 of max|jax| on the final arrays, and the port's tiered and
  untiered runs agree on w within JAX's own rtol 1e-3.

bf16 inputs carry no 16-bit half that is a NaN pattern: JAX on the CPU
quiets those in gathers (ROADMAP.md, Queue 3).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu.capacity import sketch as jsketch
from difacto_tpu.data.pack_stream import ShapeSchedule as JShapes
from difacto_tpu.data.pack_stream import prepare_hashed as jprepare
from difacto_tpu.store.local import SlotStore as JStore
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu.utils import faultinject as jfi
from difacto_tpu_torch.capacity import sketch as tsketch
from difacto_tpu_torch.capacity.tier import route_payload
from difacto_tpu_torch.data.batch_reader import BatchReader
from difacto_tpu_torch.data.pack_stream import ShapeSchedule, prepare_hashed
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.store.convert import state_from_jax_table
from difacto_tpu_torch.store.local import SlotStore
from difacto_tpu_torch.updaters import sgd_updater as T
from difacto_tpu_torch.utils import faultinject as tfi
from test_torch_stream import (assert_close_to_jax, jax_init, run_jax,
                               stream_kwargs)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(_ROOT, "tests", "data", "rcv1_100.libsvm")
sys.path.insert(0, _ROOT)
from chip_smoke import synthetic_criteo  # noqa: E402

DTYPES = ["fp32", "bf16", "int8", "fp8"]
_FIELDS = ("w", "z", "sqrt_g", "cnt", "v_live", "V", "Vg")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jfi.configure("")
    tfi.configure("")


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo_capacity")
    (d / "train.txt").write_bytes(synthetic_criteo(400, 41))
    (d / "val.txt").write_bytes(synthetic_criteo(150, 42))
    return str(d / "train.txt"), str(d / "val.txt")


def _params(**kw):
    base = dict(hash_capacity=256, V_dim=4, V_threshold=0, lr=0.1,
                V_lr=0.1, seed=5)
    base.update(kw)
    args = [(k, str(v)) for k, v in base.items()]
    tp, rest = T.SGDUpdaterParam.init_allow_unknown(args)
    jp, _ = J.SGDUpdaterParam.init_allow_unknown(args)
    assert rest == []
    return tp, jp


def _bf16_safe(x: np.ndarray) -> np.ndarray:
    """f32 values whose low 16 bits are zero: no NaN pattern in either
    bf16 half."""
    return (np.asarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFF0000)).view(np.float32)


def _pair(slot_dtype="fp32", seed=5, **kw):
    """A JAX store and a port store over the same random device table and
    the same virgin V (JAX's)."""
    tp, jp = _params(slot_dtype=slot_dtype, seed=seed, **kw)
    js = JStore(jp)
    C = js.state.capacity
    if jp.V_dim:
        rng = np.random.default_rng(seed)
        k = jp.V_dim
        V = _bf16_safe(rng.standard_normal((C, k)) * 0.1)
        Vg = _bf16_safe(rng.random((C, k)))
        w, z, sg = (_bf16_safe(rng.standard_normal(C)) for _ in range(3))
        cnt = _bf16_safe(rng.integers(0, 5, C))
        live = rng.random(C) < 0.5
        w[rng.random(C) < 0.3] = 0
        table = J.build_rows(jp, C, jnp.asarray(V), jnp.asarray(Vg),
                             jnp.asarray(w), jnp.asarray(z), jnp.asarray(sg),
                             jnp.asarray(cnt), jnp.asarray(live))
        js.state = js.state._replace(VVg=table)
        vvg = np.asarray(table)
        init = (lambda c: state_from_jax_table(tp, vvg, "cpu"))
    else:
        init = None
    virgin = None if js.tier is None else np.asarray(js.tier._virgin_V)
    ts = SlotStore(tp, device="cpu", init=init, virgin_V=virgin)
    return js, ts


def _ubits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[
            a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.itemsize])


def _assert_same_tier(js, ts):
    jt, tt = js.tier, ts.tier
    np.testing.assert_array_equal(jt._resident, tt._resident)
    np.testing.assert_array_equal(jt._owner, tt._owner)
    np.testing.assert_array_equal(jt._clock, tt._clock)
    assert jt._tick == tt._tick
    assert sorted(jt._rows) == sorted(tt._rows)
    for s in jt._rows:
        assert np.asarray(jt._rows[s]).tobytes() == tt._rows[s].tobytes(), s
    np.testing.assert_array_equal(_ubits(js.state.VVg), _ubits(ts.state.VVg))


def _slot_vectors(L: int, n: int, seed: int, u: int = 24, real: int = 18):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        s = np.sort(rng.choice(np.arange(1, L), size=real, replace=False))
        yield np.concatenate([s, L + np.arange(u - real)]).astype(np.int32)


# ----------------------------------------------------------------- sketch
@pytest.mark.parametrize("width,depth,seed", [(1 << 16, 2, 0), (64, 3, 7),
                                              (1000, 1, 123)])
def test_count_min_estimates_equal_jax(width, depth, seed):
    rng = np.random.default_rng(seed)
    a = jsketch.CountMinSketch(width, depth, seed)
    b = tsketch.CountMinSketch(width, depth, seed)
    assert a.width == b.width
    np.testing.assert_array_equal(a._mult, b._mult)
    for _ in range(5):
        tok = rng.integers(0, 1 << 22, 500).astype(np.int32)
        np.testing.assert_array_equal(a.add(tok), b.add(tok))
    probe = rng.integers(0, 1 << 22, 300).astype(np.int32)
    np.testing.assert_array_equal(a.estimate(probe), b.estimate(probe))
    np.testing.assert_array_equal(a.counts, b.counts)


@pytest.mark.parametrize("min_count", [1, 2, 5])
def test_admission_filter_admits_the_jax_set(min_count):
    rng = np.random.default_rng(min_count)
    a = jsketch.make_admission(4096, min_count, 3, 1, 2)
    b = tsketch.make_admission(4096, min_count, 3, 1, 2)
    for _ in range(6):
        tok = (rng.zipf(1.3, 400) % 4095 + 1).astype(np.int32)
        np.testing.assert_array_equal(a.filter(tok), b.filter(tok))


def test_make_admission_off_and_the_seed_mix():
    assert tsketch.make_admission(4096, 0, 1, 2, 3) is None
    for args in ((7, 0, 0), (7, 1, 0), (7, 0, 1), (2 ** 40, 9, 31)):
        a = jsketch.make_admission(4096, 2, *args)
        b = tsketch.make_admission(4096, 2, *args)
        np.testing.assert_array_equal(a.sketch._mult, b.sketch._mult)
        assert a.sentinel == b.sentinel == 4096


@pytest.mark.parametrize("data,fmt,fill", [("criteo", "criteo", True),
                                           ("criteo", "criteo", False),
                                           ("rcv1", "libsvm", True)])
def test_prepare_hashed_with_admission_packs_the_jax_bytes(criteo, data,
                                                          fmt, fill):
    uri = criteo[0] if data == "criteo" else RCV1
    a = jsketch.make_admission(4096, 2, 1, 0, 0)
    b = tsketch.make_admission(4096, 2, 1, 0, 0)
    js, ts = JShapes(), ShapeSchedule()
    n = 0
    for blk in BatchReader(uri, fmt, batch_size=50):
        want = jprepare(js, 4096, blk, True, fill, 8, "train", 64,
                        admit=a)
        got = prepare_hashed(ts, 4096, blk, True, fill, 8, "train", 64,
                             admit=b)
        assert got.layout == want[0]
        assert got.i32.tobytes() == np.asarray(want[1]).tobytes()
        assert got.f32.tobytes() == np.asarray(want[2]).tobytes()
        assert (got.binary, got.b_cap, got.d2, got.u_cap) == tuple(
            want[3:7])
        n += 1
    assert n >= 2


def _learner(kwargs, **kw):
    ln = SGDLearner(device="cpu", table_init=jax_init(kwargs), **kw)
    ln.init(kwargs)
    rows = []
    ln.add_epoch_end_callback(lambda k, t, v: rows.append(
        (t.nrows, t.loss, t.auc, t.nnz_w, t.penalty, v.nrows, v.loss,
         v.auc)))
    ln.run()
    return rows, ln


def test_admission_thread_and_process_admit_the_same(criteo):
    from difacto_tpu_torch.obs import REGISTRY
    drops = REGISTRY.counter("store_admit_drops_total")
    kw = stream_kwargs(criteo, ("admit_min_count", "2"),
                       ("max_num_epochs", "2"))
    before = drops.value()
    r0, l0 = _learner(kw + [("producer_mode", "thread"),
                            ("num_producers", "2")])
    assert drops.value() > before
    r1, l1 = _learner(kw + [("producer_mode", "process"),
                            ("num_producers", "2")])
    assert r0 == r1
    assert torch.equal(l0.store.state.VVg.view(torch.int32),
                       l1.store.state.VVg.view(torch.int32))
    r2, l2 = _learner(stream_kwargs(criteo, ("max_num_epochs", "2"),
                                    ("producer_mode", "thread")))
    assert not torch.equal(l0.store.state.VVg, l2.store.state.VVg)


# ------------------------------------------------------------- cold tier
@pytest.mark.parametrize("slot_dtype", DTYPES)
def test_route_matches_jax_bit_for_bit(slot_dtype):
    js, ts = _pair(slot_dtype, cold_tier_rows=224)
    assert ts.tier.D == js.tier.D == 32
    _assert_same_tier(js, ts)
    for v in _slot_vectors(256, 12, seed=3):
        want = js.tier.route(v)
        got = ts.tier.route(v)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert got[0].dtype == np.int32
        _assert_same_tier(js, ts)
    assert ts.tier.calls["promote"] > 0 and ts.tier.calls["demote"] > 0
    assert ts.tier.stats() == js.tier.stats()


def test_route_payload_rewrites_the_jax_way(criteo):
    js, ts = _pair("fp32", hash_capacity=4096, cold_tier_rows=3072)
    shapes, jshapes = ShapeSchedule(), JShapes()
    for data, fmt in ((criteo[0], "criteo"), (RCV1, "libsvm")):
        for blk in BatchReader(data, fmt, batch_size=50):
            p = prepare_hashed(shapes, 4096, blk, True, True, 8, "t", 64)
            jp = jprepare(jshapes, 4096, blk, True, True, 8, "t", 64)
            from difacto_tpu.capacity.tier import route_payload as jroute
            want = jroute(js.tier, jp)
            got = route_payload(ts.tier, p)
            assert got.i32.tobytes() == np.asarray(want[1]).tobytes()
            assert got.f32.tobytes() == np.asarray(want[2]).tobytes()
    _assert_same_tier(js, ts)


@pytest.mark.parametrize("fault", ["store.demote", "store.promote"])
def test_tier_faults_degrade_as_in_jax(fault):
    js, ts = _pair("int8", cold_tier_rows=224, seed=9)
    vecs = list(_slot_vectors(256, 8, seed=4))
    for v in vecs[:3]:
        js.tier.route(v)
        ts.tier.route(v)
    resident = ts.tier._resident.copy()
    jfi.configure(f"{fault}:err@1")
    tfi.configure(f"{fault}:err@1")
    for v in vecs[3:6]:
        want = js.tier.route(v)
        got = ts.tier.route(v)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        # degraded slots land on OOB lanes: nothing new became resident
        assert (got[0] >= ts.tier.D).any()
    assert tfi.stats()[fault] == jfi.stats()[fault] > 0
    now = ts.tier._resident >= 0
    if fault == "store.demote":
        # refused demotes: every victim stays resident where it was
        np.testing.assert_array_equal(resident, ts.tier._resident)
    else:
        # refused promotes: demotes still free rows, nothing comes in
        assert not (now & (resident < 0)).any() and now.sum() < (
            resident >= 0).sum()
    _assert_same_tier(js, ts)
    jfi.configure("")
    tfi.configure("")
    for v in vecs[6:]:
        js.tier.route(v)
        ts.tier.route(v)
    _assert_same_tier(js, ts)


@pytest.mark.parametrize("slot_dtype", DTYPES)
def test_logical_cols_and_load_cold_match(slot_dtype):
    js, ts = _pair(slot_dtype, cold_tier_rows=224)
    for v in _slot_vectors(256, 10, seed=8):
        js.tier.route(v)
        ts.tier.route(v)
    got = ts._logical_np(_FIELDS)
    want = js._logical_np(keys=_FIELDS)
    for f in _FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), f)
    # reseed both tiers from the same logical columns
    js.tier.load_cold({f: np.asarray(want[f]) for f in _FIELDS})
    ts.tier.load_cold({f: np.asarray(want[f]) for f in _FIELDS})
    _assert_same_tier(js, ts)


@pytest.mark.parametrize("writer,tiers", [("jax", (224, 224)),
                                          ("jax", (224, 0)),
                                          ("port", (224, 224)),
                                          ("port", (224, 0)),
                                          ("port", (0, 224))])
def test_tiered_checkpoints_load_both_ways(tmp_path, writer, tiers):
    src_tier, dst_tier = tiers
    js, ts = _pair("int8", cold_tier_rows=src_tier)
    if src_tier:
        for v in _slot_vectors(256, 6, seed=2):
            js.tier.route(v)
            ts.tier.route(v)
    path = str(tmp_path / "m")
    (ts if writer == "port" else js).save(path, save_aux=True)
    want = np.load(path)
    tp, jp = _params(slot_dtype="int8", cold_tier_rows=dst_tier)
    ref = JStore(jp)
    ref.load(path, weights_only=False, require_manifest=True)
    port = SlotStore(tp, device="cpu", virgin_V=None if ref.tier is None
                     else np.asarray(ref.tier._virgin_V))
    port.load(path, weights_only=False, require_manifest=True)
    assert (port.tier is None) == (dst_tier == 0)
    got = port._logical_np(_FIELDS)
    ref_np = ref._logical_np(keys=_FIELDS)
    for f in _FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(ref_np[f]), f)
    # the file's w, cnt and live survive any tier setting; a tail row with
    # none of them set loads as the tier's virgin row (both packages)
    for f in ("w", "cnt", "v_live"):
        np.testing.assert_array_equal(got[f], want[f], f)
    if dst_tier:
        _assert_same_tier(ref, port)


@pytest.mark.parametrize("tier", [0, 160])
def test_maybe_evict_matches_jax(tier):
    js, ts = _pair("fp32", cold_tier_rows=tier, evict_occupancy=0.3)
    if tier:
        for v in _slot_vectors(256, 5, seed=6):
            js.tier.route(v)
            ts.tier.route(v)
    from difacto_tpu_torch.obs import REGISTRY
    ev = REGISTRY.counter("store_evictions_total")
    before = ev.value()
    n = ts.maybe_evict()
    assert n == js.maybe_evict() > 0
    assert ev.value() == before + n
    np.testing.assert_array_equal(_ubits(js.state.VVg), _ubits(ts.state.VVg))
    if tier:
        _assert_same_tier(js, ts)
        assert ts.tier.calls["evict"] == 1
    assert ts.maybe_evict() == js.maybe_evict() == 0


def test_reset_rows_of_the_flat_table_match_jax():
    tp, jp = _params(V_dim=0, evict_occupancy=0.2, hash_capacity=64)
    js, ts = JStore(jp), SlotStore(tp, device="cpu")
    rng = np.random.default_rng(1)
    cols = {f: rng.standard_normal(64).astype(np.float32)
            for f in ("w", "z", "sqrt_g", "cnt")}
    js.state = js.state._replace(**{f: jnp.asarray(a)
                                    for f, a in cols.items()})
    for f, a in cols.items():
        getattr(ts.state, f).copy_(torch.from_numpy(a))
    assert ts.maybe_evict() == js.maybe_evict() > 0
    for f in ("w", "z", "sqrt_g", "cnt", "v_live"):
        np.testing.assert_array_equal(getattr(ts.state, f).numpy(),
                                      np.asarray(getattr(js.state, f)))


@pytest.mark.parametrize("kw", [dict(slot_dtype="int8", cold_tier_rows=128),
                                dict(slot_dtype="fp32"),
                                dict(slot_dtype="bf16", cold_tier_rows=64),
                                dict(V_dim=0)])
def test_capacity_stats_equal_jax(kw):
    tp, jp = _params(**kw)
    assert SlotStore(tp, device="cpu").capacity_stats() == \
        JStore(jp).capacity_stats()


@pytest.mark.parametrize("kw,match", [
    (dict(V_dim=0, cold_tier_rows=16), "V_dim"),
    (dict(hash_capacity=64, cold_tier_rows=63), "at least 2 hot rows"),
    (dict(hash_capacity=0, cold_tier_rows=16), "hashed store")])
def test_tier_gates_raise_the_jax_texts(kw, match):
    tp, jp = _params(**kw)
    with pytest.raises(ValueError, match=match) as jerr:
        JStore(jp)
    with pytest.raises(ValueError, match=match) as terr:
        SlotStore(tp, device="cpu")
    assert str(terr.value) == str(jerr.value)
    # a read-only store (serving) ignores the knob
    assert SlotStore(tp, device="cpu", read_only=True).tier is None


# --------------------------------------------------------------- learner
def _virgin(kwargs):
    """JAX's virgin V of the cold tail for these knobs."""
    jp, _ = J.SGDUpdaterParam.init_allow_unknown(kwargs)
    return np.asarray(JStore(jp).tier._virgin_V)


def test_tiered_learner_run_matches_jax(criteo):
    kw = stream_kwargs(criteo, ("cold_tier_rows", "2048"),
                       ("admit_min_count", "2"), ("evict_occupancy", "0.3"),
                       ("producer_mode", "thread"), ("num_producers", "2"))
    rows, ln = _learner(kw, tier_virgin_V=_virgin(kw))
    jrows, jln = run_jax(kw)
    t = ln.store.tier
    assert t.calls["promote"] > 0 and t.calls["demote"] > 0
    assert t.calls["evict"] > 0
    got = ln.store._logical_np(_FIELDS)
    want = {f: np.asarray(a) for f, a in
            jln.store._logical_np(keys=_FIELDS).items()}
    assert_close_to_jax(rows, jrows, got, want, "tiered")
    np.testing.assert_array_equal(t._resident, jln.store.tier._resident)


def test_tiered_and_untiered_runs_agree_on_w(tmp_path):
    """JAX's ``test_tiered_learner_run_matches_untiered`` on the port:
    residency is placement only; the tier's own virgin V stream moves the
    trajectory a little (rtol 1e-3 on w, as JAX holds it)."""
    from conftest import write_uniform_libsvm
    path = write_uniform_libsvm(str(tmp_path / "u.libsvm"), rows=200,
                                width=8, id_space=300)
    args = [("data_in", path), ("V_dim", "2"), ("lr", "0.1"), ("l1", "0.1"),
            ("l2", "0"), ("num_jobs_per_epoch", "1"), ("batch_size", "100"),
            ("max_num_epochs", "2"), ("shuffle", "0"),
            ("report_interval", "0"), ("stop_rel_objv", "0"),
            ("device_cache_mb", "0"), ("producer_mode", "thread"),
            ("hash_capacity", "1024"), ("V_threshold", "0")]

    def run(cold):
        ln = SGDLearner(device="cpu")
        ln.init(args + [("cold_tier_rows", str(cold))])
        seen = []
        ln.add_epoch_end_callback(lambda e, t, v: seen.append(t.loss))
        ln.run()
        return seen, ln.store

    s0, st0 = run(0)
    s1, st1 = run(512)
    assert st1.tier is not None and st1.tier.calls["promote"] > 0
    np.testing.assert_allclose(s0, s1, rtol=1e-5)
    keys = np.arange(0, 300, dtype=np.int64)
    w0, _, _ = st0.pull(keys)
    w1, _, _ = st1.pull(keys)
    np.testing.assert_allclose(w0, w1, rtol=1e-3, atol=1e-6)
