"""The port's replay cache and chunked backward against the JAX package's,
on the CPU.

Inputs are made from seeds with numpy and handed to both packages:

- the chunked-run layout (``panel_chunk_tokens_flat`` on the device
  tensors and its numpy twin ``panel_chunk_tokens_np``) equals JAX's bit
  for bit: binary and valued panels, runs longer than ``CHUNK_L``, and a
  batch of pad cells only;
- the chunked backward agrees with JAX's (jitted) within 2e-6 relative:
  each chunk's sum over its L tokens is torch's reduction there and
  XLA's here, the per-lane sums of the chunk partials run in the same
  order;
- ``_DeviceBatchCache`` stages, freezes, gives up and replays in the same
  order as JAX's for the same sequence of batches;
- the learner at the JAX package's defaults (``device_cache_mb`` 2048,
  ``shuffle`` 10, 3 epochs of Criteo panels, validation), on the hashed
  and the dictionary store, and with a budget that holds a prefix only,
  with ``neg_sampling`` 0.5 (no training cache): per-epoch loss, AUC,
  nnz and penalty within 1e-5 relative, the final arrays within 1e-5 of
  each one's max|jax|, cnt and v_live equal;
- the plain fp8 quantizer follows the JAX reference's cast rule.

The JAX learner runs with ``num_producers=1 producer_mode=thread
fused_kernel=jnp`` (the result does not depend on them); both learners
draw their table's initial V from JAX's ``init_state`` (the port through
its store's init provider), which torch cannot reproduce.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu.learners import sgd as jsgd
from difacto_tpu.learners.sgd import SGDLearner as JLearner
from difacto_tpu.losses import FMParams as JFMParams
from difacto_tpu.losses import fm as jfm
from difacto_tpu.ops import batch as jbatch
from difacto_tpu.ops import fused as jfused
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu_torch.learners import sgd as tsgd
from difacto_tpu_torch.learners.sgd import SGDLearner, SGDLearnerParam
from difacto_tpu_torch.losses import FMParams
from difacto_tpu_torch.losses import fm as tfm
from difacto_tpu_torch.ops import batch as tbatch
from difacto_tpu_torch.ops import fused as tfused
from difacto_tpu_torch.store.convert import state_from_jax_table
from difacto_tpu_torch.updaters import sgd_updater as T

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
from chip_smoke import synthetic_criteo  # noqa: E402

JAX_THREADS = [("num_producers", "1"), ("producer_mode", "thread"),
               ("fused_kernel", "jnp")]
HYPER = [("l1", "0.1"), ("lr", "0.05"), ("V_lr", "0.05"),
         ("V_threshold", "2")]
REL = 2e-6


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo")
    (d / "train.txt").write_bytes(synthetic_criteo(400, 11))
    (d / "val.txt").write_bytes(synthetic_criteo(200, 12))
    return str(d / "train.txt"), str(d / "val.txt")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# --------------------------------------------------------- chunk layout
def _panel_cells(kind, seed):
    """(flat idx, flat vals or None, u_cap, B, F) of one panel."""
    rng = np.random.RandomState(seed)
    B, F, U = 64, 39, 300
    if kind == "all_pad":
        return (np.zeros(B * F, np.int32), np.zeros(B * F, np.float32),
                U, B, F)
    a = 1.1 if kind == "long_runs" else 1.5
    idx = (rng.zipf(a, B * F) % U).astype(np.int32)
    vals = None if kind == "binary" else \
        (rng.rand(B * F) + 0.5).astype(np.float32)
    return idx, vals, U + 7, B, F


@pytest.mark.parametrize("kind", ["binary", "valued", "long_runs",
                                  "all_pad"])
def test_chunk_layout_equals_jax_bit_for_bit(kind):
    idx, vals, u_cap, B, F = _panel_cells(kind, seed=1)
    runs = np.bincount(idx)
    assert kind != "long_runs" or runs.max() > 4 * tbatch.CHUNK_L
    want = jax.jit(lambda i, v: jbatch.panel_chunk_tokens_flat(
        i, v, u_cap, B, F))(idx, vals)
    got = tbatch.panel_chunk_tokens_flat(
        torch.from_numpy(idx), None if vals is None
        else torch.from_numpy(vals), u_cap, B, F)
    assert (got[2] is None) == (want[2] is None) == (vals is None)
    for g, w in zip(got, want):
        if w is not None:
            assert str(g.dtype) == "torch." + np.asarray(w).dtype.name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["binary", "valued", "long_runs",
                                  "all_pad"])
def test_chunk_layout_numpy_twin_equals_jax(kind):
    idx, vals, u_cap, B, F = _panel_cells(kind, seed=2)
    for extra in ({}, dict(row_base=128, C=jbatch.chunk_cap(
            u_cap, B * F) + 6)):
        want = jbatch.panel_chunk_tokens_np(idx, vals, u_cap, 3 * B, F,
                                            **extra)
        got = tbatch.panel_chunk_tokens_np(idx, vals, u_cap, 3 * B, F,
                                           **extra)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_panel_chunk_tokens_attaches_the_layout():
    idx, vals, u_cap, B, F = _panel_cells("valued", seed=3)
    pb = tbatch.PanelBatch(
        idx=torch.from_numpy(idx).view(B, F),
        vals=torch.from_numpy(vals).view(B, F),
        labels=torch.zeros(B), rweight=torch.ones(B), row_mask=torch.ones(B),
        num_rows=torch.tensor(B), num_uniq=torch.tensor(u_cap))
    got = tbatch.panel_chunk_tokens(pb, u_cap)
    want = jbatch.panel_chunk_tokens_np(idx, vals, u_cap, B, F)
    for g, w in zip((got.chunk_idx, got.chunk_lane, got.chunk_vals), want):
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------ chunked backward
def _chunked_batch(binary, seed, k):
    rng = np.random.RandomState(seed)
    B, F, U = 64, 39, 300
    idx = (rng.zipf(1.2, B * F) % U).astype(np.int32)
    vals = None if binary else (rng.rand(B * F) + 0.5).astype(np.float32)
    labels = (rng.rand(B) < 0.4).astype(np.float32)
    mask = (np.arange(B) < B - 5).astype(np.float32)
    pred = np.clip(rng.randn(B) * 2, -20, 20).astype(np.float32)
    w = (rng.randn(U) * 0.1).astype(np.float32)
    V = (rng.randn(U, k) * 0.1).astype(np.float32) if k else None
    vm = (rng.rand(U) < 0.7).astype(np.float32)
    ci, cl, cv = jbatch.panel_chunk_tokens_np(idx, vals, U, B, F)
    common = dict(labels=labels, rweight=mask, row_mask=mask)
    tpb = tbatch.PanelBatch(
        idx=torch.from_numpy(idx).view(B, F),
        vals=None if binary else torch.from_numpy(vals).view(B, F),
        num_rows=torch.tensor(B), num_uniq=torch.tensor(U),
        chunk_idx=torch.from_numpy(ci), chunk_lane=torch.from_numpy(cl),
        chunk_vals=None if binary else torch.from_numpy(cv),
        **{n: torch.from_numpy(a) for n, a in common.items()})
    jpb = jbatch.PanelBatch(
        idx=jnp.asarray(idx).reshape(B, F),
        vals=None if binary else jnp.asarray(vals).reshape(B, F),
        num_rows=jnp.int32(B), num_uniq=jnp.int32(U),
        chunk_idx=jnp.asarray(ci), chunk_lane=jnp.asarray(cl),
        chunk_vals=None if binary else jnp.asarray(cv),
        **{n: jnp.asarray(a) for n, a in common.items()})
    tp = FMParams(w=torch.from_numpy(w),
                  V=None if V is None else torch.from_numpy(V),
                  v_mask=torch.from_numpy(vm) if k else None)
    jp = JFMParams(w=jnp.asarray(w), V=None if V is None else jnp.asarray(V),
                   v_mask=jnp.asarray(vm) if k else None)
    return tpb, jpb, tp, jp, pred


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("k", [0, 8])
def test_chunked_backward_matches_jax(binary, k):
    tpb, jpb, tp, jp, pred = _chunked_batch(binary, seed=4, k=k)
    xv = None
    if k:
        _, xv = tfm.fm_predict_panel_xv(tp, tpb)
    gw, gV = tfm.fm_grad_panel(tp, tpb, torch.from_numpy(pred), xv)
    jgw, jgV = jax.jit(lambda p, b, pr: jfm.fm_grad_panel(p, b, pr))(
        jp, jpb, jnp.asarray(pred))
    assert (gV is None) == (jgV is None) == (k == 0)
    print(f"measured chunked gw: {_rel(gw.numpy(), jgw):.3g}")
    assert _rel(gw.numpy(), jgw) <= REL
    if k:
        print(f"measured chunked gV: {_rel(gV.numpy(), jgV):.3g}")
        assert _rel(gV.numpy(), jgV) <= REL


@pytest.mark.parametrize("binary", [True, False])
def test_chunked_backward_equals_the_unchunked_one(binary):
    """Two orders of the same sums (a lane's run of up to ~1000 tokens
    summed one by one, or as chunk partials): within 1e-5 relative."""
    tpb, _, tp, _, pred = _chunked_batch(binary, seed=5, k=8)
    _, xv = tfm.fm_predict_panel_xv(tp, tpb)
    pr = torch.from_numpy(pred)
    got = tfm.fm_grad_panel(tp, tpb, pr, xv)
    plain = tfm.fm_grad_panel(tp, tpb._replace(chunk_idx=None,
                                               chunk_lane=None,
                                               chunk_vals=None), pr, xv)
    for g, w in zip(got, plain):
        print(f"measured chunked vs unchunked: {_rel(g, w):.3g}")
        assert _rel(g.numpy(), w.numpy()) <= 1e-5


def test_chunk_sum_unsorted_lanes_equal_sorted():
    """``lanes_sorted=False`` (a layout concatenated from sorted blocks)
    sums each lane's chunks in their order too: lanes interleaved, each
    lane's chunks kept in order, give the sorted layout's sums bit for
    bit."""
    from difacto_tpu_torch.ops.segment import chunk_sum
    rng = np.random.RandomState(6)
    lanes = np.sort(rng.randint(0, 50, 400)).astype(np.int32)
    data = rng.randn(400, 3).astype(np.float32)
    srt = chunk_sum(torch.from_numpy(data), torch.from_numpy(lanes), 40)
    perm = np.lexsort((np.arange(400), rng.rand(50)[lanes]))
    assert (np.diff(lanes[perm]) < 0).any()
    uns = chunk_sum(torch.from_numpy(data[perm]),
                    torch.from_numpy(lanes[perm]), 40, lanes_sorted=False)
    assert srt.shape == (40, 3)
    np.testing.assert_array_equal(srt.numpy(), uns.numpy())


# ------------------------------------------------------------ the cache
def _cache_trace(mod, budget_mb, adds, repadable):
    cache = mod._DeviceBatchCache(budget_mb, repadable=repadable)
    states = []
    for part, nbytes, cap in adds:
        cache.add(part, (part, nbytes, len(states)), nbytes, capacity=cap)
        states.append((cache.used, cache.frozen, cache.alive,
                       cache.stale_pads, cache.staging,
                       sorted(cache.parts())))
    cache.finish_pass()
    states.append((cache.ready, cache.alive, cache.partial, cache.staging))
    cache.add(0, "late", 1)                  # past the staging pass
    orders = [[x for _, x in cache.iter_parts(True, seed)]
              for seed in range(3)]
    orders.append([x for _, x in cache.iter_parts(False, 0)])
    return states, orders, dict(cache.entries)


@pytest.mark.parametrize("case", ["fits", "prefix", "nothing_fits",
                                  "grows_repadable", "grows_fixed"])
def test_cache_stages_freezes_and_replays_as_jax(case):
    rng = np.random.RandomState(7)
    sizes = rng.randint(100_000, 400_000, 30)
    parts = np.repeat(np.arange(5), 6)
    caps = [4096] * 30
    budget = 64
    if case == "prefix":
        budget = 3
    elif case == "nothing_fits":
        budget = 0
    elif case.startswith("grows"):
        caps = [4096] * 10 + [8192] * 20
    adds = list(zip(parts.tolist(), sizes.tolist(), caps))
    repadable = case == "grows_repadable"
    got = _cache_trace(tsgd, budget, adds, repadable)
    want = _cache_trace(jsgd, budget, adds, repadable)
    assert got == want
    states = got[0]
    if case == "prefix":
        assert states[-1] == (True, True, True, False)
    if case == "nothing_fits":
        assert states[-1][:2] == (False, False)


# ------------------------------------------------------------- learners
def jax_init(kwargs):
    """The store init provider that hands the port JAX's init table."""
    lp, rest = SGDLearnerParam.init_allow_unknown(kwargs)
    tp, _ = T.SGDUpdaterParam.init_allow_unknown(rest)
    jp, _ = J.SGDUpdaterParam.init_allow_unknown(rest)
    if lp.loss == "logit" or tp.V_dim == 0:
        return None                      # the flat table starts at zero
    return lambda C: state_from_jax_table(
        tp, np.asarray(J.init_state(jp, C).VVg), "cpu")


def _rows(ln):
    rows = []
    ln.add_epoch_end_callback(lambda k, t, v: rows.append(
        (t.nrows, t.loss, t.auc, t.nnz_w, t.penalty, v.nrows, v.loss,
         v.auc)))
    return rows


def run_port(kwargs, model_out):
    ln = SGDLearner(device="cpu", table_init=jax_init(kwargs))
    ln.init(kwargs + [("model_out", model_out)])
    rows = _rows(ln)
    ln.run()
    return rows, dict(np.load(model_out + "_part-0")), ln


def run_jax(kwargs, model_out):
    ln = JLearner()
    ln.init(kwargs + JAX_THREADS + [("model_out", model_out)])
    rows = _rows(ln)
    ln.run()
    return rows, dict(np.load(model_out + "_part-0")), ln


def assert_runs_agree(tmp_path, kwargs, what, epochs=3):
    """Both learners on ``kwargs``; per-epoch metrics within 1e-5
    relative, the saved arrays within 1e-5 of each one's max|jax|, keys,
    cnt and v_live equal. Returns both learners."""
    rows, got, port = run_port(kwargs, str(tmp_path / "port"))
    jrows, want, jax_ln = run_jax(kwargs, str(tmp_path / "jax"))
    assert len(rows) == len(jrows) == epochs
    for e, (r, j) in enumerate(zip(rows, jrows)):
        assert (r[0], r[3], r[5]) == (j[0], j[3], j[5])   # rows, nnz
        for name, i in (("loss", 1), ("AUC", 2), ("penalty", 4),
                        ("val loss", 6), ("val AUC", 7)):
            err = abs(r[i] - j[i]) / max(abs(j[i]), 1e-30)
            print(f"measured {what} epoch {e} {name}: {err:.3g}")
            assert err <= 1e-5, (what, e, name, r[i], j[i])
    assert set(got) == set(want)
    for f in ("keys", "cnt", "v_live"):
        if f in want:
            np.testing.assert_array_equal(got[f], want[f])
    for f in ("w", "z", "sqrt_g", "V", "Vg"):
        if want[f].size:
            err = float(np.abs(got[f] - want[f]).max())
            scale = float(np.abs(want[f]).max())
            print(f"measured {what} final {f}: {err / scale:.3g} of "
                  "max|jax|")
            assert err <= 1e-5 * scale, (what, f, err, scale)
    return port, jax_ln


def defaults_kwargs(criteo, *extra):
    """The JAX package's defaults (device_cache_mb 2048, shuffle 10,
    binned training AUC, the dictionary store from init_capacity) at a
    small size: 400 Criteo rows in batches of 50 over 2 parts, 200
    validation rows, V_dim 4, 3 epochs."""
    train, val = criteo
    return [("data_in", train), ("data_val", val),
            ("data_format", "criteo"), ("V_dim", "4"), ("batch_size", "50"),
            ("num_jobs_per_epoch", "2"), ("max_num_epochs", "3"),
            ("stop_rel_objv", "0"), ("report_interval", "0"),
            ("has_aux", "1")] + HYPER + list(extra)


@pytest.mark.parametrize("store", ["hashed", "dictionary"])
def test_learner_at_jax_defaults_matches_jax(tmp_path, criteo, store):
    extra = [("hash_capacity", "4096")] if store == "hashed" \
        else [("init_capacity", "512")]
    port, jax_ln = assert_runs_agree(
        tmp_path, defaults_kwargs(criteo, *extra), store)
    info = port.device_cache_info()
    assert info == jax_ln.device_cache_info()
    assert info[tsgd.K_TRAINING]["complete"]
    assert info[tsgd.K_VALIDATION]["complete"]
    if store == "dictionary":
        assert port.store.state.capacity == jax_ln.store.state.capacity \
            > 512


def test_partial_cache_replays_the_prefix_as_jax(tmp_path, criteo):
    port, jax_ln = assert_runs_agree(
        tmp_path, defaults_kwargs(criteo, ("device_cache_mb", "1"),
                                  ("init_capacity", "512")), "partial")
    info = port.device_cache_info()
    assert info == jax_ln.device_cache_info()
    assert info[tsgd.K_TRAINING]["frozen"]
    assert info[tsgd.K_TRAINING]["staged_parts"] == 1


def test_neg_sampling_streams_training_and_replays_validation(tmp_path,
                                                              criteo):
    port, jax_ln = assert_runs_agree(
        tmp_path, defaults_kwargs(criteo, ("neg_sampling", "0.5"),
                                  ("hash_capacity", "4096")), "neg 0.5")
    info = port.device_cache_info()
    assert info == jax_ln.device_cache_info()
    assert tsgd.K_TRAINING not in info
    assert info[tsgd.K_VALIDATION]["complete"]


def test_replayed_epochs_take_the_chunked_step(tmp_path, criteo,
                                               monkeypatch):
    """Every training step of a cached panel run, epoch 0 included, gets
    the chunked layout; the staged counts tail is zeroed, and replays
    leave the staged buffers unchanged."""
    seen = []
    real = tfm._fm_grad_panel_chunked

    def spy(*a, **k):
        seen.append(a[1].chunk_lane is not None)
        return real(*a, **k)
    monkeypatch.setattr(tfm, "_fm_grad_panel_chunked", spy)
    kw = defaults_kwargs(criteo, ("hash_capacity", "4096"))
    ln = SGDLearner(device="cpu")
    ln.init(kw)
    snaps = []

    def snapshot(k, t, v):
        if k == 0:
            cache = ln._caches[tsgd.K_TRAINING]
            snaps.extend((st, [x.clone() for x in (st.i32, st.f32,
                                                   *st.chunks)])
                         for items in cache.entries.values()
                         for st in items)
    ln.add_epoch_end_callback(snapshot)
    ln.run()
    cache = ln._caches[tsgd.K_TRAINING]
    staged = [st for items in cache.entries.values() for st in items]
    assert len(seen) == 3 * len(staged) and all(seen)
    assert len(snaps) == len(staged)
    for st, before in snaps:
        assert st.chunks is not None
        # the counts tail was zeroed at staging
        assert not st.f32[st.f32.shape[0] - st.u_cap:].any()
        # two replays left every staged buffer as it was after epoch 0
        for t, b in zip((st.i32, st.f32, *st.chunks), before):
            assert torch.equal(t, b)


# ---------------------------------------------------------- the fp8 rule
def test_plain_fp8_cast_follows_jax_rule():
    """Every fp8 value, the midpoints, values past 448 (464 ties down to
    448, beyond it to NaN), +-Inf, NaN and a wide seeded sample: the
    plain version's codes equal JAX's cast of the same f32 values."""
    fp8 = np.arange(256, dtype=np.uint8).view(jnp.float8_e4m3fn)
    vals = np.asarray(fp8, np.float32)
    vals = np.sort(vals[np.isfinite(vals) & (vals >= 0)])
    mids = (vals[:-1] + vals[1:]) / 2
    rng = np.random.RandomState(8)
    wide = (rng.rand(20000) * 2 - 1).astype(np.float32) \
        * np.exp2(rng.randint(-30, 30, 20000)).astype(np.float32)
    past = np.array([448.0, 463.9, 464.0, 464.1, 470.0, 480.0, 500.0, 1000.0,
                     1e10, 3e38, np.inf, np.nan], np.float32)
    y = np.concatenate([vals, mids, np.nextafter(mids, 0),
                        np.nextafter(mids, np.inf), wide, past])
    y = np.concatenate([y, -y]).astype(np.float32)
    want = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(y).astype(jnp.float8_e4m3fn), jnp.uint8))
    got = tfused.fp8_e4m3fn_codes(torch.from_numpy(y)).numpy().view(np.uint8)
    np.testing.assert_array_equal(got, want)
    assert got[len(y) // 2 - len(past):len(y) // 2].tolist() == [
        0x7E, 0x7E, 0x7E, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F,
        0x7F]


def test_plain_quant_half_fp8_matches_jax_past_the_range():
    """Rows with +-Inf and with values far past 448: JAX's codes and
    scales. A row whose scale underflows to 0 (amax ~ 1e-44) makes x /
    scale infinite; the codes are then the rule's NaN, JAX's cast of
    those values. (JAX on the CPU itself flushes that subnormal amax to
    0 and picks scale 1: ROADMAP.md, Queue 3.)"""
    x = np.array([[500, 1000, np.inf, 470], [1e30, -3e38, 5, 0],
                  [-np.inf, 2, 3, np.inf], [1e-44, -3e-45, 0, 1e-45]],
                 np.float32)
    codes, scale = tfused.quant_half(torch.from_numpy(x), "fp8")
    jcodes, jscale = jfused.quant_half(jnp.asarray(x[:3]), "fp8")
    np.testing.assert_array_equal(codes.numpy()[:3], np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy()[:3], np.asarray(jscale))
    assert float(scale[3]) == 0.0
    y = (torch.from_numpy(x[3]) / scale[3]).numpy()
    want = np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(y).astype(jnp.float8_e4m3fn), jnp.int8))
    np.testing.assert_array_equal(codes.numpy()[3], want)
    assert (codes.numpy()[3].view(np.uint8) & 0x7F == 0x7F).all()
