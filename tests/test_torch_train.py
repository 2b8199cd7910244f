"""The port's training path against the JAX package's, on the CPU.

Inputs are made from seeds with numpy and handed to both packages:

- the host side is exact: the batch reader cuts the same batches (shuffle
  buffer and negative sampling), ``prepare_hashed`` packs the same panel
  and COO buffers, byte for byte;
- the lane sums of the backward, and with them ``spmv_t``/``spmm_t``,
  equal ``jax.ops.segment_sum`` bit for bit (both add each lane's entries
  in ascending order from 0), and the binned training AUC equals JAX's
  exactly;
- the forward and backward agree with the jitted JAX ones within 2e-6
  relative (measured up to 3.6e-7: torch's ``exp``, the k-column row
  reduction's order, and XLA's fused multiply-adds);
- one train step from the same injected table, and 3-epoch learner runs
  (synthetic Criteo rows on the panel path, tests/data/rcv1_100.libsvm on
  the COO path, both learners started from the same checkpoint) agree
  per epoch on loss, AUC, nnz and penalty within 1e-5 relative and on the
  final w/z/sqrt_g/V/Vg within 1e-4 absolute;
- two port runs are bit-identical; checkpoints with aux cross both ways
  and continue to the same next step.

The learner runs here take the streamed path on both sides
(``device_cache_mb=0``; the JAX learner also ``num_producers=1
producer_mode=thread fused_kernel=jnp``): one step program per batch.
The replay cache's path, the JAX package's default, is held to JAX in
tests/test_torch_replay.py.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu.data.batch_reader import BatchReader as JBatchReader
from difacto_tpu.data.pack_stream import ShapeSchedule as JShapes
from difacto_tpu.data.pack_stream import prepare_hashed as jprepare
from difacto_tpu.learners.sgd import SGDLearner as JLearner
from difacto_tpu.data.rowblock import RowBlock
from difacto_tpu.losses import FMParams as JFMParams
from difacto_tpu.losses import create as jcreate
from difacto_tpu.losses.metrics import auc_times_n_binned_jnp
from difacto_tpu.ops import batch as jbatch
from difacto_tpu.step import make_step_fns as jmake_step_fns
from difacto_tpu.store.local import SlotStore as JStore
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu_torch.data.batch_reader import BatchReader
from difacto_tpu_torch.data.pack_stream import ShapeSchedule, prepare_hashed
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.losses import FMParams
from difacto_tpu_torch.losses import create as tcreate
from difacto_tpu_torch.losses.metrics import auc_times_n_binned
from difacto_tpu_torch.ops import batch as tbatch
from difacto_tpu_torch.ops.segment import lane_sum
from difacto_tpu_torch.step import make_step_fns
from difacto_tpu_torch.store.convert import state_from_numpy
from difacto_tpu_torch.store.local import SlotStore
from difacto_tpu_torch.updaters import sgd_updater as T

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(_ROOT, "tests", "data", "rcv1_100.libsvm")
sys.path.insert(0, _ROOT)
from chip_smoke import synthetic_criteo  # noqa: E402

HYPER = dict(l1=0.1, lr=0.05, V_lr=0.05, V_threshold=2)
JAX_STREAMED = [("device_cache_mb", "0"), ("num_producers", "1"),
                ("producer_mode", "thread"), ("fused_kernel", "jnp")]
REL = 2e-6


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    path = tmp_path_factory.mktemp("criteo") / "train.txt"
    path.write_bytes(synthetic_criteo(400, 11))
    return str(path)


def _init_checkpoint(path, C, k, seed):
    """A fresh table with V uniform in +-0.005 from numpy, saved with aux:
    both learners start from it (their own init draws differ)."""
    p = T.SGDUpdaterParam(V_dim=k, hash_capacity=C)
    rng = np.random.RandomState(seed)
    st = SlotStore(p, device="cpu")
    st.state = state_from_numpy(p, {
        "w": np.zeros(C, np.float32),
        "V": ((rng.rand(C, k) - 0.5) * 0.01).astype(np.float32)},
        device="cpu")
    st.save(path + "_part-0", save_aux=True)


def _close(a, b, rel, what):
    """max|a - b| <= rel * max|b|; prints the measured ratio (``pytest -s``
    shows the numbers PERF.md quotes)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    print(f"measured {what}: max|port - jax| / max|jax| = {err:.3g} "
          f"(limit {rel:g})")
    assert err <= rel, (what, err)


# ------------------------------------------------------------- host side
@pytest.mark.parametrize("shuffle,neg", [(0, 1.0), (3, 1.0), (2, 0.4)])
def test_batch_reader_cuts_the_same_batches(criteo, shuffle, neg):
    kw = dict(part_idx=1, num_parts=3, batch_size=50,
              shuffle_buf_size=50 * shuffle, neg_sampling=neg, seed=7)
    got = list(BatchReader(criteo, "criteo", **kw))
    want = list(JBatchReader(criteo, "criteo", **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for f in ("offset", "label", "index"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert (g.value is None) == (w.value is None)


@pytest.mark.parametrize("data,fmt", [("criteo", "criteo"),
                                      ("rcv1", "libsvm")])
def test_prepare_hashed_packs_the_same_buffers(criteo, data, fmt):
    uri = criteo if data == "criteo" else RCV1
    blk = next(iter(BatchReader(uri, fmt, batch_size=100)))
    got = prepare_hashed(ShapeSchedule(), 4096, blk, True, True, 8, "train",
                         128)
    want = jprepare(JShapes(), 4096, blk, True, True, 8, "train", 128)
    assert got.layout == want[0] == ("panel" if data == "criteo" else "coo")
    assert (got.binary, got.b_cap, got.d2, got.u_cap) == tuple(want[3:7])
    np.testing.assert_array_equal(got.i32, want[1])
    np.testing.assert_array_equal(got.f32, want[2])


# --------------------------------------------------------------- kernels
def test_lane_sum_equals_jax_segment_sum_bit_for_bit():
    rng = np.random.RandomState(0)
    n, U, m = 20000, 3000, 6
    lanes = (rng.zipf(1.3, n) % U).astype(np.int32)
    data = (rng.randn(n, m) * np.exp(rng.randn(n, m) * 3)).astype(np.float32)
    got = lane_sum(torch.from_numpy(data), torch.from_numpy(lanes), U)
    want = jax.jit(lambda d, i: jax.ops.segment_sum(d, i, num_segments=U))(
        data, lanes)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_binned_auc_equals_jax():
    rng = np.random.RandomState(1)
    for B in (8, 1000, 4096):
        pred = np.clip(rng.randn(B) * 4, -20, 20).astype(np.float32)
        label = (rng.rand(B) < 0.3).astype(np.float32)
        mask = (np.arange(B) < B - 3).astype(np.float32)
        got = auc_times_n_binned(*(torch.from_numpy(a)
                                   for a in (label, pred, mask)))
        want = jax.jit(auc_times_n_binned_jnp)(label, pred, mask)
        assert float(got) == float(want)


def _batch(kind, seed, U=300, B=64):
    """The same packed batch for both packages (the JAX packers; the port
    unpacks the same buffers) and [w, V, vmask] rows for its slots."""
    rng = np.random.RandomState(seed)
    k = 8
    w = (rng.randn(U) * 0.1).astype(np.float32)
    V = (rng.randn(U, k) * 0.1).astype(np.float32)
    vm = (rng.rand(U) < 0.7).astype(np.float32)
    F = 39
    if kind.startswith("panel"):
        nnz = np.full(B, F) if kind == "panel_binary" else \
            rng.randint(30, F + 1, B)
    else:
        nnz = rng.randint(1, 120, B)
    off = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    idx = (rng.zipf(1.2, off[-1]) % U).astype(np.uint32)
    value = None if kind == "panel_binary" else \
        rng.rand(off[-1]).astype(np.float32) + 0.5
    blk = RowBlock(offset=off, label=(rng.rand(B) < 0.4).astype(np.float32),
                   index=idx, value=value)
    slots = np.arange(U, dtype=np.int32)
    if kind.startswith("panel"):
        width = jbatch.panel_width(blk, B)
        assert width == F
        i32, f32, binary = jbatch.pack_panel(blk, U, slots, B, F, U)
        tb, _, _ = tbatch.unpack_panel(torch.from_numpy(i32),
                                       torch.from_numpy(f32), B, F, U,
                                       binary=binary)
        jb, _, _ = jbatch.unpack_panel(jnp.asarray(i32), jnp.asarray(f32), B,
                                       F, U, binary=binary)
    else:
        nc = jbatch.bucket(off[-1])
        i32, f32, binary = jbatch.pack_batch(blk, U, slots, B, nc, U)
        tb, _, _ = tbatch.unpack_batch(torch.from_numpy(i32),
                                       torch.from_numpy(f32), B, nc, U,
                                       int(nnz.max()), binary=binary)
        jb, _, _ = jbatch.unpack_batch(jnp.asarray(i32), jnp.asarray(f32), B,
                                       nc, U, binary=binary)
    tp = FMParams(w=torch.from_numpy(w), V=torch.from_numpy(V),
                  v_mask=torch.from_numpy(vm))
    return tb, jb, tp, JFMParams(w=jnp.asarray(w), V=jnp.asarray(V),
                                 v_mask=jnp.asarray(vm))


@pytest.mark.parametrize("kind", ["panel_binary", "panel_valued", "coo"])
def test_forward_and_backward_match_jax(kind):
    tb, jb, tp, jp = _batch(kind, seed=3)
    tloss, jloss = tcreate("fm", 8), jcreate("fm", 8)
    pred, xv = tloss.predict_xv(tp, tb)
    gw, gV = tloss.calc_grad(tp, tb, pred, xv)

    def jax_fwd_bwd(params, batch):
        p, x = jloss.predict_xv(params, batch)
        return (p, x) + tuple(jloss.calc_grad(params, batch, p, x))
    jpred, jxv, jgw, jgV = jax.jit(jax_fwd_bwd)(jp, jb)
    for name, a, b in (("pred", pred, jpred), ("XV", xv, jxv),
                       ("gw", gw, jgw), ("gV", gV, jgV)):
        _close(a.numpy(), np.asarray(b), REL, f"{kind} {name}")


@pytest.mark.parametrize("binary", [True, False])
def test_transposed_products_match_jax(binary):
    """spmv_t / spmm_t over a COO batch: the same products, each column
    summed in ascending entry order as XLA's CPU scatter-add."""
    from difacto_tpu.ops import segment as jseg
    from difacto_tpu_torch.ops import segment as tseg
    tb, jb, _, _ = _batch("coo", seed=14)
    rng = np.random.RandomState(15)
    B, U = tb.batch_cap, 300
    p = rng.randn(B).astype(np.float32)
    P = rng.randn(B, 5).astype(np.float32)
    vals, jvals = tb.vals, jb.vals
    if binary:
        vals = torch.ones_like(vals) * (tb.vals != 0)
        jvals = jnp.asarray(vals.numpy())
    got_v = tseg.spmv_t(vals, tb.rows, tb.cols, torch.from_numpy(p), U)
    got_m = tseg.spmm_t(vals, tb.rows, tb.cols, torch.from_numpy(P), U)
    want_v, want_m = jax.jit(lambda v, r, c: (
        jseg.spmv_t(v, r, c, jnp.asarray(p), U),
        jseg.spmm_t(v, r, c, jnp.asarray(P), U)))(jvals, jb.rows, jb.cols)
    np.testing.assert_array_equal(got_v.numpy().view(np.uint32),
                                  np.asarray(want_v).view(np.uint32))
    np.testing.assert_array_equal(got_m.numpy().view(np.uint32),
                                  np.asarray(want_m).view(np.uint32))


def _arrays(tp_param, n, seed):
    """Logical columns of a trained-looking table."""
    rng = np.random.RandomState(seed)
    k = tp_param.V_dim
    arrays = dict(w=(rng.randn(n) * 0.05).astype(np.float32),
                  z=(rng.randn(n) * 0.2).astype(np.float32),
                  sqrt_g=np.abs(rng.randn(n)).astype(np.float32),
                  cnt=rng.randint(0, 6, n).astype(np.float32),
                  v_live=rng.rand(n) < 0.6,
                  V=(rng.randn(n, k) * 0.05).astype(np.float32),
                  Vg=np.abs(rng.randn(n, k)).astype(np.float32))
    return arrays


@pytest.mark.parametrize("data,fmt", [("criteo", "criteo"),
                                      ("rcv1", "libsvm")])
def test_one_train_step_matches_jax(criteo, data, fmt):
    uri = criteo if data == "criteo" else RCV1
    C, k = 2048, 8
    kw = dict(V_dim=k, hash_capacity=C, **HYPER)
    tparam, jparam = T.SGDUpdaterParam(**kw), J.SGDUpdaterParam(**kw)
    arrays = _arrays(tparam, C, seed=4)
    blk = next(iter(BatchReader(uri, fmt, batch_size=100)))
    pl = prepare_hashed(ShapeSchedule(), C, blk, False, False, 8, "train",
                        128)
    # the port's step
    state = state_from_numpy(tparam, arrays, device="cpu")
    fns = T.make_fns(tparam)
    _, step, _ = make_step_fns(fns, tcreate("fm", k))
    i32, f32 = torch.from_numpy(pl.i32), torch.from_numpy(pl.f32)
    if pl.layout == "panel":
        b, s, _ = tbatch.unpack_panel(i32, f32, pl.b_cap, pl.d2, pl.u_cap,
                                      binary=pl.binary)
    else:
        b, s, _ = tbatch.unpack_batch(i32, f32, pl.b_cap, pl.d2, pl.u_cap,
                                      pl.row_cap, binary=pl.binary)
    state, objv, auc = step(state, b, s)
    # the JAX step from the same table
    js = JStore(jparam)
    js._commit_hashed({f: a.copy() for f, a in arrays.items()})
    _, jstep, _ = jmake_step_fns(js.fns, jcreate("fm", k))
    if pl.layout == "panel":
        jb, jsl, _ = jbatch.unpack_panel(jnp.asarray(pl.i32),
                                         jnp.asarray(pl.f32), pl.b_cap,
                                         pl.d2, pl.u_cap, binary=pl.binary)
    else:
        jb, jsl, _ = jbatch.unpack_batch(jnp.asarray(pl.i32),
                                         jnp.asarray(pl.f32), pl.b_cap,
                                         pl.d2, pl.u_cap, binary=pl.binary)
    jstate, jobjv, jauc = jax.jit(jstep)(js.state, jb, jsl)
    _close(float(objv), float(jobjv), 1e-6, f"{data} step objective")
    assert float(auc) == float(jauc)
    _close(state.VVg.numpy(), np.asarray(jstate.VVg), 1e-6,
           f"{data} step table")


def test_store_pad_slots_matches_jax():
    kw = dict(V_dim=4, hash_capacity=1024)
    port = SlotStore(T.SGDUpdaterParam(**kw), device="cpu")
    ref = JStore(J.SGDUpdaterParam(**kw))
    for real, cap in (([1, 5, 77, 1023], 8), ([], 4), (list(range(1, 9)), 8)):
        slots = np.array(real, np.int32)
        np.testing.assert_array_equal(port.pad_slots(slots, cap).numpy(),
                                      np.asarray(ref.pad_slots(slots, cap)))


# --------------------------------------------------------------- learner
def _run_port(kwargs, model_out):
    rows = []
    ln = SGDLearner(device="cpu")
    ln.init(kwargs + [("model_out", model_out)])
    ln.add_epoch_end_callback(lambda k, t, v: rows.append(
        (t.nrows, t.loss, t.auc, t.nnz_w, t.penalty)))
    ln.run()
    return rows, dict(np.load(model_out + "_part-0"))


def _run_jax(kwargs, model_out):
    rows = []
    ln = JLearner()
    ln.init(kwargs + JAX_STREAMED + [("model_out", model_out)])
    ln.add_epoch_end_callback(lambda k, t, v: rows.append(
        (t.nrows, t.loss, t.auc, t.nnz_w, t.penalty)))
    ln.run()
    return rows, dict(np.load(model_out + "_part-0"))


def _learner_kwargs(tmp_path, criteo, data):
    C, k = 4096, 4
    init = str(tmp_path / "init")
    _init_checkpoint(init, C, k, seed=5)
    uri, fmt = (criteo, "criteo") if data == "criteo" else (RCV1, "libsvm")
    return [("data_in", uri), ("data_format", fmt), ("V_dim", str(k)),
            ("hash_capacity", str(C)), ("has_aux", "1"),
            ("max_num_epochs", "3"), ("batch_size", "50"),
            ("num_jobs_per_epoch", "2"), ("shuffle", "2"),
            ("report_interval", "0"), ("model_in", init),
            ("device_cache_mb", "0")] + \
        [(a, str(b)) for a, b in HYPER.items()]


@pytest.mark.parametrize("data", ["criteo", "rcv1"])
def test_learner_matches_jax(tmp_path, criteo, data):
    kw = _learner_kwargs(tmp_path, criteo, data)
    rows, got = _run_port(kw, str(tmp_path / "port"))
    jrows, want = _run_jax(kw, str(tmp_path / "jax"))
    assert len(rows) == len(jrows) == 3
    for e, (r, j) in enumerate(zip(rows, jrows)):
        assert r[0] == j[0] and r[3] == j[3]          # rows, nnz
        for name, i in (("loss", 1), ("AUC", 2), ("penalty", 4)):
            _close(r[i], j[i], 1e-5, f"{data} epoch {e} {name}")
    for f in ("cnt", "v_live"):
        np.testing.assert_array_equal(got[f], want[f])
    for f in ("w", "z", "sqrt_g", "V", "Vg"):
        # each array against its own size: a fault in a few rows of V
        # must not hide under a limit set by the whole range
        err = float(np.abs(got[f] - want[f]).max())
        scale = float(np.abs(want[f]).max())
        print(f"measured {data} final {f}: max|port - jax| = {err:.3g}, "
              f"{err / scale:.3g} of max|jax| (limit 1e-5)")
        assert err <= 1e-5 * scale, (data, f, err, scale)


def test_two_port_runs_are_bit_identical(tmp_path, criteo):
    kw = _learner_kwargs(tmp_path, criteo, "criteo")
    rows1, a = _run_port(kw, str(tmp_path / "a"))
    rows2, b = _run_port(kw, str(tmp_path / "b"))
    assert rows1 == rows2
    for f in a:
        np.testing.assert_array_equal(a[f], b[f])


def test_checkpoint_with_aux_round_trips_both_ways(tmp_path, criteo):
    """A port checkpoint loads in JAX's SlotStore and a JAX checkpoint in
    the port's; from the same checkpoint, one step of either package
    leaves the same table."""
    C, k = 2048, 8
    kw = dict(V_dim=k, hash_capacity=C, **HYPER)
    tparam, jparam = T.SGDUpdaterParam(**kw), J.SGDUpdaterParam(**kw)
    arrays = _arrays(tparam, C, seed=6)
    port = SlotStore(tparam, device="cpu")
    port.state = state_from_numpy(tparam, arrays, device="cpu")
    port.save(str(tmp_path / "p_part-0"), save_aux=True)
    jstore = JStore(jparam)
    jstore.load(str(tmp_path / "p_part-0"))
    jstore.save(str(tmp_path / "j_part-0"), save_aux=True)
    back = SlotStore(tparam, device="cpu")
    back.load(str(tmp_path / "j_part-0"))
    np.testing.assert_array_equal(back.state.VVg.numpy().view(np.uint32),
                                  port.state.VVg.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jstore.state.VVg).view(
        np.uint32), port.state.VVg.numpy().view(np.uint32))
    # continue one step on each side from the crossed checkpoints
    blk = next(iter(BatchReader(criteo, "criteo", batch_size=100)))
    pl = prepare_hashed(ShapeSchedule(), C, blk, False, False, 8, "train",
                        128)
    _, step, _ = make_step_fns(back.fns, tcreate("fm", k))
    b, s, _ = tbatch.unpack_panel(torch.from_numpy(pl.i32),
                                  torch.from_numpy(pl.f32), pl.b_cap, pl.d2,
                                  pl.u_cap, binary=pl.binary)
    st, _, _ = step(back.state, b, s)
    _, jstep, _ = jmake_step_fns(jstore.fns, jcreate("fm", k))
    jb, jsl, _ = jbatch.unpack_panel(jnp.asarray(pl.i32),
                                     jnp.asarray(pl.f32), pl.b_cap, pl.d2,
                                     pl.u_cap, binary=pl.binary)
    jst, _, _ = jax.jit(jstep)(jstore.state, jb, jsl)
    _close(st.VVg.numpy(), np.asarray(jst.VVg), 1e-6,
           "step from crossed checkpoints")


# ------------------------------------------------------------ the CLI
def test_cli_train_saves_a_model_jax_pred_scores(tmp_path):
    from difacto_tpu.__main__ import main as jmain
    from difacto_tpu_torch.__main__ import main
    model = str(tmp_path / "m")
    assert main(["task=train", "device=cpu", f"data_in={RCV1}", "V_dim=2",
                 "hash_capacity=4096", f"model_out={model}", "has_aux=1",
                 "max_num_epochs=2"]) == 0
    assert os.path.exists(model + "_part-0")
    pred = str(tmp_path / "pred")
    assert jmain(["task=pred", f"model_in={model}", f"data_in={RCV1}",
                  "V_dim=2", "hash_capacity=4096", f"pred_out={pred}"]) == 0
    lines = open(pred + "_part-0").read().split()
    probs = np.array(lines[1::2], np.float64)
    assert len(probs) == 100 and np.all((probs > 0) & (probs < 1))


@pytest.mark.parametrize("knob", [
    "wal_flush_batches=4", "replica_peers=/tmp/x", "mesh_force=1",
    "bounded_delay=2", "admit_min_count=2", "evict_occupancy=0.5",
    "cold_tier_rows=64"])
def test_knobs_that_change_the_result_raise_when_not_ported(knob,
                                                            tmp_path):
    """Only multi-host's knob (``bounded_delay > 0``) still raises, naming
    its ROADMAP.md item 11b; ``mesh_force`` now builds the 1 x 1 mesh and
    trains (its table equals the flat run's, tests/test_torch_fs_sharding.py),
    and the capacity and durability knobs are ported (with a
    ``model_out`` for the WAL)."""
    k, v = knob.split("=")
    kwargs = dict([("data_in", RCV1), ("V_dim", "2"),
                   ("hash_capacity", "4096")])
    kwargs[k] = v
    if k == "bounded_delay":
        with pytest.raises(NotImplementedError, match="item 11b"):
            SGDLearner(device="cpu").init(list(kwargs.items()))
        return
    if k == "mesh_force":
        kwargs["max_num_epochs"] = "1"
        ln = SGDLearner(device="cpu")
        assert ln.init(list(kwargs.items())) == []
        assert ln.mesh is not None and ln.mesh.shape == {"dp": 1, "fs": 1}
        ln.run()
        assert ln.store.state.VVg.abs().sum() > 0
        return
    kwargs["model_out"] = str(tmp_path / "m")
    ln = SGDLearner(device="cpu")
    assert ln.init(list(kwargs.items())) == []
    ln.stop()


def test_speed_knobs_are_accepted_and_logged(caplog, monkeypatch):
    """The producer knobs take effect: a run with two producer threads
    reads its parts through the pool (its parse and pack stages count
    seconds) and reports the thread transport; ``mesh_dp=2`` builds a
    (2, 1) mesh over two virtual CPU devices, and says so."""
    import logging
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "2")
    ln = SGDLearner(device="cpu")
    with caplog.at_level(logging.INFO, logger="difacto_tpu_torch"):
        ln.init([
            ("data_in", RCV1), ("V_dim", "2"), ("hash_capacity", "4096"),
            ("num_producers", "2"), ("producer_mode", "thread"),
            ("producer_depth", "2"), ("straggler_timeout", "30"),
            ("max_num_epochs", "1"), ("report_interval", "0"),
            ("mesh_dp", "2")])
    assert ln.mesh is not None and ln.mesh.shape == {"dp": 2, "fs": 1}
    assert "mesh: dp=2 fs=1" in caplog.text and "ignored" not in caplog.text
    ln.run()
    stats = ln.stage_stats()
    assert stats["producer_mode"] == "thread"
    assert stats["parse_s"] > 0 and stats["pack_s"] > 0
    assert ln.obs.value("train_rows_total") == 100


@pytest.mark.parametrize("which", ["learner", "updater"])
def test_params_have_every_jax_key_and_default(which):
    from dataclasses import fields
    from difacto_tpu.learners.sgd import SGDLearnerParam as JLParam
    from difacto_tpu_torch.learners.sgd import SGDLearnerParam as TLParam
    port, ref = ((TLParam, JLParam) if which == "learner"
                 else (T.SGDUpdaterParam, J.SGDUpdaterParam))
    assert ({f.name: f.default for f in fields(port)}
            == {f.name: f.default for f in fields(ref)})


def test_progress_rows_print_as_jax():
    from difacto_tpu.utils.progress import Progress as JProgress
    from difacto_tpu.utils.progress import ReportProg as JReportProg
    from difacto_tpu_torch.utils.progress import Progress, ReportProg
    rng = np.random.RandomState(12)
    got, want = ReportProg(), JReportProg()
    for _ in range(4):
        vals = dict(nrows=float(rng.randint(1, 10 ** 6)),
                    loss=float(rng.rand() * 1e5), auc=float(rng.rand() * 1e5),
                    nnz_w=float(rng.randint(0, 10 ** 7)))
        p, j = Progress(**vals), JProgress(**vals)
        assert p.text() == j.text()
        got.prog.merge(p)
        want.prog.merge(j)
        assert got.print_str() == want.print_str()
