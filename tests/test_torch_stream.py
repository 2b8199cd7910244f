"""The port's streamed training pipeline against the JAX package's, on the
CPU: the device-dedup and host-chunk pack arms, ``dedup_tokens``, and the
learner with every producer knob.

- ``dedup_tokens`` equals JAX's (jitted) bit for bit on random, all-equal
  and all-distinct tokens, with ``n_uniq = u_cap - 1``;
- ``pack_panel_raw`` / ``unpack_panel_raw``, ``chunk_host``,
  ``_count_distinct`` and ``prepare_hashed``'s ``device_dedup`` and
  ``stream_chunk`` arms give JAX's bytes and values;
- ``spec_iter`` (the worker's make_iter) yields the batches the learner's
  producer threads yield;
- serial, thread and process producers leave bit-identical tables, and
  so does ``device_dedup=1`` against 0; ``stream_chunks=1`` agrees with
  the unsorted backward within 2e-5 relative;
- the port learner with each knob agrees with the JAX learner with the
  same knob (the JAX learner on its thread transport, see ``run_jax``):
  per-epoch loss, AUC, nnz and penalty within 1e-5 relative, the final
  arrays within 1e-5 of each one's max|jax|.

Both learners draw the table's initial V from JAX's ``init_state`` (the
port through its store's init provider); the JAX learner runs with
``fused_kernel=jnp``.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difacto_tpu.data import pack_stream as jps
from difacto_tpu.data.rowblock import RowBlock as JRowBlock
from difacto_tpu.learners.sgd import SGDLearner as JLearner
from difacto_tpu.ops import batch as jbatch
from difacto_tpu.ops import fused as jfused
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu_torch.data import pack_stream as tps
from difacto_tpu_torch.data.rowblock import RowBlock
from difacto_tpu_torch.learners.sgd import SGDLearner, SGDLearnerParam
from difacto_tpu_torch.ops import batch as tbatch
from difacto_tpu_torch.ops import fused as tfused
from difacto_tpu_torch.store.convert import state_from_jax_table
from difacto_tpu_torch.updaters import sgd_updater as T

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
from chip_smoke import synthetic_criteo  # noqa: E402

HYPER = [("l1", "0.1"), ("lr", "0.05"), ("V_lr", "0.05"),
         ("V_threshold", "2")]


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo_stream")
    (d / "train.txt").write_bytes(synthetic_criteo(400, 21))
    (d / "val.txt").write_bytes(synthetic_criteo(150, 22))
    return str(d / "train.txt"), str(d / "val.txt")


# ----------------------------------------------------------- dedup_tokens
def _tokens(kind, n, u_cap, seed):
    rng = np.random.RandomState(seed)
    if kind == "all_equal":
        return np.full(n, 17, np.int32)
    if kind == "all_distinct":
        return rng.permutation(np.arange(1, u_cap))[:n].astype(np.int32)
    # random: exactly u_cap - 1 distinct values, each present
    vals = rng.choice(np.arange(1, 4000), u_cap - 1, replace=False)
    tok = np.concatenate([vals, rng.choice(vals, n - len(vals))])
    return rng.permutation(tok).astype(np.int32)


@pytest.mark.parametrize("kind,n,u_cap", [
    ("random", 600, 96), ("all_equal", 64, 8), ("all_equal", 1, 2),
    ("all_distinct", 95, 96)])
def test_dedup_tokens_equal_jax_bit_for_bit(kind, n, u_cap):
    tok = _tokens(kind, n, u_cap, seed=n)
    if kind != "all_equal":
        assert len(np.unique(tok)) == u_cap - 1
    cap = 4096
    want = jax.jit(lambda t: jfused.dedup_tokens(t, u_cap, cap))(tok)
    got = tfused.dedup_tokens(torch.from_numpy(tok), u_cap, cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slots, inverse, n_uniq = (g.numpy() for g in got)
    uniq = np.unique(tok)
    np.testing.assert_array_equal(slots[:n_uniq], uniq)
    np.testing.assert_array_equal(slots[inverse], tok)
    assert (np.diff(slots) > 0).all() and slots[-1] == cap + u_cap - 1


# -------------------------------------------------------------- packing
def _block(kind, seed, rows=48, width=6):
    """(port RowBlock, JAX RowBlock) over the same seeded arrays."""
    rng = np.random.RandomState(seed)
    if kind == "ragged":
        nnz = rng.randint(width - 2, width + 1, rows)
    else:
        nnz = np.full(rows, width)
    offset = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    index = rng.randint(0, 3000, offset[-1]).astype(np.uint64)
    value = None if kind == "binary" else \
        rng.rand(offset[-1]).astype(np.float32)
    label = rng.randint(0, 2, rows).astype(np.float32)
    return (RowBlock(offset=offset, label=label, index=index, value=value),
            JRowBlock(offset=offset, label=label, index=index, value=value))


@pytest.mark.parametrize("kind", ["binary", "valued", "ragged"])
def test_raw_panel_pack_equals_jax(kind):
    tb, jb = _block(kind, seed=3)
    from difacto_tpu_torch.base import reverse_bytes
    from difacto_tpu_torch.store.slots import hash_slots
    t = hash_slots(reverse_bytes(tb.index), 4096)
    n = tps._count_distinct(t, 4096)
    assert n == jps._count_distinct(t, 4096) == len(np.unique(t))
    assert tps._count_distinct(t, 1 << 25) == n
    tblk = dataclasses.replace(tb, index=t.astype(np.uint32))
    jblk = dataclasses.replace(jb, index=t.astype(np.uint32))
    width = tbatch.panel_width(tblk, 48)
    assert width == jbatch.panel_width(jblk, 48)
    got = tbatch.pack_panel_raw(tblk, n, 48, width)
    want = jbatch.pack_panel_raw(jblk, n, 48, width)
    assert got[2] == want[2] == (kind == "binary")
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    pb = tbatch.unpack_panel_raw(torch.from_numpy(got[0]),
                                 torch.from_numpy(got[1]), 48, width,
                                 binary=got[2])
    jpb = jbatch.unpack_panel_raw(jnp.asarray(want[0]),
                                  jnp.asarray(want[1]), 48, width,
                                  binary=want[2])
    for f in ("idx", "vals", "labels", "rweight", "row_mask", "num_rows",
              "num_uniq"):
        g, w = getattr(pb, f), getattr(jpb, f)
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["binary", "valued", "ragged"])
@pytest.mark.parametrize("arm", ["device_dedup", "stream_chunk",
                                 "counts"])
def test_prepare_hashed_arms_equal_jax(kind, arm):
    """Each arm of prepare_hashed gives JAX's payload: the raw panel past
    the count push (host dedup while counts fill), the panel with its
    host-built chunks, and the counted panel."""
    tb, jb = _block(kind, seed=5)
    fill = arm == "counts"
    kw = dict(stream_chunk=arm == "stream_chunk",
              device_dedup=arm in ("device_dedup", "counts"))
    got = tps.prepare_hashed(tps.ShapeSchedule(), 4096, tb, fill, fill, 8,
                             "train", 48, **kw)
    want = jps.prepare_hashed(jps.ShapeSchedule(), 4096, jb, fill, fill,
                              8, "train", 48, **kw)
    if arm == "stream_chunk":
        assert want[0] == "panel_chunked" and got.layout == "panel"
        (_, wi, wf, wch, wbin, wb, wd, wu) = want
        for g, w in zip(got.chunks, wch):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
        want = ("panel", wi, wf, wbin, wb, wd, wu)
    assert got.layout == want[0]
    assert got.layout == ("panel_raw" if arm == "device_dedup" else "panel")
    np.testing.assert_array_equal(got.i32, want[1])
    np.testing.assert_array_equal(got.f32, want[2])
    assert (got.binary, got.b_cap, got.d2, got.u_cap) == tuple(want[3:7])


def test_chunk_host_equals_jax():
    tb, jb = _block("ragged", seed=9, rows=64, width=8)
    p = tps.prepare_hashed(tps.ShapeSchedule(), 512, tb, False, False, 8,
                           "train", 64)
    got = tps.chunk_host(p.i32, p.f32, p.b_cap, p.d2, p.u_cap, p.binary)
    want = jps.chunk_host(p.i32, p.f32, p.b_cap, p.d2, p.u_cap, p.binary)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) == tbatch.chunk_cap(p.u_cap, p.b_cap * p.d2)


def test_prepare_hashed_raw_falls_back_on_coo():
    """A block too ragged for a panel packs COO with the host dedup."""
    rng = np.random.RandomState(2)
    nnz = np.array([1] * 30 + [40])
    offset = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    blk = RowBlock(offset=offset, label=np.zeros(31, np.float32),
                   index=rng.randint(0, 99, offset[-1]).astype(np.uint64),
                   value=None)
    p = tps.prepare_hashed(tps.ShapeSchedule(), 4096, blk, False, False,
                           8, "train", 32, device_dedup=True)
    assert p.layout == "coo"


def test_spec_iter_yields_the_thread_producers_batches(criteo):
    """The worker's make_iter and the learner's producer threads pack the
    same payloads for a part (the learner's make_iter is the thread
    twin; here both are fed from one sticky schedule's snapshot)."""
    from difacto_tpu_torch.data.batch_reader import BatchReader
    train, _ = criteo
    spec = tps.StreamSpec(
        parts=(0, 1), n_jobs=2, data_in=train, data_format="criteo",
        batch_size=50, shuffle=10, neg_sampling=1.0, epoch=1,
        hash_capacity=4096, want_counts=False, fill_counts=False,
        dim_min=8, job="train", b_cap=56, device_dedup=True)
    got = list(tps.spec_iter(spec, 1))
    shapes = tps.ShapeSchedule()
    want = [tps.prepare_hashed(shapes, 4096, blk, False, False, 8, "train",
                               56, device_dedup=True)
            for blk in BatchReader(train, "criteo", 1, 2, 50, 500, 1.0,
                                   seed=1 * 2 + 1)]
    assert len(got) == len(want) > 0
    for (kind, info, g), w in zip(got, want):
        assert kind == "ready" and g.layout == w.layout == "panel_raw"
        assert info.size == int(w.i32[-2])
        np.testing.assert_array_equal(g.i32, w.i32)
        np.testing.assert_array_equal(g.f32, w.f32)


# ------------------------------------------------------------- learners
def jax_init(kwargs):
    lp, rest = SGDLearnerParam.init_allow_unknown(kwargs)
    tp, _ = T.SGDUpdaterParam.init_allow_unknown(rest)
    jp, _ = J.SGDUpdaterParam.init_allow_unknown(rest)
    return lambda C: state_from_jax_table(
        tp, np.asarray(J.init_state(jp, C).VVg), "cpu")


def stream_kwargs(criteo, *extra):
    """Streamed hashed training (no replay cache): 400 Criteo rows in
    batches of 50 over 2 parts, 150 validation rows, V_dim 4, 3 epochs,
    shuffle on."""
    train, val = criteo
    return [("data_in", train), ("data_val", val),
            ("data_format", "criteo"), ("V_dim", "4"), ("batch_size", "50"),
            ("num_jobs_per_epoch", "2"), ("max_num_epochs", "3"),
            ("stop_rel_objv", "0"), ("stop_val_auc", "-2"),
            ("report_interval", "0"),
            ("hash_capacity", "4096"), ("device_cache_mb", "0"),
            ("has_aux", "1")] + HYPER + list(extra)


def _rows(ln):
    rows = []
    ln.add_epoch_end_callback(lambda k, t, v: rows.append(
        (t.nrows, t.loss, t.auc, t.nnz_w, t.penalty, v.nrows, v.loss,
         v.auc)))
    return rows


def run_port(kwargs, model_out=None):
    ln = SGDLearner(device="cpu", table_init=jax_init(kwargs))
    ln.init(kwargs + ([("model_out", model_out)] if model_out else []))
    rows = _rows(ln)
    ln.run()
    return rows, ln


def run_jax(kwargs, model_out=None):
    """The JAX learner on ``kwargs`` with its thread transport: its worker
    processes would put ``difacto_ring`` segments in /dev/shm, which the
    JAX suite's own leak checks, running beside these tests, count as
    theirs. Its result does not depend on the transport, and the port's
    process runs are held to its thread runs bit for bit above."""
    ln = JLearner()
    ln.init(kwargs + [("fused_kernel", "jnp"), ("producer_mode", "thread")]
            + ([("model_out", model_out)] if model_out else []))
    rows = _rows(ln)
    ln.run()
    return rows, ln


def assert_close_to_jax(rows, jrows, got, want, what):
    assert len(rows) == len(jrows) > 0
    for e, (r, j) in enumerate(zip(rows, jrows)):
        assert (r[0], r[3], r[5]) == (j[0], j[3], j[5])
        for name, i in (("loss", 1), ("AUC", 2), ("penalty", 4),
                        ("val loss", 6), ("val AUC", 7)):
            err = abs(r[i] - j[i]) / max(abs(j[i]), 1e-30)
            assert err <= 1e-5, (what, e, name, r[i], j[i])
    for f in ("cnt", "v_live"):
        np.testing.assert_array_equal(got[f], want[f])
    for f in ("w", "z", "sqrt_g", "V", "Vg"):
        err = float(np.abs(got[f] - want[f]).max())
        scale = float(np.abs(want[f]).max())
        assert err <= 1e-5 * scale, (what, f, err, scale)


def _bits(ln):
    return ln.store.state.VVg.view(torch.int32).clone()


@pytest.fixture(scope="module")
def serial_run(criteo):
    rows, ln = run_port(stream_kwargs(
        criteo, ("num_producers", "1"), ("producer_mode", "thread")))
    return rows, _bits(ln)


@pytest.mark.parametrize("knobs", [
    "num_producers=4 producer_mode=thread",
    "num_producers=4 producer_mode=process",
    "num_producers=1 producer_mode=process",
    "num_producers=2 producer_mode=process device_dedup=1",
    "num_producers=1 producer_mode=thread device_dedup=1",
    "num_producers=3 producer_mode=thread producer_depth=1 "
    "straggler_timeout=30 ring_slot_mb=2"])
def test_producer_knobs_leave_the_serial_table_bit_for_bit(criteo,
                                                           serial_run,
                                                           knobs):
    rows0, bits0 = serial_run
    extra = [tuple(kv.split("=")) for kv in knobs.split()]
    rows, ln = run_port(stream_kwargs(criteo, *extra))
    assert rows == rows0
    assert torch.equal(_bits(ln), bits0)
    mode = dict(extra)["producer_mode"]
    assert ln.stage_stats()["producer_mode"] == mode


def test_stream_chunks_agree_with_the_unsorted_backward(criteo, serial_run):
    rows0, bits0 = serial_run
    kw = stream_kwargs(criteo, ("num_producers", "2"),
                       ("stream_chunks", "1"))
    rows, ln = run_port(kw)
    rows2, ln2 = run_port(kw)
    assert rows == rows2 and torch.equal(_bits(ln), _bits(ln2))
    for r, r0 in zip(rows, rows0):
        assert r[0] == r0[0]
        for i in (1, 2, 4, 6, 7):
            assert abs(r[i] - r0[i]) <= 2e-5 * max(abs(r0[i]), 1e-30)
    ref = bits0.view(torch.float32)
    got = ln.store.state.VVg
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())


@pytest.mark.parametrize("knobs", [
    "num_producers=2 producer_mode=process",
    "stream_chunks=1 num_producers=2 producer_mode=thread",
    "device_dedup=1 num_producers=1 producer_mode=thread",
    "producer_depth=1 num_producers=3 producer_mode=thread "
    "straggler_timeout=30"])
def test_learner_with_each_knob_matches_jax(tmp_path, criteo, knobs):
    extra = [tuple(kv.split("=")) for kv in knobs.split()]
    kw = stream_kwargs(criteo, *extra)
    rows, port = run_port(kw, str(tmp_path / "port"))
    jrows, jln = run_jax(kw, str(tmp_path / "jax"))
    got = dict(np.load(str(tmp_path / "port") + "_part-0"))
    want = dict(np.load(str(tmp_path / "jax") + "_part-0"))
    assert_close_to_jax(rows, jrows, got, want, knobs)
    assert port.stage_stats()["producer_mode"] == dict(extra).get(
        "producer_mode", "thread")


def test_fast_paths_stand_down_while_the_cache_may_stage(criteo,
                                                         monkeypatch):
    """At the default device_cache_mb, device_dedup and stream_chunks
    never engage (the cache replays from the card) and the process pool
    stays off while the cache stages: the run equals one without the
    knobs bit for bit."""
    kw = stream_kwargs(criteo)
    kw = [(k, v) for k, v in kw if k != "device_cache_mb"]
    seen = []
    real = tps.prepare_hashed

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out.layout)
        return out

    monkeypatch.setattr("difacto_tpu_torch.learners.sgd.prepare_hashed",
                        spy)
    rows0, ln0 = run_port(kw)
    rows1, ln1 = run_port(kw + [("device_dedup", "1"),
                                ("stream_chunks", "1"),
                                ("producer_mode", "process")])
    assert rows0 == rows1 and torch.equal(_bits(ln0), _bits(ln1))
    assert "panel_raw" not in seen and seen
    assert ln1.stage_stats()["producer_mode"] == "thread"
    assert ln1.device_cache_info()[3]["complete"]
