"""The port's BCD learner (learners/bcd.py, losses/logit_delta.py) against
the JAX package and the reference's goldens (tests/cpp/bcd_learner_test.cc),
on the CPU.

- ``partition_feature`` and ``fea_group_stats`` equal JAX's exactly;
- ``delta_pred_update`` equals the jitted JAX function bit for bit, and
  ``delta_grad`` agrees within 1e-6 of max|g| (``exp`` differs by ulps),
  on random slices padded at the tail as the learner pads them;
- the learner against JAX per epoch (objv, auc, acc within 1e-5
  relative, nnz(w) equal, final w within 1e-5 of max|w|) on the
  diag-Newton run and the convergence runs at block_ratio 0.4, 1 and 10,
  each also at the JAX tests' golden tolerances;
- a bounded slice cache gives the unbounded run's trajectory bit for bit;
- .npz checkpoints both ways, and ``examples/bcd.conf`` through the CLI.
"""

import os

import jax
import numpy as np
import pytest
import torch

from difacto_tpu.data import Reader as JReader
from difacto_tpu.learners import Learner as JLearner
from difacto_tpu.learners import bcd as jbcd
from difacto_tpu.losses import logit_delta as jld
from difacto_tpu_torch.__main__ import main
from difacto_tpu_torch.data.reader import Reader
from difacto_tpu_torch.learners import bcd as tbcd
from difacto_tpu_torch.learners.base import Learner
from difacto_tpu_torch.losses import logit_delta as tld

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(ROOT, "tests", "data", "rcv1_100.libsvm")

# tests/cpp/bcd_learner_test.cc:9-38
OBJV_DIAG_NEWTON = [
    34.877064, 33.885559, 29.572740, 27.458964, 25.317689, 23.917098,
    22.855843, 22.099876, 21.552682, 21.137216,
]
OPTIMUM_OBJV, OPTIMUM_NNZ = 15.884923, 47   # bcd_learner_test.cc:40-66

DIAG_NEWTON = [("data_in", RCV1), ("l1", ".1"), ("lr", ".05"),
               ("block_ratio", "0.001"), ("tail_feature_filter", "0"),
               ("max_num_epochs", "10")]


def _kw(**over):
    d = dict(DIAG_NEWTON)
    d.update({k: str(v) for k, v in over.items()})
    return list(d.items())


def _run(learner, kwargs):
    assert learner.init(kwargs) == []
    progs = []
    learner.add_epoch_end_callback(lambda e, p: progs.append(p))
    learner.run()
    return learner, progs


def run_port(**over):
    return _run(Learner.create("bcd", device="cpu"), _kw(**over))


def run_jax(**over):
    return _run(JLearner.create("bcd"), _kw(**over))


def _assert_matches_jax(tp, jp, tl, jl):
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert a.count == b.count
        for f in ("objv", "auc", "acc"):
            assert abs(getattr(a, f) - getattr(b, f)) \
                <= 1e-5 * abs(getattr(b, f)), (f, a, b)
        assert a.nnz_w == b.nnz_w, (a, b)
    np.testing.assert_array_equal(tl.feaids, jl.feaids)
    assert tl.blocks == jl.blocks
    scale = np.abs(jl.w).max()
    assert np.abs(tl.w - jl.w).max() <= 1e-5 * scale


# --------------------------------------------------------- partition/stats
@pytest.mark.parametrize("nbits,feagrps", [
    (0, [(0, 1)]), (0, [(0, 4)]), (0, [(0, 39)]),
    (4, [(0, 2), (3, 5), (15, 1)]), (8, [(g, 1 + g % 3)
                                         for g in range(0, 256, 17)])])
def test_partition_feature_equals_jax(nbits, feagrps):
    assert tbcd.partition_feature(nbits, feagrps) == \
        jbcd.partition_feature(nbits, feagrps)


def test_partition_feature_rejects_bad_bits():
    with pytest.raises(ValueError):
        tbcd.partition_feature(3, [(0, 1)])


@pytest.mark.parametrize("nbits,chunk", [(0, 1 << 20), (4, 5000),
                                         (8, 2000)])
def test_fea_group_stats_equals_jax(nbits, chunk):
    got = tbcd.fea_group_stats(Reader(RCV1, chunk_bytes=chunk), nbits)
    want = jbcd.fea_group_stats(JReader(RCV1, chunk_bytes=chunk), nbits)
    np.testing.assert_array_equal(got, want)
    assert got[(1 << nbits) + 1] == 100


# ------------------------------------------------------------- logit_delta
def _random_slice(seed, b_cap=200, nf=37, nnz=900):
    """A slice as the learner builds it: ascending rows over the real
    entries, then (row 0, col 0, val 0) pads to bucket(nnz)."""
    rng = np.random.RandomState(seed)
    cap = 1024
    idx = np.zeros((3, cap), dtype=np.float64)
    idx[0, :nnz] = np.sort(rng.randint(0, 150, nnz))
    idx[1, :nnz] = rng.randint(0, nf, nnz)
    idx[2, :nnz] = rng.randn(nnz) * (1 + 3 * (seed % 2))
    rows, cols = idx[0].astype(np.int32), idx[1].astype(np.int32)
    vals = idx[2].astype(np.float32)
    pred = (rng.randn(b_cap) * 2).astype(np.float32)
    labels = (rng.rand(b_cap) < 0.3).astype(np.float32)
    mask = np.zeros(b_cap, np.float32)
    mask[:150] = 1.0
    d = rng.randn(48).astype(np.float32)
    return rows, cols, vals, pred, labels, mask, d


@pytest.mark.parametrize("seed", range(6))
def test_logit_delta_matches_jax(seed):
    rows, cols, vals, pred, labels, mask, d = _random_slice(seed)
    jblk = jld.BlockSlice(rows=rows, cols=cols, vals=vals)
    tblk = tld.BlockSlice(*map(torch.from_numpy, (rows, cols, vals)))
    # the learner's jitted functions
    jg, jh = jax.jit(jld.delta_grad, static_argnums=4)(
        pred, labels, mask, jblk, 48)
    gh = tld.delta_grad(*map(torch.from_numpy, (pred, labels, mask)), tblk,
                        48).numpy()
    for got, want in ((gh[:, 0], jg), (gh[:, 1], jh)):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    jp = jax.jit(jld.delta_pred_update)(pred, jblk, d)
    tp = tld.delta_pred_update(torch.from_numpy(pred), tblk,
                               torch.from_numpy(d))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


# ----------------------------------------------------------------- learner
def test_diag_newton_golden_and_jax_per_epoch():
    """bcd_learner_test.cc:9-38 (one block, relative 1e-5) and JAX."""
    tl, tp = run_port()
    jl, jp = run_jax()
    got = np.array([p.objv for p in tp])
    assert len(got) == 10
    rel = np.abs(got - np.array(OBJV_DIAG_NEWTON)) / got
    assert rel.max() < 1e-5, list(zip(got, OBJV_DIAG_NEWTON))
    _assert_matches_jax(tp, jp, tl, jl)


@pytest.mark.parametrize("block_ratio", [0.4, 1, 10])
def test_convergence_golden_and_jax_per_epoch(block_ratio):
    """bcd_learner_test.cc:40-66: the same optimum (objv 15.884923, the
    sum over the 100 rows, 47 nonzeros) for any block partition; and JAX
    per epoch."""
    over = dict(lr=".8", block_ratio=str(block_ratio), max_num_epochs="50")
    tl, tp = run_port(**over)
    jl, jp = run_jax(**over)
    assert abs(tp[-1].objv - OPTIMUM_OBJV) / tp[-1].objv < 1e-3
    assert tp[-1].nnz_w == OPTIMUM_NNZ
    _assert_matches_jax(tp, jp, tl, jl)


def test_bounded_slice_cache_gives_the_same_trajectory():
    """A 1-item, 1 MB slice cache (every fetch of another slice evicts)
    rebuilds on demand and gives the unbounded run's progress and w bit
    for bit, at the golden optimum."""
    over = dict(lr=".8", block_ratio="1", max_num_epochs="50")
    al, ap = run_port(**over)
    bl, bp = run_port(tile_cache_items="1", tile_cache_mb="1", **over)
    assert ap == bp
    np.testing.assert_array_equal(al.w, bl.w)
    assert abs(bp[-1].objv - OPTIMUM_OBJV) / bp[-1].objv < 1e-3
    assert len(bl._tile_cache) == 1
    # every epoch rebuilds every slice; unbounded, each is built once
    assert bl._tile_cache.misses >= 50 * len(bl.blocks) * len(bl.tiles)
    assert al._tile_cache.misses == len(al.tiles) * len(al.blocks)


def test_repeat_runs_are_bit_identical():
    al, ap = run_port(lr=".8", block_ratio="10", max_num_epochs="3")
    bl, bp = run_port(lr=".8", block_ratio="10", max_num_epochs="3")
    assert ap == bp
    np.testing.assert_array_equal(al.w, bl.w)


# -------------------------------------------------------------- checkpoints
def test_checkpoints_both_ways(tmp_path):
    """The port's .npz loads into JAX and JAX's into the port (the same
    keys and marker); a warm start from either checkpoint continues the
    same way on both sides."""
    tm, jm = str(tmp_path / "port_bcd"), str(tmp_path / "jax_bcd")
    tl, _ = run_port(max_num_epochs="5", model_out=tm)
    jl, _ = run_jax(max_num_epochs="5", model_out=jm)
    with np.load(tm + ".npz") as t, np.load(jm + ".npz") as j:
        assert sorted(t.files) == sorted(j.files)
        assert str(t["learner"]) == str(j["learner"]) == "bcd"
        np.testing.assert_array_equal(t["feaids"], j["feaids"])
        assert t["w"].dtype == j["w"].dtype
        assert np.abs(t["w"] - j["w"]).max() <= 1e-5 * np.abs(j["w"]).max()
    assert os.path.exists(tm + ".npz.manifest.json")
    for src in (tm, jm):
        _, tp = run_port(max_num_epochs="2", model_in=src)
        _, jp = run_jax(max_num_epochs="2", model_in=src)
        assert tp[0].objv < OBJV_DIAG_NEWTON[0]
        for a, b in zip(tp, jp):
            assert abs(a.objv - b.objv) <= 1e-5 * b.objv
            assert a.nnz_w == b.nnz_w
    # the port's load rebuilds pred = X w: one more epoch from the saved
    # model continues the 5-epoch run (the JAX golden at epoch 6)
    _, tp = run_port(max_num_epochs="1", model_in=tm)
    assert abs(tp[0].objv - OBJV_DIAG_NEWTON[5]) / tp[0].objv < 1e-2


def test_cli_runs_examples_bcd_conf_to_the_optimum(tmp_path, caplog):
    import logging
    m = str(tmp_path / "m")
    with caplog.at_level(logging.INFO, logger="difacto_tpu_torch"):
        assert main([os.path.join(ROOT, "examples", "bcd.conf"),
                     "device=cpu", f"model_out={m}"]) == 0
    last = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("epoch: 49,")]
    assert len(last) == 1
    fields = dict(kv.split(": ") for kv in last[0].split(", "))
    objv = float(fields["objv"]) * int(fields["rows"])
    assert abs(objv - OPTIMUM_OBJV) / objv < 1e-3
    assert int(fields["nnz(w)"]) == OPTIMUM_NNZ
    with np.load(m + ".npz") as z:
        assert int((z["w"] != 0).sum()) == OPTIMUM_NNZ


def test_mesh_key_is_ignored_and_linear_only(monkeypatch):
    """``mesh_dp=4`` now trains row-sharded over four virtual CPU devices
    (the diag-Newton golden within 1e-5, tests/test_torch_batch_sharded.py
    holds it against JAX's mesh run), and BCD stays linear only. The
    name is from when the key was logged as ignored; the test keeps it."""
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "4")
    tl, tp = run_port(mesh_dp="4")
    assert tl.mesh is not None and tl.mesh.shape == {"dp": 4, "fs": 1}
    got = np.array([p.objv for p in tp])
    rel = np.abs(got - np.array(OBJV_DIAG_NEWTON)) / got
    assert rel.max() < 1e-5, list(zip(got, OBJV_DIAG_NEWTON))
    with pytest.raises(ValueError, match="V_dim=0"):
        tbcd.BCDLearner(device="cpu").init(_kw(V_dim="2"))
