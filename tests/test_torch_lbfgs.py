"""The port's L-BFGS learner (learners/lbfgs.py, learners/twoloop.py)
against the JAX package and the reference's goldens
(tests/cpp/lbfgs_learner_test.cc), on the CPU.

- ``twoloop`` equals JAX's;
- the basic, tail-filter and with-V goldens at the JAX tests' tolerances
  (1e-5, 1e-5, 2e-4), and the port against JAX per epoch on the same
  runs (objv within 1e-5 absolute for the linear runs and 2e-4 for the
  FM, the AUCs within 1e-6), also an FM with the seeded V init and a
  validation set;
- a tile cache far below the tile set gives the resident run's
  trajectory bit for bit;
- ``_warm_start`` and ``load`` from a JAX checkpoint, and the reverse;
- ``examples/lbfgs.conf`` through the CLI, and ``task=pred`` with a batch
  learner raising the JAX package's routing message.
"""

import logging
import os

import numpy as np
import pytest
import torch

from difacto_tpu.__main__ import main as jmain
from difacto_tpu.learners import Learner as JLearner
from difacto_tpu.learners import twoloop as jtl
from difacto_tpu_torch.__main__ import main
from difacto_tpu_torch.learners import twoloop as ttl
from difacto_tpu_torch.learners.base import Learner
from difacto_tpu_torch.learners.lbfgs import LBFGSLearner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(ROOT, "tests", "data", "rcv1_100.libsvm")

# tests/cpp/lbfgs_learner_test.cc
OBJV_BASIC = [
    34.603421, 12.655075, 5.224232, 2.713903, 1.290586, 0.645131, 0.317889,
    0.156723, 0.075331, 0.032091, 0.018044, 0.008562, 0.004336, 0.002132,
    0.001051, 0.000506, 0.000227, 0.000119, 0.000059,
]
OBJV_TAIL = [
    43.865008, 21.728511, 10.893458, 5.038567, 2.293318, 1.064151, 0.518891,
    0.257997, 0.128646, 0.064974, 0.028329, 0.016543, 0.007910, 0.004053,
    0.002001, 0.000978, 0.000437, 0.000216, 0.000112,
]
OBJV_WITHV = [
    35.224265, 21.631514, 18.394319, 16.077692, 12.389012, 8.888516,
    8.446880, 8.146090, 8.023501, 7.981967, 7.955119, 7.937092, 7.922456,
    7.880596, 7.861660, 7.838057, 7.807892, 7.784401, 7.756756, 7.728613,
    7.724718, 7.709527, 7.705667,
]

BASE = [("data_in", RCV1), ("m", "5"), ("V_dim", "0"), ("l2", "0"),
        ("init_alpha", "1"), ("tail_feature_filter", "0"),
        ("max_num_epochs", "19")]
WITHV = dict(V_dim="5", l2="0.1", V_l2="0.01", V_threshold="0", rho="0.5",
             max_num_epochs=str(len(OBJV_WITHV)))


def det_init(lens, weights):
    """lbfgs_learner_test.cc:128-140: V[j] = (j - V_dim/2) * .01."""
    n = 0
    for ln in lens:
        for i in range(ln):
            if i > 0:
                weights[n] = (i - (ln - 1) / 2) * 0.01
            n += 1
    return weights


def _kw(**over):
    d = dict(BASE)
    d.update({k: str(v) for k, v in over.items()})
    return list(d.items())


def _run(learner, kwargs, init=None):
    assert learner.init(kwargs) == []
    if init is not None:
        learner.set_weight_initializer(init)
    progs = []
    learner.add_epoch_end_callback(lambda e, p: progs.append(p))
    learner.run()
    return learner, progs


def run_port(init=None, **over):
    return _run(Learner.create("lbfgs", device="cpu"), _kw(**over), init)


def run_jax(init=None, **over):
    return _run(JLearner.create("lbfgs"), _kw(**over), init)


def _weights(ln):
    return np.asarray(ln.weights)[:ln.N] if not isinstance(
        ln.weights, torch.Tensor) else ln.weights[:ln.N].numpy()


# ----------------------------------------------------------------- twoloop
def test_twoloop_equals_jax():
    rng = np.random.RandomState(0)
    for n, m in ((40, 1), (40, 5), (300, 10)):
        s = [rng.randn(n) for _ in range(m)]
        y = [rng.randn(n) for _ in range(m)]
        g = rng.randn(n)
        basis = np.stack([*s, *y, g])
        B = basis @ basis.T
        np.testing.assert_array_equal(ttl.calc_delta(B), jtl.calc_delta(B))
        np.testing.assert_array_equal(ttl.calc_direction(s, y, g),
                                      jtl.calc_direction(s, y, g))
        np.testing.assert_array_equal(ttl.naive_two_loop(s, y, g),
                                      jtl.naive_two_loop(s, y, g))
        np.testing.assert_allclose(ttl.calc_direction(s, y, g),
                                   ttl.naive_two_loop(s, y, g), rtol=1e-8)
    np.testing.assert_array_equal(ttl.calc_direction([], [], g), -g)


# ----------------------------------------------------------------- learner
@pytest.mark.parametrize("case", ["basic", "tail", "withv"])
def test_goldens_and_jax_per_epoch(case):
    over, gold, tol, init = {
        "basic": ({}, OBJV_BASIC, 1e-5, None),
        "tail": ({"tail_feature_filter": "2"}, OBJV_TAIL, 1e-5, None),
        "withv": (WITHV, OBJV_WITHV, 2e-4, det_init),
    }[case]
    tl, tp = run_port(init, **over)
    jl, jp = run_jax(init, **over)
    got = np.array([p.objv for p in tp])
    assert len(got) == len(gold) == len(jp)
    assert np.abs(got - np.array(gold)).max() < tol, list(zip(got, gold))
    assert np.abs(got - np.array([p.objv for p in jp])).max() < tol
    for a, b in zip(tp, jp):
        assert abs(a.auc - b.auc) <= 1e-6 and abs(a.val_auc - b.val_auc) \
            <= 1e-6
    assert 0.5 < tp[-1].auc <= 1.0 and tp[-1].nnz_w > 0
    np.testing.assert_array_equal(tl.lens, jl.lens)
    assert (tl.N, tl.N_pad) == (jl.N, jl.N_pad)


def test_fm_with_seeded_v_init_and_validation_equals_jax():
    """The RandomState V init over the flat layout is JAX's bit for bit;
    the trajectory with a validation set agrees within the FM's 2e-4."""
    over = dict(V_dim="4", l2="0.1", V_l2="0.01", V_threshold="3",
                data_val=RCV1, max_num_epochs="6", tail_feature_filter="1")
    tl = Learner.create("lbfgs", device="cpu")
    tl.init(_kw(**over))
    jl = JLearner.create("lbfgs")
    jl.init(_kw(**over))
    for ln in (tl, jl):
        ln._prepare_data()
        ln._init_model()
    np.testing.assert_array_equal(_weights(tl), _weights(jl))
    assert (tl.lens > 1).any() and (tl.lens == 1).any()
    tl, tp = run_port(**over)
    jl, jp = run_jax(**over)
    assert len(tp) == len(jp) == 6
    for a, b in zip(tp, jp):
        assert abs(a.objv - b.objv) < 2e-4
        assert abs(a.auc - b.auc) <= 1e-6
        assert abs(a.val_auc - b.val_auc) <= 1e-6 and a.val_auc > 0.5
    assert tp[-1].objv < tp[0].objv


def test_tiny_tile_cache_gives_the_resident_trajectory(tmp_path):
    """Many small tiles (~3 KB text chunks) in a 1 MB cache at the basic
    golden (the JAX test's run: rcv1's tiles fit in it); then six copies
    of rcv1 in ~50 KB tiles, over the 1 MB budget, so every pass evicts
    and rebuilds: the same progress and weights as the run with every
    tile resident (``tile_cache_mb=0``), bit for bit."""
    _, gp = run_port(data_chunk_size="0.003", tile_cache_mb="1")
    got = np.array([p.objv for p in gp])
    assert np.abs(got - np.array(OBJV_BASIC)).max() < 1e-5
    big = tmp_path / "rcv1_x6.libsvm"
    big.write_bytes(open(RCV1, "rb").read() * 6)
    over = dict(data_in=str(big), data_chunk_size="0.05",
                max_num_epochs="5")
    al, ap = run_port(tile_cache_mb="0", **over)
    bl, bp = run_port(tile_cache_mb="1", **over)
    assert ap == bp
    np.testing.assert_array_equal(_weights(al), _weights(bl))
    assert al._tile_cache is None
    cache, n = bl._tile_cache, bl._n_tiles["train"]
    assert n > 1 and cache.nbytes <= 1 << 20 and len(cache) < n
    assert cache.misses > 2 * n          # evicted tiles were rebuilt


# -------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("v_dim", [0, 3])
def test_checkpoints_both_ways(tmp_path, v_dim):
    """JAX's checkpoint warm-starts the port as it warm-starts JAX, and the
    port's checkpoint JAX; ``load`` reads the other's file as it is."""
    over = dict(V_dim=str(v_dim), l2="0.1", V_l2="0.01", max_num_epochs="4")
    tm, jm = str(tmp_path / "port"), str(tmp_path / "jax")
    tl, _ = run_port(model_out=tm, **over)
    jl, _ = run_jax(model_out=jm, **over)
    with np.load(tm + ".npz") as t, np.load(jm + ".npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for key in ("feaids", "lens", "V_dim", "learner"):
            np.testing.assert_array_equal(t[key], j[key])
        assert t["weights"].dtype == j["weights"].dtype
        np.testing.assert_allclose(t["weights"], j["weights"], atol=2e-4)
    assert os.path.exists(tm + ".npz.manifest.json")
    tol = 1e-5 if v_dim == 0 else 2e-4
    for src in (jm, tm):
        ta, tp = run_port(model_in=src, **dict(over, max_num_epochs="2"))
        ja, jp = run_jax(model_in=src, **dict(over, max_num_epochs="2"))
        for a, b in zip(tp, jp):
            assert abs(a.objv - b.objv) < tol
        # the warm start continues below the cold run's first epoch
        assert tp[0].objv < OBJV_BASIC[0]
    for src, ref in ((jm, jl), (tm, tl)):
        t = LBFGSLearner(device="cpu")
        t.init(_kw(**over))
        t.load(src)
        j = JLearner.create("lbfgs")
        j.init(_kw(**over))
        j.load(src)
        np.testing.assert_array_equal(_weights(t), _weights(j))
        np.testing.assert_array_equal(t.reg_c.numpy(), np.asarray(j.reg_c))
        assert (t.N, t.N_pad, t.trash_w, t.trash_v) == \
            (j.N, j.N_pad, j.trash_w, j.trash_v)
        np.testing.assert_array_equal(_weights(t), _weights(ref))
    bad = LBFGSLearner(device="cpu")
    bad.init(_kw(**dict(over, V_dim=str(v_dim + 1))))
    with pytest.raises(ValueError, match="V_dim mismatch"):
        bad.load(jm)


# --------------------------------------------------------------------- CLI
def test_cli_runs_examples_lbfgs_conf_to_the_golden(caplog):
    with caplog.at_level(logging.INFO, logger="difacto_tpu_torch"):
        assert main([os.path.join(ROOT, "examples", "lbfgs.conf"),
                     "device=cpu"]) == 0
    objv = [float(r.getMessage().split("objv = ")[1].split(",")[0])
            for r in caplog.records
            if r.getMessage().startswith("epoch ")
            and "objv = " in r.getMessage()]
    assert len(objv) == 19
    assert np.abs(np.array(objv) - np.array(OBJV_BASIC)).max() < 1e-5


@pytest.mark.parametrize("learner", ["bcd", "lbfgs"])
def test_pred_with_a_batch_learner_raises_the_jax_message(tmp_path,
                                                          learner):
    """The JAX package's ``_pred_routing_error`` text, naming the learner
    that produced ``model_in`` (tests/test_serve.py:124-142), on the
    port's own checkpoint, a missing one and none."""
    m = str(tmp_path / f"{learner}_model")
    ln = Learner.create(learner, device="cpu")
    ln.init([("data_in", RCV1), ("max_num_epochs", "1"), ("model_out", m)]
            + ([("V_dim", "0")] if learner == "lbfgs" else []))
    ln.run()
    msgs = []
    for args in ([f"model_in={m}.npz"], [f"model_in={m}_missing"], []):
        argv = ["task=pred", f"learner={learner}", *args]
        with pytest.raises(ValueError) as want:
            jmain(argv)
        with pytest.raises(ValueError) as got:
            main(argv + ["device=cpu"])
        assert str(got.value) == str(want.value)
        msgs.append(str(got.value))
    assert f"was produced by learner={learner!r}" in msgs[0]
    assert "task=serve" in msgs[0] and "produced by" not in msgs[1]
