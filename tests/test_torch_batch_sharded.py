"""The batch learners on the port's mesh (the counterparts of
tests/test_bcd_sharded.py and tests/test_lbfgs_sharded.py), on the CPU.

BCD's ``mesh_dp`` cuts every tile's rows into dp shards and sums each
block's (g, h) partials in dp order; L-BFGS's ``mesh_fs`` cuts the flat
[w, V...] vector into fs key ranges and sums every reduction over it
(the Gram matrix, the line search's dots, the regularizer) per shard in
fs order. Sharding changes the order of the sums, not the math: the
reference's goldens are reproduced at their own tolerances, the JAX
package's sharded runs are tracked within 1e-5, and the multi-block BCD
optimum and an L-BFGS checkpoint round trip are the flat run's. The port
runs over ``DIFACTO_TORCH_VIRTUAL_DEVICES=8`` logical CPU devices.
"""

import os

import jax
import numpy as np
import pytest

from difacto_tpu.learners import Learner as JLearner
from difacto_tpu_torch.learners.base import Learner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(ROOT, "tests", "data", "rcv1_100.libsvm")

# tests/cpp/bcd_learner_test.cc:9-38 and lbfgs_learner_test.cc
OBJV_DIAG_NEWTON = [
    34.877064, 33.885559, 29.572740, 27.458964, 25.317689, 23.917098,
    22.855843, 22.099876, 21.552682, 21.137216,
]
OBJV_BASIC = [
    34.603421, 12.655075, 5.224232, 2.713903, 1.290586, 0.645131, 0.317889,
    0.156723, 0.075331, 0.032091, 0.018044, 0.008562, 0.004336, 0.002132,
    0.001051, 0.000506, 0.000227, 0.000119, 0.000059,
]
OBJV_WITHV = [
    35.224265, 21.631514, 18.394319, 16.077692, 12.389012, 8.888516,
    8.446880, 8.146090, 8.023501, 7.981967, 7.955119, 7.937092, 7.922456,
    7.880596, 7.861660, 7.838057, 7.807892, 7.784401, 7.756756, 7.728613,
    7.724718, 7.709527, 7.705667,
]
JAX_SHARD_MAP = hasattr(jax, "shard_map")


@pytest.fixture(autouse=True)
def _eight_devices(monkeypatch):
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")


def _run(learner, kwargs, init=None):
    assert learner.init(list(kwargs.items())) == []
    if init is not None:
        learner.set_weight_initializer(init)
    seen = []
    learner.add_epoch_end_callback(lambda e, p: seen.append(p.objv))
    learner.run()
    return learner, np.array(seen)


def _det_init(lens, weights):
    """lbfgs_learner_test.cc:128-140: V[j] = (j - V_dim/2) * .01."""
    n = 0
    for ln in lens:
        for i in range(ln):
            if i > 0:
                weights[n] = (i - (ln - 1) / 2) * 0.01
            n += 1
    return weights


# ------------------------------------------------------------------ BCD
def bcd_args(**over):
    args = {"data_in": RCV1, "l1": ".1", "lr": ".05",
            "block_ratio": "0.001", "tail_feature_filter": "0",
            "max_num_epochs": "10"}
    args.update({k: str(v) for k, v in over.items()})
    return args


@pytest.mark.parametrize("dp", [4, 8])
def test_bcd_sharded_golden(dp):
    ln, seen = _run(Learner.create("bcd", device="cpu"),
                    bcd_args(mesh_dp=dp))
    assert ln.mesh.shape == {"dp": dp, "fs": 1}
    # every tile's slices are cut into dp row shards
    full, shards = ln._tile_cache.fetch(0, 0)
    assert len(shards) == dp
    assert sum(int((s.vals != 0).sum()) for s in shards) \
        == int((full.vals != 0).sum())
    rel = np.abs(seen - np.array(OBJV_DIAG_NEWTON)) / seen
    assert rel.max() < 1e-5, list(zip(seen, OBJV_DIAG_NEWTON))
    # the JAX package's dp-sharded run where this jax has shard_map,
    # else its single-device run
    jargs = bcd_args(mesh_dp=dp if JAX_SHARD_MAP else 1)
    _, jseen = _run(JLearner.create("bcd"), jargs)
    np.testing.assert_allclose(seen, jseen, rtol=1e-5)


def test_bcd_sharded_multi_block_optimum():
    """block_ratio=1 (several blocks) reaches the flat run's optimum."""
    over = dict(block_ratio="1", max_num_epochs="60", random_block="0",
                lr=".8")
    ln, seen = _run(Learner.create("bcd", device="cpu"),
                    bcd_args(mesh_dp=4, **over))
    ref, ref_seen = _run(Learner.create("bcd", device="cpu"),
                         bcd_args(**over))
    assert len(ln.blocks) > 1
    np.testing.assert_allclose(seen[-1], ref_seen[-1], rtol=1e-5)
    np.testing.assert_allclose(ln.w, ref.w, rtol=1e-3, atol=1e-5)
    assert int((ln.w != 0).sum()) == int((ref.w != 0).sum())


# --------------------------------------------------------------- L-BFGS
def lbfgs_args(**over):
    args = {"data_in": RCV1, "m": "5", "V_dim": "0", "l2": "0",
            "init_alpha": "1", "tail_feature_filter": "0",
            "max_num_epochs": "19"}
    args.update({k: str(v) for k, v in over.items()})
    return args


def _assert_sharded(ln, fs):
    assert ln.mesh.shape == {"dp": 1, "fs": fs}
    assert ln.N_pad % fs == 0
    parts = ln._shards(ln.weights)
    assert len(parts) == fs
    assert all(p.shape[0] == ln.N_pad // fs for p in parts)


@pytest.mark.parametrize("fs", [4, 8])
def test_lbfgs_sharded_basic_golden(fs):
    ln, seen = _run(Learner.create("lbfgs", device="cpu"),
                    lbfgs_args(mesh_fs=fs))
    _assert_sharded(ln, fs)
    err = np.abs(seen - np.array(OBJV_BASIC))
    assert err.max() < 1e-5, list(zip(seen, OBJV_BASIC))
    _, jseen = _run(JLearner.create("lbfgs"), lbfgs_args(mesh_fs=fs))
    np.testing.assert_allclose(seen, jseen, rtol=1e-5, atol=1e-9)


def test_lbfgs_sharded_fm_golden():
    """The FM (V_dim=5) trajectory with the deterministic initializer,
    sharded over fs=4 (lbfgs_learner_test.cc:88-146)."""
    args = lbfgs_args(V_dim=5, l2=0.1, V_l2=0.01, V_threshold=0, rho=0.5,
                      max_num_epochs=len(OBJV_WITHV), mesh_fs=4)
    ln, seen = _run(Learner.create("lbfgs", device="cpu"), args,
                    init=_det_init)
    _assert_sharded(ln, 4)
    err = np.abs(seen - np.array(OBJV_WITHV))
    assert err.max() < 2e-4, list(zip(seen, OBJV_WITHV))
    _, flat = _run(Learner.create("lbfgs", device="cpu"),
                   dict(args, mesh_fs="1"), init=_det_init)
    assert np.abs(seen - flat).max() < 2e-4


def test_lbfgs_sharded_ckpt_roundtrip(tmp_path):
    """A sharded run's checkpoint warm-starts another sharded learner
    with the same weights, and the flat learner too."""
    m = str(tmp_path / "m")
    ln, _ = _run(Learner.create("lbfgs", device="cpu"),
                 lbfgs_args(mesh_fs=4, max_num_epochs=3, model_out=m))
    w0 = ln.weights[:ln.N].numpy()
    for fs in ("4", "1"):
        other = Learner.create("lbfgs", device="cpu")
        assert other.init(list(lbfgs_args(mesh_fs=fs).items())) == []
        other._prepare_data()
        other._init_model()
        assert other._warm_start(m) == len(other.feaids)
        np.testing.assert_array_equal(other.weights[:other.N].numpy(), w0)
    with np.load(m + ".npz") as z:
        assert len(z["weights"]) == ln.N
