"""The port's data-parallel mesh (``mesh_dp``) against JAX's and against
its own flat run, on the CPU.

The examples' mesh, ``mesh_dp=2 mesh_fs=4``, over eight virtual CPU
devices on each side (``DIFACTO_TORCH_VIRTUAL_DEVICES=8`` by monkeypatch
for the port, tests/conftest.py's XLA flag for JAX). Criteo panels at the
JAX package's defaults (the replay cache stages the chunked layout with a
dp-divisible chunk count and replays it; the dictionary store stages in
its second pass) and rcv1's COO rows:

- per-epoch loss, AUC and the validation's within 1e-5 relative of JAX's
  2 x 4 run and of the port's flat run, the final arrays within 1e-5 of
  each one's max|ref|, cnt and v_live (and the dictionary's keys) equal;
- a second run is bit-identical (the dp partials sum in a fixed order);
- ``task=pred`` under the mesh keys writes the flat pred file byte for
  byte;
- the write-ahead log and the cold tier refuse a mesh with JAX's typed
  errors.
"""

import os
import sys

import numpy as np
import pytest
import torch

from difacto_tpu.__main__ import main as jmain
from difacto_tpu.learners.sgd import SGDLearner as JLearner
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu_torch.__main__ import main as tmain
from difacto_tpu_torch.learners.sgd import SGDLearner, SGDLearnerParam
from difacto_tpu_torch.parallel import sharded
from difacto_tpu_torch.store.convert import state_from_jax_table
from difacto_tpu_torch.updaters import sgd_updater as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCV1 = os.path.join(ROOT, "tests", "data", "rcv1_100.libsvm")
sys.path.insert(0, ROOT)
from chip_smoke import synthetic_criteo  # noqa: E402

JAX_THREADS = [("num_producers", "1"), ("producer_mode", "thread"),
               ("fused_kernel", "jnp")]
MESH = [("mesh_dp", "2"), ("mesh_fs", "4")]


@pytest.fixture(autouse=True)
def _eight_devices(monkeypatch):
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo_dp")
    (d / "train.txt").write_bytes(synthetic_criteo(400, 21))
    (d / "val.txt").write_bytes(synthetic_criteo(200, 22))
    return str(d / "train.txt"), str(d / "val.txt")


def criteo_kwargs(criteo, *extra):
    """The JAX package's defaults at a small size: 400 Criteo rows in
    batches of 50 over 2 parts, 200 validation rows, V_dim 4, 3 epochs."""
    train, val = criteo
    return [("data_in", train), ("data_val", val),
            ("data_format", "criteo"), ("V_dim", "4"),
            ("batch_size", "50"), ("num_jobs_per_epoch", "2"),
            ("max_num_epochs", "3"), ("stop_rel_objv", "0"),
            ("report_interval", "0"), ("has_aux", "1"), ("l1", "0.1"),
            ("lr", "0.05"), ("V_lr", "0.05"),
            ("V_threshold", "2")] + list(extra)


def rcv1_kwargs(*extra):
    return [("data_in", RCV1), ("V_dim", "2"), ("V_threshold", "2"),
            ("lr", "0.1"), ("l1", "0.1"), ("l2", "0"),
            ("num_jobs_per_epoch", "2"), ("batch_size", "30"),
            ("max_num_epochs", "3"), ("shuffle", "0"),
            ("report_interval", "0"), ("stop_rel_objv", "0"),
            ("has_aux", "1")] + list(extra)


def jax_init(kwargs):
    """The port store's init provider drawing JAX's init table."""
    _, rest = SGDLearnerParam.init_allow_unknown(kwargs)
    tp, _ = T.SGDUpdaterParam.init_allow_unknown(rest)
    jp, _ = J.SGDUpdaterParam.init_allow_unknown(rest)
    return lambda C: state_from_jax_table(
        tp, np.asarray(J.init_state(jp, C).VVg), "cpu")


def _rows(ln):
    rows = []
    ln.add_epoch_end_callback(lambda k, t, v: rows.append(
        (t.nrows, t.loss, t.auc, t.nnz_w, v.nrows, v.loss, v.auc)))
    return rows


LOGICAL = ("w", "z", "sqrt_g", "cnt", "v_live", "V", "Vg")


def _arrays(store) -> dict:
    """The trained table's logical columns (a sharded save's file is a
    stub: its rows are in the members) and a dictionary's keys."""
    out = dict(store._logical_np(keys=LOGICAL))
    if not store.hashed:
        out["keys"] = np.asarray(store._keys)
    return out


def run_port(kwargs, model_out):
    ln = SGDLearner(device="cpu", table_init=jax_init(kwargs))
    assert ln.init(kwargs + [("model_out", model_out)]) == []
    rows = _rows(ln)
    ln.run()
    return rows, _arrays(ln.store), ln


def run_jax(kwargs, model_out):
    ln = JLearner()
    assert ln.init(kwargs + JAX_THREADS + [("model_out", model_out)]) == []
    rows = _rows(ln)
    ln.run()
    return rows, _arrays(ln.store), ln


def assert_close(got_rows, got, want_rows, want, what):
    assert len(got_rows) == len(want_rows) == 3
    for e, (r, j) in enumerate(zip(got_rows, want_rows)):
        assert (r[0], r[4]) == (j[0], j[4])
        for name, i in (("loss", 1), ("AUC", 2), ("val loss", 5),
                        ("val AUC", 6)):
            err = abs(r[i] - j[i]) / max(abs(j[i]), 1e-30)
            assert err <= 1e-5, (what, e, name, r[i], j[i])
    assert set(got) == set(want)
    for f in ("keys", "cnt", "v_live"):
        if f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("w", "z", "sqrt_g", "V", "Vg"):
        if f in want and want[f].size:
            scale = max(float(np.abs(want[f]).max()), 1e-30)
            err = float(np.abs(got[f] - want[f]).max())
            assert err <= 1e-5 * scale, (what, f, err, scale)


def _saved(ln) -> np.ndarray:
    return sharded.host_state(ln.store.state).VVg.contiguous().view(
        torch.int32).numpy()


@pytest.mark.parametrize("store", ["hashed", "dictionary"])
def test_dp2_fs4_tracks_jax_and_flat_and_repeats(tmp_path, criteo, store):
    extra = [("hash_capacity", "4096")] if store == "hashed" \
        else [("init_capacity", "512")]
    kw = criteo_kwargs(criteo, *extra)
    rows, got, port = run_port(kw + MESH, str(tmp_path / "mesh"))
    assert port.mesh.shape == {"dp": 2, "fs": 4}
    assert port.loss.dp == 2 and not port.loss.chunks_sorted
    jrows, want, jln = run_jax(kw + MESH, str(tmp_path / "jax"))
    assert jln.mesh is not None
    assert_close(rows, got, jrows, want, f"{store} vs jax 2x4")
    if store == "hashed":
        frows, flat, _ = run_port(kw, str(tmp_path / "flat"))
        assert_close(rows, got, frows, flat, f"{store} vs flat")
    else:
        # the mesh dictionary stages in its second pass (its epoch 1
        # streams, reshuffled), the flat one in its first (its epoch 1
        # replays): the same batches only with the cache off on both
        off = [("device_cache_mb", "0")]
        mrows, mesh_off, _ = run_port(kw + MESH + off, str(tmp_path / "m0"))
        frows, flat, _ = run_port(kw + off, str(tmp_path / "flat"))
        assert_close(mrows, mesh_off, frows, flat, f"{store} vs flat")
    # the same staging and replay; the bytes differ by design: JAX charges
    # a replicated leaf once per virtual device, the port what the one
    # physical device holds
    info, jinfo = port.device_cache_info(), jln.device_cache_info()
    assert info.keys() == jinfo.keys()
    for jt in info:
        del info[jt]["staged_mb"], jinfo[jt]["staged_mb"]
    assert info == jinfo
    rows2, _, again = run_port(kw + MESH, str(tmp_path / "again"))
    assert rows2 == rows
    np.testing.assert_array_equal(_saved(again), _saved(port))


def test_dp2_fs4_coo_tracks_jax(tmp_path):
    """rcv1's ragged rows take the COO layout: the nonzeros split over
    the dp blocks."""
    kw = rcv1_kwargs(("hash_capacity", "4096"))
    rows, got, port = run_port(kw + MESH, str(tmp_path / "mesh"))
    jrows, want, _ = run_jax(kw + MESH, str(tmp_path / "jax"))
    assert_close(rows, got, jrows, want, "coo vs jax 2x4")
    rows2, _, again = run_port(kw + MESH, str(tmp_path / "again"))
    assert rows2 == rows
    np.testing.assert_array_equal(_saved(again), _saved(port))


@pytest.mark.parametrize("mesh", [["mesh_dp=2", "mesh_fs=4"],
                                  ["mesh_force=1"],
                                  ["serve_mesh_fs=4"]])
def test_pred_under_the_mesh_is_the_flat_pred(tmp_path, mesh):
    m = str(tmp_path / "m")
    assert tmain(["task=train", "device=cpu", f"data_in={RCV1}", "V_dim=2",
                  "hash_capacity=4096", "max_num_epochs=2",
                  f"model_out={m}"]) == 0
    outs = []
    for name, extra in (("flat", []), ("mesh", mesh)):
        p = str(tmp_path / name)
        assert tmain(["task=pred", "device=cpu", f"model_in={m}",
                      f"data_in={RCV1}", "V_dim=2", "hash_capacity=4096",
                      f"pred_out={p}"] + extra) == 0
        outs.append(open(p + "_part-0", "rb").read())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 100
    jp = str(tmp_path / "jax")
    assert jmain(["task=pred", f"model_in={m}", f"data_in={RCV1}",
                  "V_dim=2", "hash_capacity=4096", f"pred_out={jp}"]) == 0
    want = np.array(open(jp + "_part-0").read().split(), np.float64)
    got = np.array(outs[1].decode().split(), np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("knob", ["wal_flush_batches=4",
                                  "cold_tier_rows=1024"])
def test_wal_and_tier_refuse_a_mesh_as_jax(tmp_path, knob):
    k, v = knob.split("=")
    kw = rcv1_kwargs(("hash_capacity", "4096"), (k, v),
                     ("model_out", str(tmp_path / "m"))) + MESH
    with pytest.raises(ValueError) as got:
        SGDLearner(device="cpu").init(kw)
    with pytest.raises(ValueError) as want:
        JLearner().init(kw + JAX_THREADS)
    assert str(got.value) == str(want.value)
    assert "single-" in str(got.value)
