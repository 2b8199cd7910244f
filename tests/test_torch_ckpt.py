"""Interval checkpoints, ``ckpt_keep`` pruning and ``auto_resume`` of the
port against the JAX package's, on the CPU.

- A port ``_iter-k`` checkpoint with optimizer state loads into JAX's
  store (manifest required, every array equal), and the reverse; each
  package's ``verify`` accepts the other's files and both stamp the
  epoch and the family's generation.
- ``ckpt_keep`` leaves the newest k generations, the same files JAX
  leaves; ``prune_checkpoints`` removes what JAX's removes.
- A corrupt, torn or truncated newest generation is skipped and resume
  walks back to the newest one that verifies, in both packages alike.
- On the streamed path (``device_cache_mb=0``) a resumed run equals the
  uninterrupted run bit for bit; at the default replay cache the port's
  resumed run agrees with JAX's resumed run within the learner
  tolerance (1e-5 per epoch, final arrays 1e-5 of max|jax|), and with
  the process producers too.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from difacto_tpu.store.local import SlotStore as JStore
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu.utils import manifest as jmft
from difacto_tpu_torch.store.convert import state_to_numpy
from difacto_tpu_torch.store.local import SlotStore
from difacto_tpu_torch.updaters import sgd_updater as T
from difacto_tpu_torch.utils import manifest as tmft
from test_torch_stream import (_bits, assert_close_to_jax, run_jax,
                               run_port, stream_kwargs)


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    from chip_smoke import synthetic_criteo
    d = tmp_path_factory.mktemp("criteo_ckpt")
    (d / "train.txt").write_bytes(synthetic_criteo(300, 31))
    (d / "val.txt").write_bytes(synthetic_criteo(100, 32))
    return str(d / "train.txt"), str(d / "val.txt")


def _trained(criteo, tmp_path, who, *extra):
    """A model_out family from a 2-epoch run with interval checkpoints."""
    out = str(tmp_path / who / "m")
    kw = stream_kwargs(criteo, ("max_num_epochs", "2"),
                       ("ckpt_interval", "1"), *extra)
    (run_port if who == "port" else run_jax)(kw, out)
    return out


_FIELDS = ("w", "z", "sqrt_g", "cnt", "v_live", "V", "Vg")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_interval_checkpoints_load_both_ways(tmp_path, criteo, writer):
    out = _trained(criteo, tmp_path, writer)
    path = out + "_iter-1_part-0"
    for mod in (tmft, jmft):
        man = mod.verify(path, require_manifest=True)
        assert man["epoch"] == 1 and man["save_aux"]
    gens = [json.load(open(out + f"_iter-{e}_part-0.manifest.json"))[
        "generation"] for e in (0, 1)]
    assert gens[1] > gens[0]
    assert json.load(open(out + ".meta")) == {"last_epoch": 1}
    tparam = T.SGDUpdaterParam(V_dim=4, hash_capacity=4096)
    jparam = J.SGDUpdaterParam(V_dim=4, hash_capacity=4096)
    port = SlotStore(tparam, device="cpu")
    port.load(path, weights_only=False, require_manifest=True)
    ref = JStore(jparam)
    ref.load(path, weights_only=False, require_manifest=True)
    got = state_to_numpy(tparam, port.state, _FIELDS)
    want = ref._logical_np(keys=_FIELDS)
    with np.load(path) as z:
        for f in _FIELDS:
            np.testing.assert_array_equal(got[f], z[f])
            np.testing.assert_array_equal(np.asarray(want[f]), z[f])


def test_require_manifest_refuses_a_torn_checkpoint(tmp_path, criteo):
    out = _trained(criteo, tmp_path, "port")
    path = out + "_iter-1_part-0"
    os.remove(tmp_path / "port" / "m_iter-1_part-0.manifest.json")
    store = SlotStore(T.SGDUpdaterParam(V_dim=4, hash_capacity=4096),
                      device="cpu")
    with pytest.raises(tmft.CheckpointCorrupt, match="manifest missing"):
        store.load(path, require_manifest=True)
    with pytest.raises(tmft.CheckpointCorrupt, match="manifest missing"):
        tmft.verify(path, require_manifest=True)
    assert tmft.verify(path) is None     # a legacy file, accepted


def test_ckpt_keep_leaves_the_files_jax_leaves(tmp_path, criteo):
    names = {}
    for who in ("port", "jax"):
        out = str(tmp_path / who / "m")
        kw = stream_kwargs(criteo, ("ckpt_interval", "1"),
                           ("ckpt_keep", "2"))
        (run_port if who == "port" else run_jax)(kw, out)
        names[who] = sorted(os.listdir(tmp_path / who))
    assert names["port"] == names["jax"]
    assert "m_iter-2_part-0" in names["port"]
    assert "m_iter-1_part-0.manifest.json" in names["port"]
    assert not any("_iter-0" in n for n in names["port"])


@pytest.mark.parametrize("keep", [1, 2, 3, 6])
def test_prune_checkpoints_removes_what_jax_removes(tmp_path, keep):
    for who in ("port", "jax"):
        d = tmp_path / who
        d.mkdir()
        for e in range(5):
            for r in range(2):
                for suffix in ("", ".manifest.json"):
                    (d / f"m_iter-{e}_part-{r}{suffix}").write_text("x")
        (d / "m_part-0").write_text("final")
    got = tmft.prune_checkpoints(str(tmp_path / "port" / "m"), keep)
    want = jmft.prune_checkpoints(str(tmp_path / "jax" / "m"), keep)
    assert [os.path.basename(p) for p in sorted(got)] == \
        [os.path.basename(p) for p in sorted(want)]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    left = {int(n.split("_iter-")[1][0]) for n in
            os.listdir(tmp_path / "port") if "_iter-" in n}
    assert left == set(range(max(0, 5 - keep), 5))
    assert "m_part-0" in os.listdir(tmp_path / "port")
    assert tmft.prune_checkpoints(str(tmp_path / "port" / "m"), 0) == []


def _corrupt(path: str, how: str) -> None:
    if how == "bitflip":
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
    elif how == "torn":
        os.remove(path + ".manifest.json")
    else:                                  # truncated
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 3)


@pytest.fixture(scope="module")
def uninterrupted(criteo):
    """The port's streamed 3-epoch run from scratch."""
    rows, ln = run_port(stream_kwargs(criteo))
    return rows, _bits(ln)


@pytest.mark.parametrize("how", ["bitflip", "torn", "truncated"])
def test_resume_walks_back_past_a_corrupt_generation(tmp_path, criteo,
                                                     uninterrupted, how):
    """Two epochs of checkpoints, the newest damaged: the resume walks
    back to epoch 0's, runs epochs 1 and 2, and on the streamed path ends
    where the uninterrupted run does, bit for bit."""
    out = _trained(criteo, tmp_path, "port")
    _corrupt(out + "_iter-1_part-0", how)
    rows, ln = run_port(stream_kwargs(criteo, ("auto_resume", "1")), out)
    full_rows, full_bits = uninterrupted
    assert rows == full_rows[1:]
    assert torch.equal(_bits(ln), full_bits)


def test_walk_back_matches_jax(tmp_path, criteo):
    runs = {}
    for who, run in (("port", run_port), ("jax", run_jax)):
        out = _trained(criteo, tmp_path, who)
        _corrupt(out + "_iter-1_part-0", "bitflip")
        runs[who] = run(stream_kwargs(criteo, ("auto_resume", "1")), out)
    (prow, _), (jrow, _) = runs["port"], runs["jax"]
    assert len(prow) == len(jrow) == 2     # epochs 1 and 2
    got = dict(np.load(str(tmp_path / "port" / "m_part-0")))
    want = dict(np.load(str(tmp_path / "jax" / "m_part-0")))
    assert_close_to_jax(prow, jrow, got, want, "walk back")


def test_streamed_resume_equals_the_uninterrupted_run(tmp_path, criteo,
                                                     uninterrupted):
    full_rows, full_bits = uninterrupted
    out = str(tmp_path / "m")
    kw = stream_kwargs(criteo, ("ckpt_interval", "1"), ("ckpt_keep", "2"),
                       ("num_producers", "2"))
    run_port([(k, v) for k, v in kw if k != "max_num_epochs"]
             + [("max_num_epochs", "1")], out)
    rows, resumed = run_port(kw + [("auto_resume", "1")], out)
    assert rows == full_rows[1:]
    assert torch.equal(_bits(resumed), full_bits)


@pytest.mark.parametrize("extra", [
    (), (("device_cache_mb", "0"), ("num_producers", "2"),
         ("producer_mode", "process"), ("device_dedup", "1"))])
def test_resumed_run_matches_jax_resumed_run(tmp_path, criteo, extra):
    """Stopped after epoch 0 and resumed: at the default device_cache_mb
    the first resumed epoch streams where an uninterrupted run would
    replay, so the port is held to JAX's resumed run."""
    kw = [(k, v) for k, v in stream_kwargs(criteo) if k not in
          ("device_cache_mb", "max_num_epochs")] + list(extra)
    kw = [("device_cache_mb", "2048")] + kw if not extra else kw
    runs = {}
    for who, run in (("port", run_port), ("jax", run_jax)):
        out = str(tmp_path / who / "m")
        run(kw + [("ckpt_interval", "1"), ("max_num_epochs", "1")], out)
        runs[who] = run(kw + [("ckpt_interval", "1"),
                              ("max_num_epochs", "3"),
                              ("auto_resume", "1")], out)
    (prow, _), (jrow, _) = runs["port"], runs["jax"]
    assert len(prow) == 2
    got = dict(np.load(str(tmp_path / "port" / "m_part-0")))
    want = dict(np.load(str(tmp_path / "jax" / "m_part-0")))
    assert_close_to_jax(prow, jrow, got, want, "resumed")


def test_resume_with_nothing_to_resume_starts_fresh(tmp_path, criteo):
    out = str(tmp_path / "m")
    kw = stream_kwargs(criteo, ("max_num_epochs", "1"),
                       ("auto_resume", "1"))
    rows, _ = run_port(kw, out)
    assert len(rows) == 1
    # a marker naming a generation that never landed: start fresh too
    shutil.rmtree(tmp_path)
    os.makedirs(tmp_path)
    with open(out + ".meta", "w") as f:
        f.write(json.dumps({"last_epoch": 7}))
    rows, _ = run_port(kw, out)
    assert len(rows) == 1
