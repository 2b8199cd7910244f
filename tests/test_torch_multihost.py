"""Multi-host SGD training of the port under torch.distributed, on the
CPU (gloo): the counterparts of tests/test_multihost_spmd.py and
tests/test_bounded_delay.py.

Two processes are started through the repo's ``launch.py`` (unedited),
each running this file as its worker (``python
tests/test_torch_multihost.py <mode> <out_dir> <json>``) with
``DIFACTO_TORCH_VIRTUAL_DEVICES=4``, so the global (dp=2, fs=4) mesh puts
dp across the processes and fs inside each, as the JAX package's 2 x 4
virtual-CPU workers do. The config is tests/spmd_worker.py's (V_dim 2 on
rcv1) at ``hash_capacity=16384``, so the JAX init table the port is
given (``jax_table.npy``: JAX's V init is a jax PRNG draw torch cannot
reproduce) stays small.

- the ranks' per-epoch train and validation losses and their final
  tables are bit-equal, both ``_part-0`` and ``_part-1`` are written, and
  the losses are within 2e-4 of JAX's single-host run
  (test_two_process_mesh_matches_single_host's tolerance);
- against JAX's own 2-process run (tests/spmd_worker.py through
  launch.py) within 1e-5 per epoch, the learner parity tolerance, and
  each package's rank checkpoints load in the other;
- launch.py ``--bounded-delay 2`` leaves the τ=0 run's losses and tables
  bit for bit; one process with τ in {1, 4} equals its τ=0 run byte for
  byte (test_windowed_schedule_tau0_byte_identical);
- the dictionary store across 2 processes: identical id -> slot maps on
  both ranks, slot exchange after the first pass, within 2e-4 of JAX's
  single-host dictionary run;
- the data plane's ordered cross-process block sum equals the
  one-process ``dp_reduce`` bit for bit.

Every launch has its own deadline (the subprocess ``timeout``) and free
ports from ``bind(0)``.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")
EPOCHS = 4
LAUNCH_TIMEOUT_S = 240

two_procs = pytest.mark.skipif(
    (os.cpu_count() or 1) < 2,
    reason="two gloo processes need >= 2 CPU cores")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def base_conf(**over) -> dict:
    """tests/spmd_worker.py's config at hash_capacity 16384."""
    conf = {"data_in": RCV1, "V_dim": "2", "V_threshold": "2",
            "lr": "0.1", "l1": "0.1", "l2": "0",
            "batch_size": "100", "max_num_epochs": str(EPOCHS),
            "shuffle": "0", "report_interval": "0",
            "stop_rel_objv": "0", "stop_val_auc": "-2",
            "num_jobs_per_epoch": "1", "hash_capacity": "16384",
            "mesh_dp": "2", "mesh_fs": "4"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def launch(out_dir, mode: str, conf: dict, launch_extra=(), n=2,
           devices=4, timeout=LAUNCH_TIMEOUT_S):
    """Run this file's worker under launch.py -n ``n``; the completed
    process (asserted to exit 0)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["DIFACTO_TORCH_VIRTUAL_DEVICES"] = str(devices)
    proc = subprocess.run(
        [sys.executable, str(REPO / "launch.py"), "-n", str(n),
         "--port", str(free_port()), *launch_extra, "--",
         sys.executable, __file__, mode, str(out_dir), json.dumps(conf)],
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\n" \
                                 f"stderr:\n{proc.stderr}"
    return proc


def trajs(out_dir, n=2) -> list:
    out = []
    for r in range(n):
        with open(pathlib.Path(out_dir) / f"traj-{r}.json") as f:
            out.append(json.load(f))
    return out


def jax_table(path, conf: dict) -> str:
    """JAX's init table for ``conf``'s geometry, as .npy at ``path``."""
    from difacto_tpu.updaters import sgd_updater as J
    jp, _ = J.SGDUpdaterParam.init_allow_unknown(list(conf.items()))
    np.save(path, np.asarray(J.init_state(jp, jp.hash_capacity).VVg))
    return str(path)


def jax_single_host(conf: dict):
    """JAX's single-host (no mesh) run of ``conf``: (train, val) losses."""
    from difacto_tpu.learners import Learner
    conf = {k: v for k, v in conf.items()
            if k not in ("mesh_dp", "mesh_fs", "model_out")}
    ln = Learner.create("sgd")
    ln.init(list(conf.items()))
    seen, seen_val = [], []
    ln.add_epoch_end_callback(
        lambda e, t, v: (seen.append(t.loss), seen_val.append(v.loss)))
    ln.run()
    return seen, seen_val


def val300(tmp_path) -> str:
    """300 rows: the validation Reader's chunk exceeds b_cap, so the
    schedule cuts it into batch_size windows."""
    path = tmp_path / "val300.libsvm"
    path.write_text(pathlib.Path(RCV1).read_text() * 3)
    return str(path)


@pytest.fixture(scope="module")
def sync_run(tmp_path_factory):
    """The τ=0 2-process run on JAX's init table, with validation."""
    d = tmp_path_factory.mktemp("mh_sync")
    conf = base_conf(data_val=val300(d), model_out=str(d / "model"),
                     has_aux=1)
    conf["init_npy"] = jax_table(d / "jax_table.npy", conf)
    launch(d, "sgd", conf)
    return d, conf


@two_procs
def test_two_process_mesh_matches_single_host(sync_run):
    d, conf = sync_run
    t = trajs(d)
    assert len(t[0]["train"]) == EPOCHS
    assert t[0]["train"] == t[1]["train"]
    assert t[0]["val"] == t[1]["val"] and min(t[0]["val"]) > 0
    assert t[0]["steps"] == t[1]["steps"] > 0
    a, b = np.load(d / "table-0.npy"), np.load(d / "table-1.npy")
    assert a.tobytes() == b.tobytes()
    assert (d / "model_part-0").exists() and (d / "model_part-1").exists()
    ref, ref_val = jax_single_host(
        {k: v for k, v in conf.items() if k != "init_npy"})
    np.testing.assert_allclose(t[0]["train"], ref, rtol=2e-4)
    np.testing.assert_allclose(t[0]["val"], ref_val, rtol=2e-4)


@two_procs
def test_two_process_run_tracks_jax_two_process_run(sync_run, tmp_path):
    """JAX's own 2-process run (tests/spmd_worker.py, unedited) within
    1e-5 per epoch; each package loads the other's rank checkpoints."""
    d, conf = sync_run
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)    # the worker sets its own 4 devices
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, str(REPO / "launch.py"), "-n", "2", "--port",
         str(free_port()), "--", sys.executable,
         str(REPO / "tests" / "spmd_worker.py"), str(tmp_path), RCV1,
         str(EPOCHS), conf["data_val"], "hash_capacity=16384",
         "has_aux=1"],
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr
    jt = trajs(tmp_path)
    t = trajs(d)
    np.testing.assert_allclose(t[0]["train"], jt[0]["train"], rtol=1e-5)
    np.testing.assert_allclose(t[0]["val"], jt[0]["val"], rtol=1e-5)

    from difacto_tpu.store.local import SlotStore as JStore
    from difacto_tpu.updaters import sgd_updater as J
    from difacto_tpu_torch.store.local import SlotStore
    from difacto_tpu_torch.updaters import sgd_updater as T
    kw = [("V_dim", "2"), ("V_threshold", "2"), ("hash_capacity", "16384")]
    cols = ("w", "z", "sqrt_g", "cnt", "V", "Vg")
    for rank in (0, 1):
        # the port's part in JAX, JAX's part in the port
        js = JStore(J.SGDUpdaterParam.init_allow_unknown(kw)[0])
        js.load(str(d / f"model_part-{rank}"))
        ts = SlotStore(T.SGDUpdaterParam.init_allow_unknown(kw)[0],
                       device="cpu")
        ts.load(str(d / f"model_part-{rank}"), weights_only=False)
        mine = ts._logical_np(cols)
        got = js._logical_np(keys=cols)
        for c in cols:
            np.testing.assert_array_equal(np.asarray(got[c]), mine[c])
        ts2 = SlotStore(T.SGDUpdaterParam.init_allow_unknown(kw)[0],
                        device="cpu")
        ts2.load(str(tmp_path / f"model_part-{rank}"), weights_only=False)
        theirs = ts2._logical_np(cols)
        np.testing.assert_allclose(theirs["w"], mine["w"], rtol=0,
                                   atol=1e-4)


@two_procs
def test_bounded_delay_leaves_the_trajectory_bit_for_bit(sync_run,
                                                         tmp_path):
    """launch.py --bounded-delay 2 (the cluster-wide τ) against the τ=0
    run: the same losses and tables bit for bit, on both ranks."""
    d, conf = sync_run
    conf = dict(conf, model_out=str(tmp_path / "model"))
    launch(tmp_path, "sgd", conf, launch_extra=["--bounded-delay", "2"])
    t, s = trajs(tmp_path), trajs(d)
    for r in (0, 1):
        assert t[r]["train"] == s[r]["train"]
        assert t[r]["val"] == s[r]["val"]
        assert t[r]["tau"] == 2 and s[r]["tau"] == 0
        assert np.load(tmp_path / f"table-{r}.npy").tobytes() == \
            np.load(d / f"table-{r}.npy").tobytes()


def test_one_process_window_is_byte_identical(monkeypatch):
    """τ > 0 on one process takes the windowed schedule (its clock posts
    return at once) and must give the τ=0 run's table byte for byte."""
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.parallel import sharded

    def run(tau):
        ln = SGDLearner(device="cpu")
        ln.init(list(base_conf(max_num_epochs=3, nnz_cap=16384,
                               bounded_delay=tau).items()))
        seen = []
        ln.add_epoch_end_callback(lambda e, t, v: seen.append(t.loss))
        ln.run()
        assert ln._spmd_schedule == (tau > 0)
        return seen, sharded.host_state(
            ln.store.state).VVg.numpy().tobytes()

    ref = run(0)
    for tau in (1, 4):
        assert run(tau) == ref


@two_procs
def test_two_process_dictionary_matches_single_host(tmp_path):
    """The exact-id store across 2 processes: the first pass ships raw
    ids and both ranks insert the same unions, so their id -> slot maps
    are identical; later passes ship slots. V_dim=0 makes the trajectory
    slot-numbering-invariant, so it must match JAX's single-host
    dictionary run."""
    conf = base_conf(hash_capacity=0, V_dim=0, init_capacity=1024)
    launch(tmp_path, "sgd", conf)
    t = trajs(tmp_path)
    assert t[0]["train"] == t[1]["train"]
    assert t[0]["num_features"] == t[1]["num_features"] == 2775
    assert t[0]["capacity"] == t[1]["capacity"] == 4096
    for name in ("keys", "slots"):
        a = np.load(tmp_path / "dict-0.npz")[name]
        assert np.array_equal(a, np.load(tmp_path / "dict-1.npz")[name])
    ref, _ = jax_single_host(conf)
    np.testing.assert_allclose(t[0]["train"], ref, rtol=2e-4)


@two_procs
def test_ordered_block_sum_equals_one_process_dp_reduce(tmp_path):
    """Two processes, each one dp block of the same data, sum through the
    data plane; one process sums both blocks with dp_reduce: the same
    bits."""
    import torch

    from difacto_tpu_torch.losses.fm import dp_reduce
    from difacto_tpu_torch.ops.segment import lane_sum
    data, lanes = _block_data()
    want = dp_reduce(lane_sum, data, lanes, 64, dp=2)
    launch(tmp_path, "blocksum", {})
    for r in (0, 1):
        got = torch.from_numpy(np.load(tmp_path / f"blocksum-{r}.npy"))
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_bounded_delay_report_legs(monkeypatch):
    """The JAX report's shape on the port's fs-sharded step: a leg per
    (hosts, τ), the retention per τ, and real windowed trainings whose
    AUC does not move with τ."""
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "4")
    from difacto_tpu_torch.parallel.capacity import bounded_delay_report
    rep = bounded_delay_report(hosts_values=(1, 2), taus=(0, 1), fs=2,
                               base_capacity=256, V_dim=4, batch=64,
                               nnz_per_row=4, steps=4, device="cpu")
    assert rep["metric"] == "bounded_delay_pipelining"
    assert [(g["hosts"], g["tau"]) for g in rep["legs"]] == [
        (1, 0), (1, 1), (2, 0), (2, 1)]
    assert set(rep["retention_by_tau"]) == {"0", "1"}
    assert [a["auc_delta"] for a in rep["auc"]] == [0.0, 0.0]
    assert rep["auc"][0]["auc"] > 0.5


def _block_data():
    import torch
    rng = np.random.RandomState(3)
    data = torch.from_numpy(rng.randn(512, 5).astype(np.float32))
    lanes = torch.from_numpy(np.sort(rng.randint(0, 64, 512)).astype(
        np.int32))
    return data, lanes


# ------------------------------------------------------------ the workers
def _sgd_worker(out_dir: pathlib.Path, conf: dict) -> None:
    from difacto_tpu_torch.learners.sgd import SGDLearner, SGDLearnerParam
    from difacto_tpu_torch.parallel import sharded
    from difacto_tpu_torch.parallel.multihost import process_index
    init = None
    if "init_npy" in conf:
        from difacto_tpu_torch.store.convert import state_from_jax_table
        from difacto_tpu_torch.updaters.sgd_updater import SGDUpdaterParam
        table = np.load(conf.pop("init_npy"))
        _, rest = SGDLearnerParam.init_allow_unknown(list(conf.items()))
        tp, _ = SGDUpdaterParam.init_allow_unknown(rest)
        init = lambda C: state_from_jax_table(tp, table, "cpu")  # noqa
    ln = SGDLearner(device="cpu", table_init=init)
    ln.init(list(conf.items()))
    seen, seen_val, steps = [], [], []
    ln.add_epoch_end_callback(
        lambda e, t, v: (seen.append(t.loss), seen_val.append(v.loss)))
    ln.run()
    rank = process_index()
    np.save(out_dir / f"table-{rank}.npy",
            sharded.host_state(ln.store.state).VVg.numpy())
    if not ln.store.hashed:
        np.savez(out_dir / f"dict-{rank}.npz", keys=ln.store._keys,
                 slots=ln.store._slots)
    steps = ln.loss.plane.calls if ln.loss.plane is not None else 0
    with open(out_dir / f"traj-{rank}.json", "w") as f:
        json.dump({"train": seen, "val": seen_val, "steps": steps,
                   "tau": ln._tau, "num_features": ln.store.num_features,
                   "capacity": int(ln.store.state.capacity)}, f)


def _blocksum_worker(out_dir: pathlib.Path) -> None:
    from difacto_tpu_torch.losses.fm import dp_reduce
    from difacto_tpu_torch.ops.segment import lane_sum
    from difacto_tpu_torch.parallel.multihost import (DataPlane,
                                                      process_index)
    data, lanes = _block_data()
    r = process_index()
    mine = slice(r * 256, (r + 1) * 256)
    got = dp_reduce(lane_sum, data[mine], lanes[mine], 64, dp=1,
                    plane=DataPlane())
    np.save(out_dir / f"blocksum-{r}.npy", got.numpy())


if __name__ == "__main__":
    from difacto_tpu_torch.parallel.multihost import initialize
    initialize()
    mode, out = sys.argv[1], pathlib.Path(sys.argv[2])
    if mode == "sgd":
        _sgd_worker(out, json.loads(sys.argv[3]))
    elif mode == "blocksum":
        _blocksum_worker(out)
    else:
        raise SystemExit(f"unknown worker mode {mode!r}")
