"""Multi-host faults of the port, on the CPU: the counterparts of
tests/test_fault.py and of the ``dcn.collective`` / ``push.stale`` arms
of tests/test_chaos.py.

- the heartbeat mesh (parallel/fault.py): a silent peer is declared dead,
  ``check``/``guarded`` raise ``HostFailure``, ``guarded`` passes a value
  through and disarms, ``from_env`` gates on the environment;
- the last two fault points against the JAX package's: an ``err`` at
  the control exchange raises typed before the one-process return and
  counts into ``faults_fired_total``; a τ > 0 one-process run traverses
  both points as often as JAX's does and raises typed at the same
  traversal;
- kill one host mid-epoch through ``launch.py --max-restarts 1`` (rank 1
  SIGKILLs itself at its 4th control exchange, in epoch 1): the launcher
  evicts it, and the relaunched single process resumes from the epoch-0
  checkpoint and finishes; a frozen rank (SIGSTOP) instead lets the
  survivor's watchdog exit 101 (``exit_code_for([1])``), which the
  launcher acts on.

The workers are this file (``python tests/test_torch_multihost_fault.py
<out_dir> <mode>``) under launch.py, each launch with its own deadline
and free ports from ``bind(0)``.
"""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")
EPOCHS = 4

two_procs = pytest.mark.skipif(
    (os.cpu_count() or 1) < 2,
    reason="two gloo processes need >= 2 CPU cores")


def free_ports(n: int) -> int:
    """A base port whose ``n`` successors were free just now."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n >= 65535:
            continue
        try:
            socks = []
            for i in range(n):
                u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                socks.append(u)
                u.bind(("", base + i))
            return base
        except OSError:
            continue
        finally:
            for u in socks:
                u.close()
    raise RuntimeError("no run of free ports")


# ------------------------------------------------------------ heartbeats
def test_heartbeat_detects_dead_peer():
    """... and counts into the JAX package's metric names."""
    from difacto_tpu_torch.obs import REGISTRY
    from difacto_tpu_torch.parallel.fault import (HeartbeatMonitor,
                                                  HostFailure)
    beats = REGISTRY.value("hb_beats_sent_total")
    dead = REGISTRY.value("hb_peer_dead_total")
    port = free_ports(2)
    a = HeartbeatMonitor(0, 2, port, interval=0.1, timeout=0.8)
    b = HeartbeatMonitor(1, 2, port, interval=0.1, timeout=0.8)
    a.start(), b.start()
    try:
        time.sleep(0.5)
        assert a.dead_peers() == []
        a.check()
        b.stop()   # host 1 dies
        time.sleep(1.2)
        assert a.dead_peers() == [1]
        with pytest.raises(HostFailure):
            a.check()
        with pytest.raises(HostFailure):
            a.guarded(lambda: None)
        assert REGISTRY.value("hb_peer_dead_total") == dead + 2
        assert REGISTRY.value("hb_beats_sent_total") > beats
    finally:
        a.stop()
        b.stop()


def test_heartbeat_guarded_passthrough():
    from difacto_tpu_torch.parallel.fault import HeartbeatMonitor
    port = free_ports(2)
    a = HeartbeatMonitor(0, 2, port, interval=0.1, timeout=5.0)
    b = HeartbeatMonitor(1, 2, port, interval=0.1, timeout=5.0)
    a.start(), b.start()
    try:
        time.sleep(0.4)
        assert a.guarded(lambda x: x + 1, 41) == 42
        assert a._in_collective_since is None
    finally:
        a.stop()
        b.stop()


def test_from_env_gating_and_exit_codes(monkeypatch):
    from difacto_tpu.parallel import fault as jfault
    from difacto_tpu_torch.parallel import fault
    monkeypatch.delenv("DIFACTO_HB_PORT", raising=False)
    assert fault.from_env(0, 2) is None
    monkeypatch.setenv("DIFACTO_HB_PORT", str(free_ports(2)))
    assert fault.from_env(0, 1) is None
    mon = fault.from_env(0, 2)
    try:
        assert mon is not None and mon.timeout == 5.0
    finally:
        mon.stop()
    assert fault.EXIT_PEER_DEAD == jfault.EXIT_PEER_DEAD == 42
    for dead in ([1], [0, 3], [30], []):
        assert fault.exit_code_for(dead) == jfault.exit_code_for(dead)
    monkeypatch.setenv("DIFACTO_RESTART", "3")
    assert fault.restart_attempt() == jfault.restart_attempt() == 3


# ------------------------------------------------------------ fault points
@pytest.fixture
def armed():
    from difacto_tpu.utils import faultinject as jfi
    from difacto_tpu_torch.utils import faultinject as tfi

    def arm(spec):
        tfi.configure(spec)
        jfi.configure(spec)
        return tfi, jfi
    yield arm
    tfi.configure("")
    jfi.configure("")


def test_dcn_collective_fault_fires_typed(armed):
    from difacto_tpu_torch.obs import REGISTRY
    from difacto_tpu_torch.parallel.multihost import control_allgather_np
    from difacto_tpu_torch.utils.faultinject import FaultInjected
    armed("")
    before = REGISTRY.value("dcn_collectives_total")
    out = control_allgather_np(np.arange(4, dtype=np.int32))
    assert out.shape == (1, 4)
    assert REGISTRY.value("dcn_collectives_total") == before + 1
    fired = REGISTRY.value("faults_fired_total", point="dcn.collective",
                           kind="err")
    tfi, _ = armed("dcn.collective:err@1")
    with pytest.raises(FaultInjected):
        control_allgather_np(np.arange(4, dtype=np.int32))
    assert tfi.stats()["dcn.collective"] == 1
    assert REGISTRY.value("faults_fired_total", point="dcn.collective",
                          kind="err") == fired + 1


def _window_kw(tau, epochs=2):
    return [("data_in", RCV1), ("V_dim", "0"), ("l2", "1"), ("l1", "0"),
            ("lr", "1"), ("num_jobs_per_epoch", "1"),
            ("batch_size", "30"), ("max_num_epochs", str(epochs)),
            ("shuffle", "0"), ("report_interval", "0"),
            ("stop_rel_objv", "0"), ("device_cache_mb", "0"),
            ("hash_capacity", "1024"), ("nnz_cap", "16384"),
            ("mesh_dp", "2"), ("mesh_fs", "4"),
            ("bounded_delay", str(tau))]


@pytest.mark.parametrize("spec", [
    "dcn.collective:delay_ms=0@1,push.stale:delay_ms=0@1",
    "push.stale:err@1:5", "dcn.collective:err@1:6"])
def test_window_fault_points_fire_like_jax(armed, spec, monkeypatch):
    """A one-process τ=1 mesh run in both packages under the same arm:
    the same traversals of both points, and an ``err`` raises the typed
    FaultInjected at the same one."""
    monkeypatch.setenv("DIFACTO_TORCH_VIRTUAL_DEVICES", "8")
    from difacto_tpu.learners import Learner as JLearner
    from difacto_tpu.utils.faultinject import FaultInjected as JFault
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.utils.faultinject import FaultInjected
    got = []
    for make, exc in ((lambda: SGDLearner(device="cpu"), FaultInjected),
                      (lambda: JLearner.create("sgd"), JFault)):
        tfi, jfi = armed(spec)
        ln = make()
        ln.init(_window_kw(1))
        if "err" in spec:
            with pytest.raises(exc):
                ln.run()
        else:
            ln.run()
        got.append(tfi.stats() if exc is FaultInjected else jfi.stats())
    assert got[0] == got[1]
    for arm in spec.split(","):
        assert got[0].get(arm.split(":")[0], 0) > 0
    # the window's metrics, under the JAX package's names
    from difacto_tpu_torch.obs import REGISTRY
    snap = REGISTRY.snapshot()
    assert "train_staleness_batches" in snap["gauges"]
    assert "exchange_wait_seconds_total" in snap["counters"]
    assert "dcn_collectives_total" in snap["counters"]
    assert REGISTRY.histogram("push_delay_batches").data()["count"] > 0


# -------------------------------------------------------- kill one host
def _launch(tmp_path, mode, hb_timeout="2", timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["DIFACTO_TORCH_VIRTUAL_DEVICES"] = "4"
    return subprocess.run(
        [sys.executable, str(REPO / "launch.py"), "-n", "2",
         "--port", str(free_ports(8)), "--max-restarts", "1",
         "--hb-port", str(free_ports(66)), "--hb-timeout", hb_timeout,
         "--", sys.executable, __file__, str(tmp_path), mode],
        cwd=str(REPO), env=env, capture_output=True, text=True,
        timeout=timeout)


@two_procs
@pytest.mark.parametrize("mode", ["kill", "freeze"])
def test_one_host_dies_mid_epoch_and_the_run_recovers(tmp_path, mode):
    """``kill``: rank 1 SIGKILLs itself at its 4th control exchange
    (epoch 1, after its training batch); launch.py sees the signal death
    and evicts it. ``freeze``: rank 1 stops (SIGSTOP) there instead; the
    survivor, blocked on the frozen peer's key, is freed by its heartbeat
    watchdog with exit code 101, which launch.py evicts rank 1 for. Either
    way one process relaunches, resumes from the epoch-0 checkpoint and
    finishes."""
    proc = _launch(tmp_path, mode)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\n" \
                                 f"stderr:\n{proc.stderr}"
    with open(tmp_path / "traj-0.json") as f:
        traj = json.load(f)
    assert traj["attempt"] == 1 and traj["nprocs"] == 1
    assert [e for e, _ in traj["epochs"]] == list(range(1, EPOCHS))
    losses = [v for _, v in traj["epochs"]]
    assert losses[-1] < losses[0]
    want = "rc=101" if mode == "freeze" else "rc=-9"
    assert f"attempt 0 failed ({want})" in proc.stderr, proc.stderr
    assert (tmp_path / "model_part-0").exists()


def _fault_worker(out_dir: pathlib.Path, mode: str) -> int:
    from difacto_tpu_torch.learners import sgd
    from difacto_tpu_torch.parallel.fault import HostFailure, exit_code_for
    from difacto_tpu_torch.parallel.multihost import (process_count,
                                                      process_index)
    attempt = os.environ.get("DIFACTO_RESTART", "0")
    rank, nprocs = process_index(), process_count()
    if rank == 1 and attempt == "0":
        orig, calls = sgd.control_allgather_np, [0]

        def dying(arr):
            calls[0] += 1
            if calls[0] == 4:
                print(f"rank {rank}: simulating host death ({mode})",
                      flush=True)
                os.kill(os.getpid(), signal.SIGKILL if mode == "kill"
                        else signal.SIGSTOP)
            return orig(arr)

        sgd.control_allgather_np = dying
    ln = sgd.SGDLearner(device="cpu")
    ln.init([("data_in", RCV1), ("V_dim", "2"), ("V_threshold", "2"),
             ("lr", "0.1"), ("l1", "0.1"), ("l2", "0"),
             ("batch_size", "100"), ("max_num_epochs", str(EPOCHS)),
             ("shuffle", "0"), ("report_interval", "0"),
             ("stop_rel_objv", "0"), ("stop_val_auc", "-2"),
             ("num_jobs_per_epoch", "1"), ("hash_capacity", "16384"),
             ("mesh_dp", str(nprocs)), ("mesh_fs", "4"),
             ("ckpt_interval", "1"), ("auto_resume", "1"),
             ("device_cache_mb", "0"),
             ("model_out", str(out_dir / "model"))])
    seen = []
    ln.add_epoch_end_callback(lambda e, t, v: seen.append((e, t.loss)))
    try:
        ln.run()
    except HostFailure as e:
        from difacto_tpu_torch.parallel.multihost import abandon
        print(f"rank {rank}: {e}", flush=True)
        abandon()
        return exit_code_for(e.dead)
    with open(out_dir / f"traj-{rank}.json", "w") as f:
        json.dump({"epochs": seen, "attempt": int(attempt),
                   "nprocs": nprocs}, f)
    return 0


if __name__ == "__main__":
    from difacto_tpu_torch.parallel.multihost import initialize
    initialize()
    sys.exit(_fault_worker(pathlib.Path(sys.argv[1]), sys.argv[2]))
