"""The port's last four fault points (``ckpt.write``, ``ckpt.read``,
``producer.part``, ``step.device``) against the JAX package's, on the
CPU: the counterparts of tests/test_chaos.py:146, 287, 514, 535 and 564.

Each leg arms the same spec in both packages (``err`` kinds at the
registry's default seed) and holds the port to JAX's fired counts,
exception types and final tables (flat V_dim=0 tables, which both
packages start from zeros; within 1e-5 of JAX's max, the learner
tolerance) and, where a fault is retried, to its own fault-free run bit
for bit.

- ``ckpt.write``: a remote save is atomic (no ``.tmp`` left), a torn one
  (``truncate``) leaves half the bytes and no manifest, so it reads as
  incomplete; SIGKILL mid-checkpoint (``kill``) in a ``task=train``
  subprocess, then ``auto_resume`` walks past the torn generation to the
  last good one and ends on the uninterrupted run's table; the batch
  learners' ``.npz`` saves tear the same way.
- ``ckpt.read``: an ``err`` on a load surfaces as the typed
  ``FaultInjected`` (an OSError, never a CheckpointCorrupt walk-back).
- ``producer.part``: a failed part is re-queued and retried, on producer
  threads and on worker processes (armed through the inherited
  ``DIFACTO_FAULTS``); a part that keeps failing escalates to the
  consumer after ``max_retries``.
- ``step.device``: ``err@1:N`` raises ``FaultInjected`` at the (N+1)-th
  dispatched step, after exactly N steps, and counts once into
  ``faults_fired_total{point,kind}``.
"""

import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest

from difacto_tpu.learners import Learner as JLearner
from difacto_tpu.obs import REGISTRY as JREG
from difacto_tpu.utils import faultinject as jfi
from difacto_tpu.utils import manifest as jmft
from difacto_tpu.utils import stream as jstream
from difacto_tpu_torch.learners.base import Learner
from difacto_tpu_torch.obs import REGISTRY as TREG
from difacto_tpu_torch.utils import faultinject as tfi
from difacto_tpu_torch.utils import manifest as tmft
from difacto_tpu_torch.utils import stream

REPO = pathlib.Path(__file__).resolve().parent.parent
RCV1 = str(REPO / "tests" / "data" / "rcv1_100.libsvm")


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    tfi.configure("")
    jfi.configure("")


def arm(spec: str) -> None:
    tfi.configure(spec)
    jfi.configure(spec)


def fired():
    """(port, JAX) fired counts per point."""
    return tfi.stats(), jfi.stats()


def train_kw(model_out, epochs=3, extra=()):
    """tests/test_chaos.py's train_args on a hashed flat table,
    streamed."""
    return [("data_in", RCV1), ("V_dim", "0"), ("lr", "1"), ("l1", "1"),
            ("l2", "1"), ("batch_size", "100"),
            ("max_num_epochs", str(epochs)), ("shuffle", "0"),
            ("num_jobs_per_epoch", "1"), ("report_interval", "0"),
            ("stop_rel_objv", "0"), ("device_cache_mb", "0"),
            ("hash_capacity", "4096"), ("producer_mode", "thread"),
            ("model_out", model_out), *extra]


def final_w(path):
    with np.load(path) as z:
        return {k: z[k] for k in ("w", "z", "sqrt_g", "cnt")
                if k in z.files}


def assert_close(got, want):
    for k, w in want.items():
        g = got[k]
        if k == "cnt":
            np.testing.assert_array_equal(g, w)
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, k


# --------------------------------------------------------------- ckpt.write

@pytest.mark.parametrize("compress", [False, True])
def test_remote_save_is_atomic_and_a_torn_one_reads_incomplete(compress):
    pytest.importorskip("fsspec")
    torn = {}
    for mod, mmft, fi, d in ((stream, tmft, tfi, "t"),
                             (jstream, jmft, jfi, "j")):
        uri = f"memory://chaos_{d}/ck.npz"
        mod.save_npz(uri, a=np.arange(7), manifest={"generation": 1},
                     compress=compress)
        names = [p.rsplit("/", 1)[-1]
                 for p in stream.listdir(f"memory://chaos_{d}")]
        assert names == ["ck.npz", "ck.npz.manifest.json"], names
        with mod.load_npz(uri) as z:
            assert z["a"].tolist() == list(range(7))
        assert mmft.verify(uri)["generation"] == 1

        fi.configure("ckpt.write:truncate@1")
        tu = f"memory://chaos_{d}/torn.npz"
        mod.save_npz(tu, a=np.arange(64), manifest={"generation": 1},
                     compress=compress, fault_point="ckpt.write")
        assert fi.stats() == {"ckpt.write": 1}
        fi.configure("")
        assert not stream.exists(tu + ".manifest.json")
        with pytest.raises(mmft.CheckpointCorrupt, match="manifest missing"):
            mmft.verify(tu, require_manifest=True)
        with stream.open_stream(tu, "rb") as f:
            torn[d] = f.read()
        stream.remove(tu)
    # the torn object is half an npz of the same size in both packages
    assert len(torn["t"]) == len(torn["j"]) > 0


def test_local_torn_save_leaves_half_the_bytes_and_no_manifest(tmp_path):
    sizes = {}
    for mod, mmft, fi, d in ((stream, tmft, tfi, "t"),
                             (jstream, jmft, jfi, "j")):
        whole = str(tmp_path / f"{d}_whole.npz")
        mod.save_npz(whole, a=np.arange(100.0), compress=False)
        fi.configure("ckpt.write:truncate@1")
        p = str(tmp_path / f"{d}_torn.npz")
        mod.save_npz(p, a=np.arange(100.0), manifest={"generation": 1},
                     compress=False, fault_point="ckpt.write")
        fi.configure("")
        assert not os.path.exists(p + ".manifest.json")
        assert not os.path.exists(p + ".tmp.npz")
        sizes[d] = (os.path.getsize(p), os.path.getsize(whole))
        with pytest.raises(mmft.CheckpointCorrupt):
            mmft.verify(p, require_manifest=True)
    assert sizes["t"] == sizes["j"]
    assert sizes["t"][0] == sizes["t"][1] // 2


def _cli(pkg, model, extra_env=None, device=()):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    env.pop("DIFACTO_FAULTS", None)
    env.update(extra_env or {})
    args = [sys.executable, "-m", pkg] + [
        f"{k}={v}" for k, v in train_kw(
            model, extra=(("ckpt_interval", "1"), ("auto_resume", "1")))
    ] + list(device)
    return subprocess.run(args, cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=240)


def test_sigkill_mid_checkpoint_then_auto_resume(tmp_path):
    """Epoch 0's checkpoint lands; epoch 1's is torn, then the process is
    SIGKILLed. The next run walks past the torn generation, resumes from
    epoch 0 and ends on the uninterrupted run's table; JAX does the same
    and ends within the learner tolerance."""
    runs = {}
    for pkg, dev in (("difacto_tpu_torch", ("device=cpu",)),
                     ("difacto_tpu", ())):
        model = str(tmp_path / pkg / "model")
        p1 = _cli(pkg, model, {"DIFACTO_FAULTS": "ckpt.write:kill@1:1"},
                  dev)
        assert p1.returncode == -signal.SIGKILL, (pkg, p1.stderr[-2000:])
        torn = f"{model}_iter-1_part-0"
        assert os.path.exists(torn)
        assert not os.path.exists(torn + ".manifest.json")
        assert os.path.exists(f"{model}_iter-0_part-0.manifest.json")
        size = os.path.getsize(torn)
        p2 = _cli(pkg, model, device=dev)
        assert p2.returncode == 0, (pkg, p2.stderr[-2000:])
        assert "auto-resumed from epoch 0" in p2.stderr, pkg
        assert "walking back" in p2.stderr, pkg
        runs[pkg] = (size, final_w(f"{model}_part-0"))
    assert runs["difacto_tpu_torch"][0] == runs["difacto_tpu"][0]
    got = runs["difacto_tpu_torch"][1]
    assert_close(got, runs["difacto_tpu"][1])
    # the resumed run ends where the uninterrupted one does, bit for bit
    whole = str(tmp_path / "whole" / "model")
    ln = Learner.create("sgd", device="cpu")
    ln.init(train_kw(whole))
    ln.run()
    want = final_w(f"{whole}_part-0")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("learner", ["bcd", "lbfgs"])
def test_batch_learner_checkpoint_tears_like_jax(tmp_path, learner):
    kw = [("data_in", RCV1), ("tail_feature_filter", "0"),
          ("max_num_epochs", "2")] + (
        [("V_dim", "0"), ("l2", "0"), ("m", "5")] if learner == "lbfgs"
        else [("l1", ".1"), ("lr", ".8")])
    arm("ckpt.write:truncate@1")
    for ln, d in ((Learner.create(learner, device="cpu"), "t"),
                  (JLearner.create(learner), "j")):
        m = str(tmp_path / d / "model")
        assert ln.init(kw + [("model_out", m)]) == []
        ln.run()
        assert os.path.exists(m + ".npz")
        assert not os.path.exists(m + ".npz.manifest.json")
        with pytest.raises(Exception):
            np.load(m + ".npz")["w" if learner == "bcd" else "weights"]
    t, j = fired()
    assert t == j == {"ckpt.write": 1}


# ---------------------------------------------------------------- ckpt.read

@pytest.fixture(scope="module")
def ckpt_model(tmp_path_factory):
    model = str(tmp_path_factory.mktemp("chaos_model") / "model")
    ln = Learner.create("sgd", device="cpu")
    ln.init(train_kw(model, extra=(("ckpt_interval", "1"),)))
    ln.run()
    for e in range(3):
        assert os.path.exists(f"{model}_iter-{e}_part-0.manifest.json")
    return model


def test_ckpt_read_fault_is_typed(ckpt_model):
    from difacto_tpu.serve import open_serving_store as jopen
    from difacto_tpu_torch.serve import open_serving_store as topen
    arm("ckpt.read:err@1")
    errs = []
    for op, fi in ((lambda: topen(ckpt_model, device="cpu"), tfi),
                   (lambda: jopen(ckpt_model), jfi)):
        with pytest.raises(fi.FaultInjected) as ei:
            op()
        assert isinstance(ei.value, OSError)
        errs.append(type(ei.value).__mro__[1:])
    t, j = fired()
    assert t == j and t["ckpt.read"] >= 1
    assert errs[0][0] is OSError and errs[1][0] is OSError
    # an auto_resume load raises it too, not a walk-back
    ln = Learner.create("sgd", device="cpu")
    ln.init(train_kw(ckpt_model, extra=(("auto_resume", "1"),)))
    with pytest.raises(tfi.FaultInjected):
        ln.run()
    arm("")
    from difacto_tpu_torch.store.convert import state_to_numpy
    store, meta, _ = topen(ckpt_model, device="cpu")
    w = state_to_numpy(store.param, store.state, ("w",))["w"]
    np.testing.assert_array_equal(w, final_w(meta["path"])["w"])
    assert (w != 0).any()


# ------------------------------------------------------------ producer.part

def producer_kw(model_out, extra=()):
    """tests/test_chaos.py:535's run: one producer, 4 parts of 25 rows."""
    return [("data_in", RCV1), ("V_dim", "0"), ("lr", "1"), ("l1", "0"),
            ("l2", "1"), ("batch_size", "25"), ("max_num_epochs", "1"),
            ("shuffle", "0"), ("num_jobs_per_epoch", "4"),
            ("num_producers", "1"), ("report_interval", "0"),
            ("device_cache_mb", "0"), ("hash_capacity", "4096"),
            ("model_out", model_out), *extra]


def _run(ln, kw):
    assert ln.init(kw) == []
    ln.run()
    return ln


def test_producer_part_fault_is_retried_like_jax(tmp_path):
    _run(Learner.create("sgd", device="cpu"), producer_kw(
        str(tmp_path / "base"), (("producer_mode", "thread"),)))
    base = final_w(str(tmp_path / "base_part-0"))
    arm("producer.part:err@1:3")
    ln = _run(Learner.create("sgd", device="cpu"), producer_kw(
        str(tmp_path / "t"), (("producer_mode", "thread"),)))
    _run(JLearner.create("sgd"), producer_kw(
        str(tmp_path / "j"), (("producer_mode", "thread"),)))
    t, j = fired()
    assert t == j == {"producer.part": 1}
    assert ln.obs.value("producer_part_retries_total") == 1
    got = final_w(str(tmp_path / "t_part-0"))
    for k in base:
        np.testing.assert_array_equal(got[k], base[k])
    assert_close(got, final_w(str(tmp_path / "j_part-0")))


def test_producer_part_fault_in_worker_processes(tmp_path, monkeypatch):
    """The worker processes inherit DIFACTO_FAULTS: one worker, its 4th
    part attempt fails and the consumer re-queues it; the table equals
    the fault-free thread run bit for bit."""
    _run(Learner.create("sgd", device="cpu"), producer_kw(
        str(tmp_path / "base"), (("producer_mode", "thread"),)))
    monkeypatch.setenv("DIFACTO_FAULTS", "producer.part:err@1:3")
    ln = _run(Learner.create("sgd", device="cpu"), producer_kw(
        str(tmp_path / "p"), (("producer_mode", "process"),)))
    assert tfi.stats() == {}      # the consumer itself never traverses it
    assert ln.obs.value("producer_part_retries_total") == 1
    assert ln.obs.value("faults_fired_total", point="producer.part",
                        kind="err") == 1
    a, b = final_w(str(tmp_path / "p_part-0")), \
        final_w(str(tmp_path / "base_part-0"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_a_part_that_keeps_failing_escalates_like_jax(tmp_path):
    arm("producer.part:err@1")
    errs = []
    for ln, d in ((Learner.create("sgd", device="cpu"), "t"),
                  (JLearner.create("sgd"), "j")):
        with pytest.raises(Exception) as ei:
            _run(ln, producer_kw(str(tmp_path / d),
                                 (("producer_mode", "thread"),)))
        errs.append(ei.value)
    t, j = fired()
    # every part fails twice (max_retries=1), then escalates
    assert t == j == {"producer.part": 8}
    assert type(errs[0]).__name__ == type(errs[1]).__name__
    assert "injected fault at producer.part" in str(errs[0])


# -------------------------------------------------------------- step.device

def test_step_device_fault_fires_typed_after_n_steps(tmp_path):
    kw = [("data_in", RCV1), ("V_dim", "0"), ("l2", "1"), ("l1", "0"),
          ("lr", "1"), ("num_jobs_per_epoch", "1"), ("batch_size", "25"),
          ("max_num_epochs", "1"), ("shuffle", "0"),
          ("report_interval", "0"), ("device_cache_mb", "0"),
          ("hash_capacity", "1024"), ("producer_mode", "thread")]
    tb = TREG.value("faults_fired_total", point="step.device", kind="err")
    jb = JREG.value("faults_fired_total", point="step.device", kind="err")
    arm("step.device:err@1:2")
    steps = []
    ln = Learner.create("sgd", device="cpu")
    ln.init(list(kw))
    inner = ln._train_step
    ln._train_step = lambda *a: (steps.append(1), inner(*a))[1]
    errs = []
    with pytest.raises(tfi.FaultInjected) as ei:
        ln.run()
    errs.append(ei.value)
    jl = JLearner.create("sgd")
    jl.init(list(kw))
    with pytest.raises(jfi.FaultInjected) as ei:
        jl.run()
    errs.append(ei.value)
    assert len(steps) == 2          # the third dispatch raised first
    assert all(isinstance(e, OSError) for e in errs)
    assert str(errs[0]) == str(errs[1]) == "injected fault at step.device"
    t, j = fired()
    assert t == j == {"step.device": 1}
    assert TREG.value("faults_fired_total", point="step.device",
                      kind="err") - tb == 1
    assert JREG.value("faults_fired_total", point="step.device",
                      kind="err") - jb == 1
