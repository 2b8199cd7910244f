"""The whole serving slice: a model trained by the JAX package, scored by
both packages.

JAX trains the rcv1 fixture with the knobs of tests/test_fused.py
``_learner_run`` (V_dim=2, hash_capacity=4096, l1=0.1, 2 epochs — the
golden knobs l1=1 would prune every row) and saves it. Then:

- the port's ``open_serving_store(device="cpu")`` + ``PredictExecutor``
  score it like JAX's (within 1e-6: float32 summation order);
- the port's ``task=pred`` CLI file matches JAX's line for line within
  ``%g`` rounding;
- the port's server answers equal its own pred column byte for byte;
- a checkpoint the port writes loads in JAX's ``open_serving_store`` with
  equal arrays.
"""

import contextlib
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from difacto_tpu.__main__ import main as jmain
from difacto_tpu.serve import (PredictExecutor as JExecutor,
                               open_serving_store as jopen)
from difacto_tpu_torch.__main__ import main as tmain
from difacto_tpu_torch.data.parsers import parse_libsvm
from difacto_tpu_torch.serve import (PredictExecutor as TExecutor,
                                     ServeServer,
                                     open_serving_store as topen)

_TRAIN = ["V_dim=2", "V_threshold=2", "lr=0.1", "l1=0.1", "l2=0",
          "num_jobs_per_epoch=1", "batch_size=100", "max_num_epochs=2",
          "shuffle=0", "report_interval=0", "stop_rel_objv=0",
          "hash_capacity=4096"]


@contextlib.contextmanager
def deadline(seconds: int):
    def on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded {seconds}s deadline")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module", params=[("fp32", 2), ("int8", 2),
                                        ("fp32", 0)],
                ids=["fm-fp32", "fm-int8", "flat"])
def jax_model(request, rcv1_path, tmp_path_factory):
    """A JAX-trained hashed model (FM with fp32 or int8 slots, or the flat
    V_dim=0 layout) and JAX's task=pred file over the fixture."""
    slot_dtype, vdim = request.param
    d = tmp_path_factory.mktemp(f"jax_model_{slot_dtype}_{vdim}")
    model = str(d / "model")
    args = [f"data_in={rcv1_path}"] + _TRAIN + [
        f"slot_dtype={slot_dtype}", f"V_dim={vdim}"]
    assert jmain(args + [f"model_out={model}"]) == 0
    assert jmain(args + ["task=pred", f"model_in={model}",
                         f"data_val={rcv1_path}",
                         f"pred_out={d / 'jpred'}"]) == 0
    with open(d / "jpred_part-0", "rb") as f:
        lines = f.read().splitlines()
    assert len(lines) == 100
    return {"model": model, "dir": d, "pred_lines": lines,
            "slot_dtype": slot_dtype, "V_dim": vdim}


def _fixture_block(rcv1_path):
    with open(rcv1_path, "rb") as f:
        return parse_libsvm(f.read())


def test_executor_scores_match_jax(jax_model, rcv1_path):
    jstore, jmeta, _ = jopen(jax_model["model"])
    tstore, tmeta, _ = topen(jax_model["model"], device="cpu")
    assert tmeta == jmeta
    assert tstore.param.slot_dtype == jax_model["slot_dtype"]
    blk = _fixture_block(rcv1_path)
    js, jo, ja = JExecutor(jstore).predict(blk)
    ts, to, ta = TExecutor(tstore).predict(blk)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(to), float(jo), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    # the model really exercises the weights (and embeddings)
    live = tstore._state_np(("v_live", "w"))
    assert (live["w"] != 0).any()
    assert live["v_live"].any() == (jax_model["V_dim"] > 0)


@pytest.fixture(scope="module")
def port_pred_lines(jax_model, rcv1_path):
    """The port's task=pred CLI file over the fixture (JAX's CLI keys)."""
    out = jax_model["dir"] / "tpred"
    assert tmain(["task=pred", "device=cpu", f"model_in={jax_model['model']}",
                  f"data_val={rcv1_path}", f"pred_out={out}",
                  "batch_size=100"] + _TRAIN[1:]) == 0
    with open(f"{out}_part-0", "rb") as f:
        return f.read().splitlines()


def test_pred_cli_matches_jax_pred_file(jax_model, port_pred_lines):
    assert len(port_pred_lines) == len(jax_model["pred_lines"])
    for t, j in zip(port_pred_lines, jax_model["pred_lines"]):
        tl, tp = t.split(b"\t")
        jl, jp = j.split(b"\t")
        assert tl == jl
        # %g keeps 6 significant digits; scores agree within 1e-6
        assert abs(float(tp) - float(jp)) <= 2e-6, (t, j)


def test_server_answers_equal_pred_column(jax_model, port_pred_lines,
                                          rcv1_path):
    """Serve responses are the port's pred column byte for byte, through a
    micro-batch window other than the pred window (row scores do not
    depend on their batch); #health answers ready, #reload without a
    reloader attached answers JAX's typed error."""
    with open(rcv1_path, "rb") as f:
        rows = [r for r in f.read().splitlines() if r.strip()]
    store, _, _ = topen(jax_model["model"], device="cpu")
    with deadline(120):
        srv = ServeServer(store, batch_size=64, max_delay_ms=200.0).start()
        try:
            with socket.create_connection((srv.host, srv.port)) as c:
                c.sendall(b"".join(r + b"\n" for r in rows)
                          + b"#health\n#reload\n#stats\n")
                f = c.makefile("rb")
                got = [f.readline().rstrip(b"\n") for _ in rows]
                health = f.readline()
                no_reloader = f.readline()
                stats = f.readline()
        finally:
            srv.close()
            srv.close()   # idempotent
    assert got == [l.split(b"\t")[1] for l in port_pred_lines]
    assert b'"status": "ready"' in health
    assert no_reloader == b"!err no reloader configured (set model_in)\n"
    assert b'"requests": 100' in stats


def test_serve_cli_task(jax_model, port_pred_lines, rcv1_path, tmp_path):
    """task=serve through the port's CLI: ready-file handshake, scoring
    over TCP, bounded lifetime, exit 0."""
    with open(rcv1_path, "rb") as f:
        rows = [r for r in f.read().splitlines() if r.strip()][:10]
    ready = str(tmp_path / "ready")
    rc = {}

    def run():
        rc["exit"] = tmain(["task=serve", "device=cpu",
                            f"model_in={jax_model['model']}",
                            "serve_max_seconds=6", "serve_batch_size=16",
                            f"serve_ready_file={ready}"])

    with deadline(120):
        t = threading.Thread(target=run)
        t.start()
        while not os.path.exists(ready) or not open(ready).read():
            time.sleep(0.02)
            assert t.is_alive(), "serve CLI exited before listening"
        host, port = open(ready).read().split()
        with socket.create_connection((host, int(port))) as c:
            c.sendall(b"".join(r + b"\n" for r in rows))
            f = c.makefile("rb")
            got = [f.readline().rstrip(b"\n") for _ in rows]
        t.join(timeout=60)
    assert not t.is_alive() and rc["exit"] == 0
    assert got == [l.split(b"\t")[1] for l in port_pred_lines[:10]]


def test_port_checkpoint_loads_in_jax(jax_model, tmp_path):
    tstore, _, _ = topen(jax_model["model"], device="cpu")
    path = str(tmp_path / "port_model_part-0")
    tstore.save(path)
    jstore, jmeta, _ = jopen(path)
    assert jmeta["slot_dtype"] == jax_model["slot_dtype"]
    keys = ("w", "cnt", "v_live", "V")
    jcols = jstore._state_np(jstore.state, keys=keys)
    tcols = tstore._state_np(keys)
    for k in keys:
        np.testing.assert_array_equal(tcols[k], jcols[k])
    # and the port reloads its own save to the same fused table
    again, _, _ = topen(path, device="cpu")
    np.testing.assert_array_equal(again.state.VVg.numpy().view(np.uint8),
                                  tstore.state.VVg.numpy().view(np.uint8))
