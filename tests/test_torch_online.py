"""The port's online loop against the JAX package's, on the CPU.

- ``OnlineLog``: the same appends and labels leave the same sealed
  segment files (byte for byte) and the same ``log.idx.jsonl`` rows in
  both packages, under both horizon defaults (every unlabeled row is
  resolved by ``end()``, so no clock is raced);
- ``TailReader``'s four exits (replay gap, ``log.end``, stop, deadline),
  and the last seal landing together with the end marker;
- ``OnlineTrainer`` over one sealed log, started from JAX's init table
  (``store/convert.state_from_jax_table``), ends within the learner
  tolerances of tests/test_torch_train.py of the JAX trainer's table;
- ``task=online`` through the port's CLI on the CPU, committing every
  segment, and its ``online_replay=1`` over the same log leave final
  checkpoints equal array for array, byte for byte;
- ``push_reload`` against a live port server (a dead endpoint and a
  pruned generation are typed failures, never raised);
- the loop in one process: ``#score``/``#label`` into the server's log,
  the trainer tailing it and pushing generations, the served generation
  advancing, the freshness gauges on ``#metrics``, and the answers after
  the last reload equal to ``task=pred`` of the final checkpoint;
- the ``online.log.append``, ``online.label_join`` and ``online.seal``
  fault points.
"""

import contextlib
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from difacto_tpu.__main__ import main as jmain
from difacto_tpu.data.parsers import get_parser as jparser
from difacto_tpu.online import OnlineLog as JLog
from difacto_tpu.updaters import sgd_updater as J
from difacto_tpu_torch.__main__ import main as tmain
from difacto_tpu_torch.data.parsers import get_parser as tparser
from difacto_tpu_torch.learners import base as learner_base
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.obs import REGISTRY
from difacto_tpu_torch.online import (OnlineLog, OnlineParam,
                                      OnlineTrainer, TailReader,
                                      push_reload)
from difacto_tpu_torch.online.log import (list_segments, read_index,
                                          seg_path)
from difacto_tpu_torch.serve import (ModelReloader, ServeClient,
                                     ServeServer, open_serving_store)
from difacto_tpu_torch.store.convert import state_from_jax_table
from difacto_tpu_torch.updaters import sgd_updater as T
from difacto_tpu_torch.utils import faultinject

# the learner knobs of tests/test_torch_train.py, one batch per segment
_LEARN = [("V_dim", "4"), ("hash_capacity", "4096"), ("has_aux", "1"),
          ("batch_size", "100"), ("report_interval", "0"), ("l1", "0.1"),
          ("lr", "0.05"), ("V_lr", "0.05"), ("V_threshold", "2")]


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


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faultinject.configure("")


@pytest.fixture(scope="module")
def rows(rcv1_path):
    with open(rcv1_path, "rb") as f:
        return [r for r in f.read().splitlines() if r.strip()]


def _row(row: bytes):
    return tparser("libsvm")(row)


def _read_back(path):
    from difacto_tpu_torch.data.reader import Reader
    from difacto_tpu_torch.data.rowblock import RowBlock
    blocks = list(Reader(path, "rec", 0, 1))
    return blocks[0] if len(blocks) == 1 else RowBlock.concat(blocks)


@pytest.fixture(scope="module")
def online_log(rows, tmp_path_factory):
    """A finished 4-segment log of the 100 rcv1 rows, each joined with
    its true label."""
    log_dir = str(tmp_path_factory.mktemp("online_log") / "olog")
    olog = OnlineLog(log_dir, segment_rows=25, label_delay_s=3600.0)
    for i, row in enumerate(rows):
        olog.append(_row(row), row_id=i)
        olog.label(i, float(row.split()[0]))
    olog.end()
    assert list_segments(log_dir) == [0, 1, 2, 3]
    return log_dir


# ---------------------------------------------------------------- log
@pytest.mark.parametrize("default", ["negative", "drop"])
def test_log_segments_and_index_equal_jax(rows, tmp_path, default):
    """The same appends and labels (every even row labeled, in an order
    that joins some rows behind unlabeled heads) leave byte-identical
    segments and equal index rows; ``end()`` resolves the rest to the
    default and drops the end marker."""
    logs = {}
    for name, cls, parse in (("port", OnlineLog, tparser("libsvm")),
                             ("jax", JLog, jparser("libsvm"))):
        d = str(tmp_path / name)
        olog = cls(d, segment_rows=16, label_delay_s=3600.0,
                   label_default=default)
        for i, row in enumerate(rows):
            assert olog.append(parse(row), row_id=None if i % 3 else i) \
                == i
            if i % 2 == 0 and i >= 4:
                assert olog.label(i - 4, float(row.split()[0]))
        assert not olog.label(10 ** 6, 1.0)
        olog.end()
        logs[name] = (d, olog.stats())
    (tdir, tst), (jdir, jst) = logs["port"], logs["jax"]
    assert tst == jst
    segs = list_segments(tdir)
    assert segs and segs == list_segments(jdir)
    for s in segs:
        with open(seg_path(tdir, s), "rb") as a, \
                open(seg_path(jdir, s), "rb") as b:
            assert a.read() == b.read(), s
    strip = [[(e["seg"], e["rows"]) for e in read_index(d)]
             for d in (tdir, jdir)]
    assert strip[0] == strip[1]
    assert os.path.exists(os.path.join(tdir, "log.end"))
    total = sum(r for _, r in strip[0])
    assert total == (100 if default == "negative"
                     else 100 - tst["rows_dropped"])
    labels = np.concatenate([_read_back(seg_path(tdir, s)).label
                             for s in segs])
    if default == "negative":
        assert (labels == 0).sum() > 0


def test_log_horizon_expiry_and_restart_numbering(tmp_path):
    """An unlabeled row resolves to the default once its horizon passes
    (``poll`` without traffic); a reopened log resumes past the sealed
    segments."""
    olog = OnlineLog(str(tmp_path / "neg"), segment_rows=2,
                     label_delay_s=0.05)
    olog.append(_row(b"1 3:1"), row_id=0)
    olog.append(_row(b"1 4:1"), row_id=1)
    assert list_segments(olog.log_dir) == []
    time.sleep(0.1)
    olog.poll()
    assert list_segments(olog.log_dir) == [0]
    assert _read_back(seg_path(olog.log_dir, 0)).label.tolist() == [0, 0]
    assert OnlineLog(olog.log_dir).stats()["next_seg"] == 1
    with pytest.raises(ValueError, match="label_default"):
        OnlineLog(str(tmp_path / "x"), label_default="bogus")


def test_tail_reader_replay_end_stop_and_deadline(tmp_path):
    log_dir = str(tmp_path / "olog")
    olog = OnlineLog(log_dir, segment_rows=1, label_delay_s=3600.0)
    for i in range(2):
        olog.append(_row(b"1 3:1"), row_id=i)
        olog.label(i, 1.0)
    assert list(TailReader(log_dir, replay=True)) == [
        (0, seg_path(log_dir, 0)), (1, seg_path(log_dir, 1))]
    with deadline(60):
        out = []
        t = threading.Thread(target=lambda: out.extend(
            s for s, _ in TailReader(log_dir, poll_s=0.01)))
        t.start()
        time.sleep(0.1)
        olog.append(_row(b"1 4:1"), row_id=2)
        olog.label(2, 0.0)
        olog.end()
        t.join(timeout=30)
    assert not t.is_alive() and out == [0, 1, 2]
    # the last seal and the end marker both landing between the reader's
    # look for the segment and its look for the end: still yielded
    late = str(tmp_path / "late")
    llog = OnlineLog(late, segment_rows=1, label_delay_s=3600.0)

    class Racing(TailReader):
        def _ended(self):
            if not list_segments(late):
                llog.append(_row(b"1 5:1"), row_id=0)
                llog.label(0, 1.0)
                llog.end()
            return super()._ended()

    assert [s for s, _ in Racing(late, poll_s=0.01)] == [0]
    ev = threading.Event()
    ev.set()
    assert list(TailReader(log_dir, start_seg=99, stop=ev)) == []
    t0 = time.monotonic()
    assert list(TailReader(str(tmp_path / "empty"), poll_s=0.01,
                           max_seconds=0.05)) == []
    assert time.monotonic() - t0 < 5


# ------------------------------------------------------------ trainer
def _jax_init(kwargs):
    tp, _ = T.SGDUpdaterParam.init_allow_unknown(kwargs)
    jp, _ = J.SGDUpdaterParam.init_allow_unknown(kwargs)
    return lambda C: state_from_jax_table(
        tp, np.asarray(J.init_state(jp, C).VVg), "cpu")


def test_online_trainer_matches_jax(online_log, tmp_path, monkeypatch):
    """The port's trainer over the sealed log, from JAX's init table,
    against the JAX trainer's: counts and liveness equal, every other
    column within 1e-5 of its own max."""
    from difacto_tpu.online import OnlineParam as JParam
    from difacto_tpu.online import OnlineTrainer as JTrainer
    kw = list(_LEARN)
    init = _jax_init(kw)
    monkeypatch.setattr(
        learner_base.Learner, "create",
        staticmethod(lambda name, device="cuda": SGDLearner(
            device=device, table_init=init)))
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    tr = OnlineTrainer(OnlineParam(online_log_dir=online_log,
                                   online_ckpt_interval_s=0),
                       kw + [("model_out", got)], device="cpu")
    assert tr.run() == 3 and tr.generations() == 1
    jt = JTrainer(JParam(online_log_dir=online_log,
                         online_ckpt_interval_s=0),
                  kw + [("model_out", want), ("num_producers", "1"),
                        ("producer_mode", "thread"),
                        ("fused_kernel", "jnp")])
    assert jt.run() == 3
    a, b = np.load(got + "_part-0"), np.load(want + "_part-0")
    for f in ("cnt", "v_live"):
        np.testing.assert_array_equal(a[f], b[f])
    assert (a["w"] != 0).sum() > 0 and a["v_live"].any()
    for f in ("w", "z", "sqrt_g", "V", "Vg"):
        err = float(np.abs(a[f] - b[f]).max())
        scale = float(np.abs(b[f]).max())
        print(f"measured online {f}: max|port - jax| = {err:.3g}, "
              f"{err / scale:.3g} of max|jax| (limit 1e-5)")
        assert err <= 1e-5 * scale, (f, err, scale)


def _cli(log_dir, model, *extra):
    return ["task=online", "device=cpu", f"online_log_dir={log_dir}",
            f"model_out={model}"] + [f"{k}={v}" for k, v in _LEARN] \
        + list(extra)


def test_online_cli_and_replay_checkpoints_byte_identical(online_log,
                                                          tmp_path):
    """``task=online`` through the CLI, committing after every segment,
    and an ``online_replay=1`` run committing only at the end: the final
    checkpoints are equal array for array, byte for byte."""
    online, replay = str(tmp_path / "online"), str(tmp_path / "replay")
    assert tmain(_cli(online_log, online,
                      "online_ckpt_interval_s=0.000001")) == 0
    for s in range(4):
        assert os.path.exists(f"{online}_iter-{s}_part-0"), s
    assert tmain(_cli(online_log, replay, "online_replay=1",
                      "online_ckpt_interval_s=0")) == 0
    assert not os.path.exists(f"{replay}_iter-0_part-0")
    with np.load(online + "_part-0") as a, np.load(replay + "_part-0") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    with np.load(online + "_iter-3_part-0") as a, \
            np.load(replay + "_iter-3_part-0") as b:
        for k in ("w", "V", "z", "Vg"):
            assert a[k].tobytes() == b[k].tobytes(), k


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_push_reload_against_live_server(online_log, rows, tmp_path):
    """push_reload is best effort per endpoint: a dead endpoint and a
    pruned generation count as failures, a live one advances the served
    generation; a reload of a pruned generation keeps the model
    serving."""
    from difacto_tpu_torch.utils import manifest as mft
    model = str(tmp_path / "fam")
    assert tmain(_cli(online_log, model,
                      "online_ckpt_interval_s=0.000001")) == 0
    pushes0 = REGISTRY.value("online_reload_pushes_total")
    with deadline(120):
        store, _, _ = open_serving_store(f"{model}_iter-3", device="cpu")
        srv = ServeServer(store, batch_size=50, max_delay_ms=5.0).start()
        srv.reloader = ModelReloader(srv.executor, f"{model}_iter-3",
                                     server=srv)
        try:
            gen0 = srv.executor.generation
            removed = mft.prune_checkpoints(model, 2)
            assert any("_iter-0" in p for p in removed), removed
            res = srv.reloader.reload(f"{model}_iter-0")
            assert res["ok"] is False and res["error"], res
            with ServeClient(srv.host, srv.port) as c:
                assert None not in c.predict(rows[:5])
            out = push_reload([("127.0.0.1", _free_port()),
                               (srv.host, srv.port)], f"{model}_iter-2")
            assert out == {"ok": 1, "failed": 1}
            assert srv.executor.generation == gen0 + 1
            out = push_reload([(srv.host, srv.port)], f"{model}_iter-1")
            assert out == {"ok": 0, "failed": 1}
            assert srv.executor.generation == gen0 + 1
        finally:
            srv.close()
    assert REGISTRY.value("online_reload_pushes_total") - pushes0 == 3


# --------------------------------------------------- the loop, one process
def test_inprocess_loop_scores_labels_trains_and_reloads(online_log, rows,
                                                         rcv1_path,
                                                         tmp_path):
    """``#score``/``#label`` into a logging server while the trainer
    tails the log and pushes each committed generation back: labels join,
    the served generation advances, the freshness gauges ride
    ``#metrics``, and after the last reload the server answers the
    port's ``task=pred`` of the final checkpoint byte for byte."""
    start = str(tmp_path / "start")
    assert tmain(_cli(online_log, start, "online_ckpt_interval_s=0")) == 0
    log_dir, model = str(tmp_path / "olog"), str(tmp_path / "model")
    olog = OnlineLog(log_dir, segment_rows=20, label_delay_s=0.3)
    joined0 = REGISTRY.value("online_labels_joined_total")
    with deadline(240):
        store, _, _ = open_serving_store(start, device="cpu")
        srv = ServeServer(store, batch_size=16, max_delay_ms=2.0,
                          online_log=olog).start()
        srv.reloader = ModelReloader(srv.executor, model, server=srv)
        gen0 = srv.executor.generation
        tr = OnlineTrainer(
            OnlineParam(online_log_dir=log_dir,
                        online_ckpt_interval_s=0.2,
                        online_endpoints=f"{srv.host}:{srv.port}"),
            _LEARN + [("model_out", model)], device="cpu")
        res = {}
        tt = threading.Thread(target=lambda: res.update(trained=tr.run()))
        tt.start()
        acks = 0
        try:
            with socket.create_connection((srv.host, srv.port)) as c:
                f = c.makefile("rb")
                for rep in range(3):
                    for i, row in enumerate(rows):
                        rid = rep * 100 + i
                        c.sendall(b"#score %d %s\n" % (rid, row))
                        assert not f.readline().startswith(b"!")
                        if i % 2 == 0:
                            c.sendall(b"#label %d %s\n"
                                      % (rid, row.split()[0]))
                            acks += json.loads(f.readline())["ok"]
                    time.sleep(0.4)
            olog.end()
            logged = olog.stats()["rows_logged"]
            tt.join(timeout=180)
            assert not tt.is_alive(), "the trainer never drained the log"
            with ServeClient(srv.host, srv.port) as c:
                text = c.metrics()
                answers = c.score_lines(rows)
            gen1 = srv.executor.generation
        finally:
            if tt.is_alive():
                tr.stop()
                tt.join(timeout=60)
            srv.close()
    # a label joins unless its row passed the 0.3 s horizon first
    assert 0 < acks <= 150 and logged == 300
    assert REGISTRY.value("online_labels_joined_total") - joined0 == acks
    assert res["trained"] == max(list_segments(log_dir))
    assert tr.generations() >= 2 and gen1 >= gen0 + 2
    for name in ("train_behind_serve_s", "online_rows_behind",
                 "serve_generation_age_s"):
        assert name in text, name
    pred = str(tmp_path / "pred")
    assert tmain(["task=pred", "device=cpu", f"model_in={model}",
                  f"data_val={rcv1_path}", f"pred_out={pred}",
                  "batch_size=100"]) == 0
    with open(pred + "_part-0", "rb") as fp:
        col = [l.split(b"\t")[1] for l in fp.read().splitlines()]
    assert answers == col


# -------------------------------------------------------- fault points
@pytest.mark.parametrize("point", ["online.log.append",
                                   "online.label_join", "online.seal"])
def test_online_fault_points(online_log, rows, tmp_path, point):
    """``online.log.append``: every append fails, every row is still
    answered and the drops are counted; ``online.label_join``: a typed
    ``!err`` reply, the connection survives and the next label joins;
    ``online.seal``: the resolved rows stay in memory and seal into the
    segment they belonged to once the fault is gone."""
    olog = OnlineLog(str(tmp_path / "olog"), segment_rows=2,
                     label_delay_s=3600.0)
    before = REGISTRY.value("faults_fired_total", point=point, kind="err")
    if point == "online.seal":
        fails0 = REGISTRY.value("online_seal_failures_total")
        faultinject.configure(f"{point}:err@1")
        for i, y in enumerate((1.0, 0.0)):
            olog.append(_row(b"1 %d:1" % (3 + i)), row_id=i)
            olog.label(i, y)
        fired = faultinject.stats()
        faultinject.configure("")
        assert list_segments(olog.log_dir) == []
        assert olog.stats()["buffered"] == 2
        assert REGISTRY.value("online_seal_failures_total") - fails0 >= 1
        olog.flush()
        assert list_segments(olog.log_dir) == [0]
        assert _read_back(seg_path(olog.log_dir, 0)).label.tolist() \
            == [1.0, 0.0]
    else:
        store, _, _ = open_serving_store(_model_for(online_log, tmp_path),
                                         device="cpu")
        with deadline(60):
            srv = ServeServer(store, batch_size=8, max_delay_ms=2.0,
                              online_log=olog).start()
            try:
                if point == "online.log.append":
                    drops0 = REGISTRY.value("online_log_drops_total")
                    faultinject.configure(f"{point}:err@1")
                    with ServeClient(srv.host, srv.port) as c:
                        got = c.predict(rows[:10])
                    fired = faultinject.stats()
                    faultinject.configure("")
                    assert None not in got
                    assert olog.stats()["rows_logged"] == 0
                    assert REGISTRY.value("online_log_drops_total") \
                        - drops0 == 10
                else:
                    with socket.create_connection(
                            (srv.host, srv.port), timeout=10) as s:
                        rf = s.makefile("rb")
                        s.sendall(b"#score 7 1 5:1 9:2\n")
                        assert not rf.readline().startswith(b"!")
                        faultinject.configure(f"{point}:err@1")
                        s.sendall(b"#label 7 1\n")
                        assert rf.readline().startswith(b"!err")
                        fired = faultinject.stats()
                        faultinject.configure("")
                        s.sendall(b"#label 7 1\n")
                        assert json.loads(rf.readline()) == {"ok": True}
                        s.sendall(b"#label 7 0\n")
                        assert json.loads(rf.readline()) == {"ok": False}
            finally:
                faultinject.configure("")
                srv.close()
    assert fired.get(point, 0) >= 1, fired
    assert REGISTRY.value("faults_fired_total", point=point,
                          kind="err") > before


def _model_for(online_log, tmp_path):
    model = str(tmp_path / "m")
    assert tmain(_cli(online_log, model, "online_ckpt_interval_s=0")) == 0
    return model
