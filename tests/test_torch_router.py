"""The port's router against the JAX package's, on the CPU.

One model trained by the JAX package on the rcv1 fixture (V_dim 2,
hash_capacity 4096); JAX's ``task=pred`` file of it is the golden. Every
answer through the port's ``RouterServer`` over the port's replicas
equals that column byte for byte, with ``balance=p2c`` and
``balance=affinity``, and so do the mixed fleets (a JAX router in front
of port replicas, the port's router in front of JAX servers). On the
same inputs the port decides as JAX does: the affinity owner of 10,000
seeded keys for two capacities and four ring sizes, and the P2C pick
sequence from the same backend stats. The router's ``#health``,
``#stats`` and ``#backends`` carry JAX's key sets. Also: the
``router.forward`` and ``router.takeover`` fault points, ``#backends``
membership and the ``endpoints_file`` re-fold, and the listener shutdown
that keeps a draining group member from resetting fresh connections.
No router thread is left behind.

Every socket test runs under its own SIGALRM deadline.
"""

import contextlib
import json
import signal
import socket
import threading
import time

import numpy as np
import pytest

from difacto_tpu.__main__ import main as jmain
from difacto_tpu.serve import RouterServer as JRouter
from difacto_tpu.serve import ServeServer as JServer
from difacto_tpu.serve import open_serving_store as jopen
from difacto_tpu.utils import faultinject as jfaults
from difacto_tpu_torch.obs import REGISTRY
from difacto_tpu_torch.serve import (RouterServer, ServeClient, ServeServer,
                                     open_serving_store)
from difacto_tpu_torch.utils import faultinject

_TRAIN = ["V_dim=2", "hash_capacity=4096", "max_num_epochs=2",
          "V_threshold=2", "lr=0.1", "l1=0.1", "l2=0",
          "num_jobs_per_epoch=1", "batch_size=100", "shuffle=0",
          "report_interval=0", "stop_rel_objv=0"]


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
    jfaults.configure("")


@pytest.fixture(scope="module")
def model(rcv1_path, tmp_path_factory):
    """(model prefix, JAX pred probability column as bytes)."""
    d = tmp_path_factory.mktemp("router_model")
    prefix = str(d / "m")
    args = [f"data_in={rcv1_path}"] + _TRAIN
    assert jmain(args + [f"model_out={prefix}"]) == 0
    assert jmain(args + ["task=pred", f"model_in={prefix}",
                         f"data_val={rcv1_path}",
                         f"pred_out={d / 'pred'}"]) == 0
    with open(d / "pred_part-0", "rb") as f:
        col = [l.split(b"\t")[1] for l in f.read().splitlines()]
    assert len(col) == 100
    return prefix, col


@pytest.fixture(scope="module")
def rows(rcv1_path):
    with open(rcv1_path, "rb") as f:
        return [r for r in f.read().splitlines() if r.strip()]


def _replica(prefix, **kw):
    store, _, _ = open_serving_store(prefix, device="cpu")
    return ServeServer(store, batch_size=100, max_delay_ms=50.0,
                       **kw).start()


def _jreplica(prefix, **kw):
    store, _, _ = jopen(prefix)
    return JServer(store, batch_size=100, max_delay_ms=50.0, **kw).start()


def _eps(servers):
    return [(s.host, s.port) for s in servers]


def _close(*objs):
    for o in objs:
        if o is not None:
            o.close()


# ------------------------------------------------------------ answers
@pytest.mark.parametrize("balance", ["p2c", "affinity"])
def test_router_answers_equal_jax_pred(model, rows, balance):
    """Two port replicas behind the port's router: the 100 rows come back
    equal to JAX's ``task=pred`` column byte for byte, both replicas carry
    rows, ``#stats`` accounts for every row, ``#health`` sees both
    replicas ready; under affinity every forward is an owner hit."""
    prefix, col = model
    with deadline(120):
        a, b = _replica(prefix), _replica(prefix)
        router = None
        try:
            router = RouterServer(_eps([a, b]), balance=balance).start()
            with ServeClient(router.host, router.port) as c:
                assert c.score_lines(rows) == col
                st = c.stats()
                h = c.health()
                text = c.metrics()
        finally:
            _close(router, a, b)
    assert h["router"] and h["status"] == "ready", h
    assert h["replicas_live"] == 2 and h["replicas_total"] == 2, h
    assert st["balance"] == balance and st["errors"] == 0, st
    assert st["rows"] == sum(x["rows"] for x in st["backends"]) == 100, st
    assert st["fleet"]["responses"] == 100, st
    assert "difacto_router_rows_forwarded_total" in text, text[:400]
    if balance == "affinity":
        assert st["affinity_hits"] > 0 and st["affinity_misses"] == 0, st
        assert all(x["rows"] > 0 for x in st["backends"]), st
        assert "router_affinity_hit_rate 1" in text, text[:400]


@pytest.mark.parametrize("mix", ["jax_router_port_replicas",
                                 "port_router_jax_replicas"])
def test_mixed_fleets_answer_the_same_bytes(model, rows, mix):
    """The wire is one protocol: JAX's router in front of the port's
    replicas, and the port's router in front of JAX's servers, both give
    JAX's pred bytes, with either balance policy."""
    prefix, col = model
    with deadline(180):
        if mix == "jax_router_port_replicas":
            reps, router_cls = [_replica(prefix), _replica(prefix)], JRouter
        else:
            reps, router_cls = [_jreplica(prefix), _jreplica(prefix)], \
                RouterServer
        try:
            for balance in ("p2c", "affinity"):
                router = router_cls(_eps(reps), balance=balance).start()
                try:
                    with ServeClient(router.host, router.port) as c:
                        assert c.score_lines(rows) == col, balance
                        st = c.stats()
                finally:
                    router.close()
                assert st["rows"] == 100 and st["errors"] == 0, st
        finally:
            _close(*reps)


# ---------------------------------------------------------- decisions
def _seeded_rows(n: int, seed: int) -> list:
    """libsvm rows whose leading keys span small, adjacent and 63-bit
    integers, plus a few non-integer tokens (the crc32 path) and rows with
    no feature at all (key 0)."""
    rng = np.random.RandomState(seed)
    keys = np.concatenate([
        rng.randint(0, 1 << 20, n // 4),
        np.arange(n // 4) + 12345,
        rng.randint(0, 1 << 62, n - n // 2, dtype=np.int64)])
    out = [b"1 %d:1 7:0.5" % k for k in keys]
    for j in range(0, n, 997):
        out[j] = b"0 tok%d:1" % j
    for j in range(5, n, 1999):
        out[j] = b"1"
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("cap", [0, 4194304])
def test_affinity_owner_matches_jax(cap, n):
    """``_affinity_owner`` of 10,000 seeded keys equals JAX's for the
    capacity arithmetic and the splitmix64 ring; a ring of more than one
    backend spreads the keys."""
    eps = [("127.0.0.1", 1 + i) for i in range(n)]
    jr = JRouter(eps, affinity_capacity=cap, balance="affinity")
    port_r = RouterServer(eps, affinity_capacity=cap, balance="affinity")
    try:
        ring = list(range(n))
        rs = _seeded_rows(10_000, seed=cap + n)
        want = [jr._affinity_owner(r, ring) for r in rs]
        got = [port_r._affinity_owner(r, ring) for r in rs]
    finally:
        jr.close()
        port_r.close()
    assert got == want
    assert [port_r._affinity_key(r) for r in rs[:50]] == \
        [jr._affinity_key(r) for r in rs[:50]]
    if n > 1:
        assert len(set(got)) > 1


def test_pick_sequence_matches_jax():
    """From the same backend stats and the same draw order, the port's
    P2C picks the same backends as JAX's (``random.Random(0x20072)``):
    live pairs compared on (in-flight, EWMA), ejected backends skipped,
    the affinity owner preferred while untried, all-ejected falling back
    to the earliest deadline, an exhausted budget answering None."""
    eps = [("127.0.0.1", 1 + i) for i in range(5)]
    jr, port_r = JRouter(eps), RouterServer(eps)
    rng = np.random.RandomState(7)
    now = time.monotonic()
    seq_j, seq_p = [], []
    try:
        for step in range(400):
            infl = rng.randint(0, 4, 5)
            ewma = rng.choice([0.0, 0.5, 1.0, 2.5], 5)
            down = np.where(rng.random_sample(5) < 0.3,
                            now + 100 + rng.random_sample(5), 0.0)
            if step % 50 == 7:
                down[:] = now + 100 + np.arange(5)[::-1]   # all ejected
            attempts = {int(i): int(rng.randint(0, 4))
                        for i in rng.choice(5, rng.randint(0, 4),
                                            replace=False)}
            if step % 40 == 11:
                attempts = {i: 3 for i in range(5)}   # budget exhausted
            prefer = int(rng.randint(0, 5)) if step % 3 == 0 else None
            for r in (jr, port_r):
                for b, f, e, d in zip(r._backends, infl, ewma, down):
                    b.in_flight, b.ewma_ms, b.down_until = \
                        int(f), float(e), float(d)
            seq_j.append(jr._pick(dict(attempts), prefer))
            seq_p.append(port_r._pick(dict(attempts), prefer))
    finally:
        jr.close()
        port_r.close()
    assert seq_p == seq_j
    assert None in seq_p and len(set(seq_p) - {None}) == 5


# ----------------------------------------------------------- key sets
def test_router_key_sets_match_jax(model, rows):
    """``#health``, ``#stats`` and ``#backends`` of the port's router over
    port replicas carry the keys of JAX's router over JAX's servers, down
    to each backend's and each replica's entry."""
    prefix, _ = model
    with deadline(180):
        got = {}
        for name, mk, router_cls in (("jax", _jreplica, JRouter),
                                     ("port", _replica, RouterServer)):
            reps = [mk(prefix), mk(prefix)]
            router = None
            try:
                # every replica has answered rows (its #stats then holds
                # the latency keys) whichever way P2C splits the window
                for r in reps:
                    with ServeClient(r.host, r.port) as c:
                        c.score_lines(rows[:10])
                router = router_cls(_eps(reps), takeover=True).start()
                with ServeClient(router.host, router.port) as c:
                    c.score_lines(rows[:10])
                    h, st = c.health(), c.stats()
                    bk = json.loads(c.score_lines([b"#backends"])[0])
            finally:
                _close(router, *reps)
            got[name] = {
                "health": set(h), "stats": set(st), "backends": set(bk),
                "health.replicas": set(h["replicas"][0]),
                "stats.backends": set(st["backends"][0]),
                "stats.replicas": set(st["replicas"][0]),
                "stats.fleet": set(st["fleet"])}
    assert got["port"] == got["jax"]


# ------------------------------------------------------- fault points
def test_router_forward_fault_retries_on_peer(model, rows):
    """``router.forward:close`` tears a backend connection down mid-chunk
    every 4th forward: every row is still answered (JAX's pred bytes), the
    tails crossed to the peer, and the fire is counted."""
    prefix, col = model
    before = REGISTRY.value("faults_fired_total", point="router.forward",
                            kind="close")
    with deadline(120):
        a, b = _replica(prefix), _replica(prefix)
        router = None
        try:
            router = RouterServer(_eps([a, b]), retries=4).start()
            faultinject.configure("router.forward:close@1:3")
            with ServeClient(router.host, router.port) as c:
                got = []
                for k in range(0, 100, 5):
                    got += c.score_lines(rows[k:k + 5])
            fired = faultinject.stats()
            st = router.stats_snapshot()
        finally:
            faultinject.configure("")
            _close(router, a, b)
    assert got == col
    assert fired.get("router.forward", 0) >= 1, fired
    assert st["retries"] >= 1 and st["errors"] == 0, st
    assert all(x["rows"] > 0 for x in st["backends"]), st
    assert REGISTRY.value("faults_fired_total", point="router.forward",
                          kind="close") > before


def test_router_takeover_fault_refuses_roll(model, rows, tmp_path):
    """``router.takeover:err`` refuses ``#handoff`` as a typed ``!err``
    before any drain state changes: the router keeps routing."""
    prefix, col = model
    before = REGISTRY.value("faults_fired_total", point="router.takeover",
                            kind="err")
    with deadline(120):
        a, b = _replica(prefix), _replica(prefix)
        router = None
        try:
            router = RouterServer(_eps([a, b]), takeover=True).start()
            faultinject.configure("router.takeover:err@1")
            with ServeClient(router.host, router.port) as c:
                with pytest.raises(ValueError):
                    c.handoff(str(tmp_path / "nonexistent.ready"))
                assert c.health()["status"] == "ready"
                assert c.score_lines(rows) == col
        finally:
            faultinject.configure("")
            _close(router, a, b)
    assert REGISTRY.value("faults_fired_total", point="router.takeover",
                          kind="err") > before


# --------------------------------------------------------- membership
def test_backends_membership_and_endpoints_file(model, rows, tmp_path):
    """``#backends add|remove`` changes the ring at runtime (a removed
    backend gets no rows); a rewritten ``endpoints_file`` re-folds on its
    ``(mtime, size)``; a malformed ``#backends`` answers ``!err``."""
    prefix, col = model
    with deadline(120):
        a, b = _replica(prefix), _replica(prefix)
        ring = tmp_path / "ring"
        ring.write_text(f"{a.host}:{a.port}\n")
        router = None
        try:
            router = RouterServer("", endpoints_file=str(ring)).start()
            with ServeClient(router.host, router.port) as c:
                def ctl(line):
                    return c.score_lines([line])[0]
                assert json.loads(ctl(b"#backends"))["backends"] == \
                    [f"{a.host}:{a.port}"]
                r = json.loads(ctl(b"#backends add %s:%d"
                                   % (b.host.encode(), b.port)))
                assert len(r["backends"]) == 2 and r["server_id"], r
                assert c.score_lines(rows) == col
                json.loads(ctl(b"#backends remove %s:%d"
                               % (a.host.encode(), a.port)))
                before = a.stats_snapshot()["responses"]
                assert c.score_lines(rows) == col
                assert a.stats_snapshot()["responses"] == before
                assert ctl(b"#backends frob 1:2").startswith(b"!err")
                # the durable ring: the file names a alone again
                time.sleep(0.6)
                ring.write_text(f"{a.host}:{a.port}\n\n")
                time.sleep(0.6)
                assert c.score_lines(rows[:10]) == col[:10]
                assert json.loads(ctl(b"#backends"))["backends"] == \
                    [f"{a.host}:{a.port}"]
        finally:
            _close(router, a, b)


def test_drain_shuts_the_listener_before_closing(model, rows):
    """Two routers share one ``SO_REUSEPORT`` port; while one drains, a
    dialer opens fresh connections to the port as fast as it can. The
    draining member shuts its listener down before it closes it, so no
    fresh connection is reset: every dial is answered by a member (JAX's
    router closes the listener under its 0.25 s accept poll, and a
    connection hashed to it in that window is reset)."""
    prefix, col = model
    with deadline(120):
        a = _replica(prefix)
        r1 = r2 = None
        stop = threading.Event()
        fails, answered = [], []

        def dial():
            while not stop.is_set():
                try:
                    with socket.create_connection((r1.host, r1.port),
                                                  timeout=5) as s:
                        s.sendall(b"#backends\n")
                        line = s.makefile("rb").readline()
                    if not line.startswith(b"{"):
                        fails.append(line)
                    else:
                        answered.append(json.loads(line)["server_id"])
                except OSError as e:
                    fails.append(repr(e))

        try:
            r1 = RouterServer(_eps([a]), takeover=True).start()
            r2 = RouterServer(_eps([a]), host=r1.host, port=r1.port,
                              takeover=True).start()
            ids = set()
            t = threading.Thread(target=dial)
            t.start()
            while len(set(answered)) < 2 and len(answered) < 2000:
                time.sleep(0.01)
            ids = set(answered)
            r1.drain()
            n_at_drain = len(answered)
            time.sleep(0.3)
            stop.set()
            t.join(timeout=30)
            with ServeClient(r2.host, r2.port) as c:
                assert c.score_lines(rows) == col
        finally:
            stop.set()
            _close(r1, r2, a)
    assert len(ids) == 2, ids
    assert len(answered) > n_at_drain
    assert not fails, fails[:5]


def test_no_router_threads_leak_overall():
    """Whatever ran before this test in this file, no router or serve
    thread is left."""
    names = [t.name for t in threading.enumerate()
             if t.name.startswith(("router-", "serve-"))]
    assert not names, names
