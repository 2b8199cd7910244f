"""Open-loop Poisson load generator for the serving front-end
(counterpart of the JAX package's ``tools/loadgen.py``: the same
modes, reports and flags).

Open-loop means arrivals follow a fixed schedule (exponential
inter-arrival gaps at the target QPS) REGARDLESS of response progress —
the honest way to measure a service under load: a closed loop would slow
its own offered rate the moment the server slows down and hide the
queueing collapse (the coordinated-omission trap). A sender thread walks
the schedule and writes one row per arrival; a receiver thread matches
responses (in-order per connection) against send timestamps.

Usage:

    python -m difacto_tpu_torch.tools.loadgen --host 127.0.0.1 \
        --port 9000 --data tests/data/rcv1_100.libsvm --qps 500 \
        --duration 5

Prints one JSON line: offered/achieved QPS, ok/shed/err counts, and
p50/p95/p99/max response latency (ms). Importable as ``run_loadgen``.

``--endpoints h1:p1,h2:p2`` switches to the FAILOVER mode
(``run_loadgen_failover``): arrivals follow the same open-loop schedule,
but rows travel through the multi-endpoint ``ServeClient``
(serve/client.py) in small pipelined chunks — a killed or draining
replica shows up as failovers and retried tails, not client errors.
The report's
``endpoints`` section is a PER-ENDPOINT summary (rows answered,
failovers, ejections — ``ServeClient.endpoints_health()``), so a
rolling-restart run shows which replica absorbed each handoff window.
``--blacklist FILE`` joins the fleet's shared endpoint health
(serve/fleethealth.py): ejections propagate to/from every other client
and the router.

``--profile diurnal`` shapes the offered rate over the run as a
piecewise-linear multiplier of ``--qps`` (trough → morning ramp → peak
at 1.6x → evening decay → trough), the day-cycle in miniature that an
elastic fleet must follow: it forces a scale-up mid-run and a drain
after the peak. ``flat`` (the default) keeps the constant-rate schedule.
The schedule stays open-loop either way — the multiplier rides on the
SCHEDULED arrival time, not on response progress.

``--zipf-alpha A`` (flat and failover modes) skews WHICH rows get
sent: row ranks draw from a Zipf(A) law instead of the round-robin
cycle, the popularity shape real key traffic has (the cold tier's
hit rate depends on it).

``--label-rate R --label-delay-s D`` switches to the FEEDBACK mode
(``run_loadgen_feedback``) for the online-learning loop: every arrival
is sent as ``#score <id> <row>`` so the server logs it under a
client-chosen id,
and for a seeded fraction ``R`` of rows the client reports the row's
own libsvm label back with ``#label <id> <y>`` after ~``D/2`` seconds —
inside the server's ``label_delay_s`` horizon, so the join lands. The
report adds ``labels_sent`` / ``labels_acked`` / ``labels_missed``.
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time
from typing import List, Sequence, Union

import numpy as np

from ..utils.locktrace import mutex

Line = Union[str, bytes]


def _to_bytes(line: Line) -> bytes:
    b = line.encode() if isinstance(line, str) else line
    return b if b.endswith(b"\n") else b + b"\n"


# QPS profiles: (run_fraction, multiplier) anchors, piecewise-linear in
# between. ``diurnal`` is a day cycle compressed into one run — trough,
# ramp, 1.6x peak, decay — sized so a fleet provisioned for the mean
# must scale up through the peak and back down after it.
PROFILES = {
    "flat": ((0.0, 1.0), (1.0, 1.0)),
    "diurnal": ((0.0, 0.3), (0.25, 1.0), (0.5, 1.6),
                (0.75, 0.8), (1.0, 0.3)),
}


def profile_qps(profile, qps: float, frac: float) -> float:
    """The instantaneous target rate at fraction ``frac`` (0..1) of the
    run: ``qps`` times the profile's piecewise-linear multiplier.
    ``profile`` is a name from :data:`PROFILES` or an anchor sequence."""
    anchors = PROFILES[profile] if isinstance(profile, str) else \
        tuple(profile)
    f = min(max(frac, 0.0), 1.0)
    for (f0, m0), (f1, m1) in zip(anchors, anchors[1:]):
        if f <= f1:
            w = 0.0 if f1 <= f0 else (f - f0) / (f1 - f0)
            return qps * (m0 + (m1 - m0) * w)
    return qps * anchors[-1][1]


def make_picker(n: int, zipf_alpha: float, seed: int = 0):
    """Row-index chooser for the senders: ``zipf_alpha <= 0`` cycles
    round-robin (every row equally hot — the historical behavior);
    ``zipf_alpha > 0`` draws ranks from a Zipf law ``p(r) ~ 1/r^alpha``
    over the row set, the skewed key popularity real traffic has and
    the shape the cold tier's hit-rate depends on. Seeded
    and independent of the arrival-schedule RNG, so turning skew on
    never perturbs the offered-rate schedule."""
    if zipf_alpha <= 0.0 or n <= 1:
        return lambda i: i % n
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), zipf_alpha)
    cdf = np.cumsum(w / w.sum())
    rng = np.random.RandomState(seed ^ 0x5A1F)
    return lambda i: int(np.searchsorted(cdf, rng.random_sample()))


def run_loadgen(host: str, port: int, rows: Sequence[Line], qps: float,
                duration_s: float, seed: int = 0,
                recv_timeout: float = 30.0,
                profile: str = "flat", zipf_alpha: float = 0.0) -> dict:
    """Drive the server open-loop at ``qps`` for ``duration_s`` seconds,
    cycling through ``rows``; ``profile`` shapes the rate over the run
    (:func:`profile_qps`), ``zipf_alpha`` skews which rows get sent
    (:func:`make_picker`). Returns the latency/throughput report."""
    rows = [_to_bytes(r) for r in rows]
    if not rows:
        raise ValueError("loadgen needs at least one request row")
    pick = make_picker(len(rows), zipf_alpha, seed)
    rng = np.random.RandomState(seed)
    sock = socket.create_connection((host, port), timeout=recv_timeout)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:  # pragma: no cover
        pass
    rfile = sock.makefile("rb")

    send_ts: List[float] = []      # monotonic send time per request
    ts_lock = mutex()
    sent = 0

    def sender() -> None:
        nonlocal sent
        t0 = t_next = time.monotonic()
        t_end = t_next + duration_s
        i = 0
        while True:
            now = time.monotonic()
            if now >= t_end:
                break
            if now < t_next:
                time.sleep(min(t_next - now, 0.01))
                continue
            with ts_lock:
                send_ts.append(time.monotonic())
            try:
                sock.sendall(rows[pick(i)])
            except OSError:
                # the server dropped the connection (drain/shutdown
                # mid-run): stop offering, let the receiver tally what
                # came back — rows past this point were never sent
                with ts_lock:
                    send_ts.pop()
                break
            sent += 1
            i += 1
            # exponential gaps: Poisson arrivals at the target rate
            # (profile-shaped at the SCHEDULED time, not the send time).
            # Falling behind (a slow send) is NOT forgiven — the next
            # arrival time advances by the schedule, keeping the offered
            # rate honest even when the socket pushes back.
            t_next += rng.exponential(1.0 / profile_qps(
                profile, qps, (t_next - t0) / duration_s))
        # half-close: the server reader sees EOF, drains queued futures,
        # and the responses for every sent row still arrive below
        try:
            sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    lat_ok: List[float] = []
    n_ok = n_shed = n_err = 0

    def receiver() -> None:
        nonlocal n_ok, n_shed, n_err
        i = 0
        while True:
            try:
                line = rfile.readline()
            except (socket.timeout, OSError):
                break
            if not line:
                break
            now = time.monotonic()
            with ts_lock:
                t0 = send_ts[i] if i < len(send_ts) else None
            i += 1
            if line.startswith(b"!shed"):
                n_shed += 1
            elif line.startswith(b"!err"):
                n_err += 1
            else:
                n_ok += 1
                if t0 is not None:
                    lat_ok.append(now - t0)

    st = threading.Thread(target=sender, name="loadgen-send")
    rt = threading.Thread(target=receiver, name="loadgen-recv")
    t_start = time.monotonic()
    st.start()
    rt.start()
    st.join()
    rt.join()
    elapsed = time.monotonic() - t_start
    rfile.close()
    sock.close()

    out = {
        "target_qps": qps,
        "duration_s": round(duration_s, 3),
        "sent": sent,
        "offered_qps": round(sent / max(duration_s, 1e-9), 1),
        "ok": n_ok,
        "shed": n_shed,
        "err": n_err,
        "shed_rate": round(n_shed / max(sent, 1), 4),
        # completed responses over the whole drain window: the rate the
        # service actually sustained
        "achieved_qps": round(n_ok / max(elapsed, 1e-9), 1),
    }
    if lat_ok:
        lat = np.asarray(lat_ok) * 1e3
        p50, p95, p99 = np.percentile(lat, [50, 95, 99])
        out.update(p50_ms=round(float(p50), 3), p95_ms=round(float(p95), 3),
                   p99_ms=round(float(p99), 3),
                   max_ms=round(float(lat.max()), 3))
    return out


def _row_label(row: bytes) -> float:
    """The row's own leading libsvm label token (the ground truth the
    feedback join replays), 0.0 when the row has none."""
    try:
        return float(row.split(None, 1)[0])
    except (ValueError, IndexError):
        return 0.0


def run_loadgen_feedback(host: str, port: int, rows: Sequence[Line],
                         qps: float, duration_s: float,
                         label_delay_s: float = 0.5,
                         label_rate: float = 0.5, seed: int = 0,
                         recv_timeout: float = 30.0) -> dict:
    """Open-loop generator for the serve→log→train feedback join: rows go
    out as ``#score <id> <row>`` and a seeded ``label_rate`` fraction
    get their own label reported back (``#label <id> <y>``) after half
    the ``label_delay_s`` horizon — delayed, but inside the window.
    Responses stay in request order per connection (scores resolve
    through the batcher, label acks are raw control replies, the writer
    drains both in admission order), so one receiver matches both."""
    rows = [_to_bytes(r) for r in rows]
    if not rows:
        raise ValueError("loadgen needs at least one request row")
    rng = np.random.RandomState(seed)
    sock = socket.create_connection((host, port), timeout=recv_timeout)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:  # pragma: no cover
        pass
    rfile = sock.makefile("rb")

    # per sent line: ("score", send_t) or ("label", None), in send order
    meta: List[tuple] = []
    ts_lock = mutex()
    sent = labels_sent = 0

    def sender() -> None:
        nonlocal sent, labels_sent
        import collections
        pending = collections.deque()   # (due_t, rid, y), due_t ascending
        t_next = time.monotonic()
        t_end = t_next + duration_s
        i = 0
        try:
            while True:
                now = time.monotonic()
                # due labels first: constant delay keeps the deque sorted
                while pending and pending[0][0] <= now:
                    _, rid, y = pending.popleft()
                    with ts_lock:
                        meta.append(("label", None))
                    sock.sendall(b"#label "
                                 + (b"%d %g\n" % (rid, y)))
                    labels_sent += 1
                if now >= t_end:
                    break
                if now < t_next:
                    time.sleep(min(t_next - now, 0.01))
                    continue
                row = rows[i % len(rows)]
                with ts_lock:
                    meta.append(("score", time.monotonic()))
                sock.sendall(b"#score " + (b"%d " % i) + row)
                sent += 1
                if label_rate > 0 and rng.random_sample() < label_rate:
                    pending.append((now + label_delay_s * 0.5, i,
                                    _row_label(row)))
                i += 1
                t_next += rng.exponential(1.0 / qps)
            # flush the tail of scheduled labels (their rows are already
            # logged; an early report still joins) before half-closing
            while pending:
                _, rid, y = pending.popleft()
                with ts_lock:
                    meta.append(("label", None))
                sock.sendall(b"#label " + (b"%d %g\n" % (rid, y)))
                labels_sent += 1
        except OSError:
            # connection dropped mid-run: the receiver tallies what
            # came back; the unsent line's meta entry is harmless (the
            # receiver indexes by reply order and stops at EOF)
            pass
        try:
            sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    lat_ok: List[float] = []
    n_ok = n_shed = n_err = 0
    labels_acked = labels_missed = label_errs = 0

    def receiver() -> None:
        nonlocal n_ok, n_shed, n_err, labels_acked, labels_missed
        nonlocal label_errs
        i = 0
        while True:
            try:
                line = rfile.readline()
            except (socket.timeout, OSError):
                break
            if not line:
                break
            now = time.monotonic()
            with ts_lock:
                kind, t0 = meta[i] if i < len(meta) else ("score", None)
            i += 1
            if kind == "label":
                if line.startswith(b"!err"):
                    label_errs += 1
                elif b"true" in line:
                    labels_acked += 1
                else:
                    labels_missed += 1   # row resolved past its horizon
            elif line.startswith(b"!shed"):
                n_shed += 1
            elif line.startswith(b"!err"):
                n_err += 1
            else:
                n_ok += 1
                if t0 is not None:
                    lat_ok.append(now - t0)

    st = threading.Thread(target=sender, name="loadgen-send")
    rt = threading.Thread(target=receiver, name="loadgen-recv")
    t_start = time.monotonic()
    st.start()
    rt.start()
    st.join()
    rt.join()
    elapsed = time.monotonic() - t_start
    rfile.close()
    sock.close()

    out = {
        "target_qps": qps,
        "duration_s": round(duration_s, 3),
        "sent": sent,
        "offered_qps": round(sent / max(duration_s, 1e-9), 1),
        "ok": n_ok,
        "shed": n_shed,
        "err": n_err,
        "shed_rate": round(n_shed / max(sent, 1), 4),
        "achieved_qps": round(n_ok / max(elapsed, 1e-9), 1),
        "labels_sent": labels_sent,
        "labels_acked": labels_acked,
        "labels_missed": labels_missed,
        "label_errs": label_errs,
    }
    if lat_ok:
        lat = np.asarray(lat_ok) * 1e3
        p50, p95, p99 = np.percentile(lat, [50, 95, 99])
        out.update(p50_ms=round(float(p50), 3), p95_ms=round(float(p95), 3),
                   p99_ms=round(float(p99), 3),
                   max_ms=round(float(lat.max()), 3))
    return out


def run_loadgen_failover(endpoints, rows: Sequence[Line], qps: float,
                         duration_s: float, seed: int = 0,
                         retries: int = 8, chunk: int = 64,
                         timeout: float = 30.0, blacklist=None,
                         profile: str = "flat",
                         zipf_alpha: float = 0.0) -> dict:
    """Open-loop schedule over the failover ``ServeClient``: due rows
    are pipelined in chunks of at most ``chunk``; a dropped replica is
    absorbed by the client (reconnect / next endpoint / resend tail),
    so only genuine ``!err`` rows or exhausted budgets count as errors.
    Latency is measured from each row's SCHEDULED arrival, so queueing
    behind a failover window is charged honestly. ``blacklist`` (path or
    FleetHealth) wires the client into the fleet's shared endpoint
    health (serve/fleethealth.py). The report's ``endpoints`` list is
    the per-endpoint summary — rows answered, failovers absorbed,
    ejections — so a rollout chaos run shows WHICH replica carried the
    handoff window, not just fleet totals. ``profile`` shapes the rate
    over the run (:func:`profile_qps`)."""
    from ..serve.client import ServeClient
    rows = [_to_bytes(r) for r in rows]
    if not rows:
        raise ValueError("loadgen needs at least one request row")
    pick = make_picker(len(rows), zipf_alpha, seed)
    rng = np.random.RandomState(seed)
    client = ServeClient(endpoints=endpoints, retries=retries,
                         backoff_s=0.02, backoff_max_s=0.5,
                         timeout=timeout, blacklist=blacklist)
    lat_ok: List[float] = []
    n_ok = n_shed = n_err = sent = 0
    i = 0
    t_start = time.monotonic()
    t_next, t_end = t_start, t_start + duration_s
    try:
        while time.monotonic() < t_end:
            due = []
            now = time.monotonic()
            while t_next <= now and t_next < t_end and len(due) < chunk:
                due.append((rows[pick(i)], t_next))
                i += 1
                t_next += rng.exponential(1.0 / profile_qps(
                    profile, qps, (t_next - t_start) / duration_s))
            if not due:
                time.sleep(min(max(t_next - now, 0.0), 0.01))
                continue
            sent += len(due)
            try:
                resp = client.score_lines([r for r, _ in due])
            except (OSError, ConnectionError):
                n_err += len(due)   # every endpoint's budget exhausted
                continue
            done = time.monotonic()
            for (_, t0), line in zip(due, resp):
                if line.startswith(b"!shed"):
                    n_shed += 1
                elif line.startswith(b"!err"):
                    n_err += 1
                else:
                    n_ok += 1
                    lat_ok.append(done - t0)
    finally:
        failovers = client.failovers
        endpoints_health = client.endpoints_health()
        client.close()
    elapsed = time.monotonic() - t_start
    out = {
        "target_qps": qps,
        "duration_s": round(duration_s, 3),
        "sent": sent,
        "offered_qps": round(sent / max(duration_s, 1e-9), 1),
        "ok": n_ok,
        "shed": n_shed,
        "err": n_err,
        "shed_rate": round(n_shed / max(sent, 1), 4),
        "achieved_qps": round(n_ok / max(elapsed, 1e-9), 1),
        "failovers": failovers,
        "endpoints": endpoints_health,
    }
    if lat_ok:
        lat = np.asarray(lat_ok) * 1e3
        p50, p95, p99 = np.percentile(lat, [50, 95, 99])
        out.update(p50_ms=round(float(p50), 3), p95_ms=round(float(p95), 3),
                   p99_ms=round(float(p99), 3),
                   max_ms=round(float(lat.max()), 3))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int)
    ap.add_argument("--endpoints", default="",
                    help="h1:p1,h2:p2 — drive the multi-endpoint "
                         "failover client instead of one raw socket")
    ap.add_argument("--data", required=True,
                    help="request rows, one per line (e.g. a libsvm file)")
    ap.add_argument("--qps", type=float, default=500.0)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--max-rows", type=int, default=100000,
                    help="cap on distinct rows read from --data")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default="flat",
                    choices=sorted(PROFILES),
                    help="shape of the offered rate over the run: "
                         "flat, or the diurnal trough/peak cycle")
    ap.add_argument("--zipf-alpha", type=float, default=0.0,
                    help="skew the row-selection distribution: 0 cycles "
                         "round-robin, >0 draws row ranks from a "
                         "Zipf(alpha) law — the popularity shape the "
                         "cold-tier hit rate depends on")
    ap.add_argument("--label-rate", type=float, default=0.0,
                    help="feedback mode: report each row's own label "
                         "back for this fraction of #score'd rows")
    ap.add_argument("--label-delay-s", type=float, default=0.5,
                    help="feedback mode: the server-side join horizon; "
                         "labels go out after half of it")
    ap.add_argument("--retries", type=int, default=8,
                    help="per-endpoint retry budget (failover mode)")
    ap.add_argument("--blacklist", default="",
                    help="shared endpoint-health file (failover mode; "
                         "serve/fleethealth.py)")
    args = ap.parse_args(argv)
    if not args.endpoints and args.port is None:
        ap.error("pass --port or --endpoints")
    with open(args.data, "rb") as f:
        rows = [l for l in f.read().splitlines() if l.strip()]
    rows = rows[:args.max_rows]
    if args.endpoints:
        rep = run_loadgen_failover(
            args.endpoints, rows, args.qps, args.duration,
            seed=args.seed, retries=args.retries,
            blacklist=args.blacklist or None, profile=args.profile,
            zipf_alpha=args.zipf_alpha)
        print(json.dumps(rep))
        # the per-endpoint summary, one human line each: which replica
        # answered the rows, who failed over, who got ejected
        import sys
        for e in rep["endpoints"]:
            print(f"# {e['host']}:{e['port']} rows={e['rows']} "
                  f"fails={e['fails']} ejections={e['ejections']} "
                  f"ejected={e['ejected']} active={e['active']}",
                  file=sys.stderr)
    elif args.label_rate > 0:
        print(json.dumps(run_loadgen_feedback(
            args.host, args.port, rows, args.qps, args.duration,
            label_delay_s=args.label_delay_s, label_rate=args.label_rate,
            seed=args.seed)))
    else:
        print(json.dumps(run_loadgen(args.host, args.port, rows, args.qps,
                                     args.duration, seed=args.seed,
                                     profile=args.profile,
                                     zipf_alpha=args.zipf_alpha)))


if __name__ == "__main__":
    main()
