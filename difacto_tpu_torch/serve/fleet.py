"""Replica lifecycle over the wire (counterpart of the single-replica part
of difacto_tpu/serve/fleet.py): the held control connection
(:class:`EndpointRpc`), fresh ``#health``/``#stats`` probes, the
scale-down drain, and one ``SO_REUSEPORT`` takeover
(:func:`run_takeover`): hold a connection to the incumbent while it is
the only listener, spawn the successor (``python -m difacto_tpu_torch
task=serve serve_takeover=1 ...``, which writes its ready file once
listening), send ``#handoff <ready_file>`` on the held connection, then
poll fresh connections until the successor's ``server_id`` answers ready.
The rolling restart over N replicas, its health gate, the router group
roll and ``notify_backends`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class EndpointRpc:
    """One newline-JSON control channel over a held TCP connection.

    Holding matters under SO_REUSEPORT: a FRESH connection hashes to any
    listener on the port, but an ESTABLISHED one stays with its owner —
    so a ``#handoff`` sent on a connection opened while the incumbent was
    the only listener provably reaches the incumbent."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.rfile = self.sock.makefile("rb")

    def call(self, line: str) -> dict:
        self.sock.sendall(line.encode() + b"\n")
        resp = self.rfile.readline()
        if not resp:
            raise ConnectionError("connection closed")
        if resp.startswith(b"!err"):
            raise ConnectionError(resp.rstrip(b"\n").decode())
        return json.loads(resp)

    def close(self) -> None:
        try:
            self.rfile.close()
            self.sock.close()
        except OSError:
            pass


def fresh_health(host: str, port: int, timeout: float = 5.0) -> dict:
    """#health over a throwaway connection — what a load balancer polls;
    under a takeover it answers from whichever replica currently owns
    fresh connections."""
    rpc = EndpointRpc(host, port, timeout=timeout)
    try:
        return rpc.call("#health")
    finally:
        rpc.close()


def fresh_stats(host: str, port: int, timeout: float = 5.0) -> dict:
    """#stats over a throwaway connection: a replica's serving
    counters."""
    rpc = EndpointRpc(host, port, timeout=timeout)
    try:
        return rpc.call("#stats")
    finally:
        rpc.close()


def drain_endpoint(host: str, port: int, timeout: float = 10.0) -> dict:
    """Scale-down primitive: a bare ``#handoff`` (no ready file) tells
    the replica or router to drain NOW — in-flight work finishes, fresh
    connections land elsewhere, the process leaves its serve loop."""
    rpc = EndpointRpc(host, port, timeout=timeout)
    try:
        return rpc.call("#handoff")
    finally:
        rpc.close()


def spawn_successor(model: str, port: int, ready_file: str, extra=(),
                    host: str = "127.0.0.1",
                    device="cuda") -> "subprocess.Popen":
    """Default successor: a fresh task=serve process of the port on the
    shared port (serve_takeover=1 so the kernel accepts the second
    binding), on ``device``. Its output goes to ``<ready_file>.log`` —
    not the caller's inherited pipes, which a parent capturing the
    caller's output would otherwise wait on for the successor's life."""
    args = [sys.executable, "-m", "difacto_tpu_torch", "task=serve",
            f"model_in={model}", f"serve_host={host}",
            f"serve_port={port}", "serve_takeover=1",
            f"serve_ready_file={ready_file}", f"device={device}", *extra]
    logf = open(ready_file + ".log", "ab")
    try:
        return subprocess.Popen(args, cwd=REPO, stdin=subprocess.DEVNULL,
                                stdout=logf, stderr=logf,
                                start_new_session=True)
    finally:
        logf.close()   # the child holds its own descriptor


def _wait_ready_file(ready_file: str, proc, wait_s: float,
                     poll_s: float) -> float:
    """Block until the successor writes its ready file; returns the warm
    seconds. Raises on successor exit or timeout — BEFORE any handoff,
    so the incumbent is untouched."""
    t0 = time.monotonic()
    while not os.path.exists(ready_file):
        if proc is not None and getattr(proc, "poll", None) \
                and proc.poll() is not None:
            raise RuntimeError(
                f"successor exited rc={proc.poll()} before ready")
        if time.monotonic() - t0 > wait_s:
            raise TimeoutError(
                f"successor not ready after {wait_s:.0f}s")
        time.sleep(poll_s)
    return time.monotonic() - t0


def _wait_takeover(host: str, port: int, incumbent_id: str,
                   wait_s: float, poll_s: float) -> dict:
    """Poll fresh connections until the successor answers ready."""
    t0 = time.monotonic()
    while True:
        try:
            h = fresh_health(host, port)
            if h.get("server_id") != incumbent_id \
                    and h.get("status") == "ready":
                return h
        except (OSError, ConnectionError, ValueError):
            pass
        if time.monotonic() - t0 > wait_s:
            raise TimeoutError(
                "takeover never completed: fresh connections still "
                "reach the incumbent (or nothing)")
        time.sleep(poll_s)


def run_takeover(host: str, port: int, model: str = "", extra=(),
                 spawn_fn=None, wait_s: float = 180.0,
                 poll_s: float = 0.05, device="cuda") -> dict:
    """Sequence ONE takeover; returns the report dict. ``spawn_fn``
    (ready_file -> handle with .poll(), or None) overrides the
    subprocess successor (on ``device``) for in-process tests."""
    # 1. hold a connection to the incumbent while it is the only
    #    listener — #handoff later rides this connection, immune to
    #    SO_REUSEPORT's fresh-connection hashing
    incumbent = EndpointRpc(host, port)
    try:
        h0 = incumbent.call("#health")
        if not h0.get("takeover"):
            raise SystemExit(
                "incumbent is not running serve_takeover=1 — restart it "
                "once with the knob before zero-downtime handoffs work")
        incumbent_id = h0["server_id"]

        # 2. spawn the successor; it loads + warms, binds the shared
        #    port, then writes its ready file
        fd, ready_file = tempfile.mkstemp(suffix=".ready")
        os.close(fd)
        os.unlink(ready_file)   # the successor's write IS the signal
        proc = (spawn_fn(ready_file) if spawn_fn is not None
                else spawn_successor(model, port, ready_file, extra,
                                     host=host, device=device))
        warm_s = _wait_ready_file(ready_file, proc, wait_s, poll_s)

        # 3. handoff: the incumbent confirms the ready file, drains and
        #    exits; its established connections finish first
        t1 = time.monotonic()
        res = incumbent.call(f"#handoff {ready_file}")

        # 4. fresh connections answer from the successor, ready
        h = _wait_takeover(host, port, incumbent_id, wait_s, poll_s)
        out = {"ok": True, "incumbent": incumbent_id,
               "successor": h["server_id"],
               "model_generation": h.get("model_generation"),
               "warm_s": round(warm_s, 3), "handoff": res,
               "takeover_gap_ms":
                   round((time.monotonic() - t1) * 1e3, 1)}
        if spawn_fn is None:
            out["successor_log"] = ready_file + ".log"
        return out
    finally:
        incumbent.close()
