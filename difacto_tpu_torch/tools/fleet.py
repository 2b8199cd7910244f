"""Fleet operations CLI of the port: rolling restarts, routers, autoscaling.

The counterpart of the JAX package's ``tools/fleet.py``: the same
subcommands and flags. The replicas it spawns run on the card; pass
``--serve-arg device=cpu`` to spawn them on the CPU.

    python -m difacto_tpu_torch.tools.fleet \
        {roll,route,health,routers,scale} ...

Subcommands over one replica list (``--endpoints h1:p1,h2:p2``):

``roll``
    Health-gated rolling restart (serve/fleet.py): replace
    every replica one at a time — spawn successor on the shared
    SO_REUSEPORT port, wait for its ready file, ``#handoff``, verify —
    polling every replica's ``#health`` before and after each handoff.
    Any regression (not ready, queue-depth blowup, shed-rate spike,
    successor ready timeout) ABORTS the rollout with the current
    incumbent still serving. Prints one JSON report line.

        python -m difacto_tpu_torch.tools.fleet roll \\
            --endpoints 127.0.0.1:9000,127.0.0.1:9001 \\
            --model /models/ctr_v2 --serve-arg serve_batch_size=256

``route``
    Start the thin router process (serve/router.py): speaks
    the same libsvm/control wire protocol, balances rows across the
    replicas with power-of-two-choices over live (in-flight, recent
    latency), retries an unanswered tail on a peer, serves aggregated
    ``#health``/``#stats``/``#metrics`` for the whole fleet, and shares
    endpoint ejections through ``--blacklist``.

        python -m difacto_tpu_torch.tools.fleet route \\
            --endpoints 127.0.0.1:9000,127.0.0.1:9001 \\
            --port 9100 --blacklist /tmp/fleet.blacklist

``health``
    One gate pass over every replica; prints the regression (exit 1) or
    the all-healthy report (exit 0) — the preflight an operator runs
    before trusting a rollout to the gate.

``routers``
    Supervise an N-router SO_REUSEPORT group on ONE advertised port
    (``--port`` required, ``--n`` members): each member is a ``route``
    child with ``--takeover``, sharing ``--blacklist`` and
    ``--endpoints-file``; a member that dies is relaunched with a
    capped-exponential-backoff-plus-jitter schedule (:func:`relaunch_delay`)
    (``router_group_relaunches_total`` counts it, ``router_group_size``
    gauges the live group). Kill any member: the port keeps answering.

        python -m difacto_tpu_torch.tools.fleet routers --n 2 --port 9100 \\
            --endpoints 127.0.0.1:9000,127.0.0.1:9001 \\
            --blacklist /tmp/fleet.blacklist

``scale``
    Run the elastic autoscaler (serve/autoscale.py): a
    hysteresis-damped control loop over the fleet's ``#health`` signals
    that spawns task=serve replicas into the routing ring under load
    (``#backends add`` nudge + ``--endpoints-file`` rewrite) and drains
    them back out when the load leaves.

        python -m difacto_tpu_torch.tools.fleet scale \\
            --endpoints 127.0.0.1:9000 \\
            --model /models/ctr_v2 --router 127.0.0.1:9100 \\
            --min 1 --max 4 --endpoints-file /tmp/fleet.ring
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import time

from ..config import parse_endpoints
from ..obs import REGISTRY
from ..serve.fleet import REPO

# the relaunch schedule of the JAX package's multi-host launcher
RELAUNCH_BACKOFF_CAP_S = 60.0


def relaunch_delay(attempt: int, base_s: float,
                   rng: random.Random = random) -> float:
    """Seconds to wait before relaunch ``attempt`` + 1: exponential in
    the attempt number with full jitter, floored at ``base_s`` and capped
    at :data:`RELAUNCH_BACKOFF_CAP_S`, so restarting members never
    stampede the shared port in lockstep."""
    base = min(base_s * (2 ** attempt), RELAUNCH_BACKOFF_CAP_S)
    return max(base_s, base * (0.5 + rng.random()))


def cmd_roll(args) -> int:
    from ..serve.fleet import HealthGate, run_rolling_restart
    gate = HealthGate(queue_frac=args.queue_frac,
                      shed_spike=args.shed_spike)
    rep = run_rolling_restart(args.endpoints, model=args.model,
                              extra=args.serve_arg, wait_s=args.wait_s,
                              gate=gate)
    print(json.dumps(rep))
    return 0 if rep["ok"] else 1


def cmd_route(args) -> int:
    from ..serve.router import RouterServer
    router = RouterServer(args.endpoints, host=args.host, port=args.port,
                          chunk=args.chunk, retries=args.retries,
                          blacklist=args.blacklist or None,
                          takeover=args.takeover,
                          ready_file=args.ready_file,
                          balance=args.balance,
                          affinity_capacity=args.affinity_capacity,
                          endpoints_file=args.endpoints_file)
    router.start()
    if args.ready_file:
        with open(args.ready_file, "w") as f:
            f.write(f"{router.host} {router.port}\n")
    print(json.dumps({"router": f"{router.host}:{router.port}",
                      "endpoints": args.endpoints}), flush=True)
    try:
        router.wait(args.max_seconds or None)
    except KeyboardInterrupt:  # pragma: no cover - interactive exit
        pass
    finally:
        router.close()
    return 0


def cmd_health(args) -> int:
    from ..serve.fleet import HealthGate, fresh_health
    eps = parse_endpoints(args.endpoints)
    gate = HealthGate(queue_frac=args.queue_frac,
                      shed_spike=args.shed_spike)
    reason = gate.check(eps)
    replicas = []
    for host, port in eps:
        try:
            replicas.append(dict(fresh_health(host, port),
                                 endpoint=f"{host}:{port}"))
        except (OSError, ConnectionError, ValueError) as e:
            replicas.append({"endpoint": f"{host}:{port}",
                             "error": str(e)})
    print(json.dumps({"ok": reason is None, "reason": reason,
                      "replicas": replicas}))
    return 0 if reason is None else 1


def run_router_group(n, cmd_fn, max_seconds=0.0, poll_s=0.5,
                     backoff_base_s=1.0, sleep_fn=None,
                     max_relaunches=None, popen_fn=None):
    """Supervise ``n`` router children of one SO_REUSEPORT group.

    ``cmd_fn(i)`` returns the argv for member ``i``. While the loop
    runs, a member that exits — crash, OOM-kill, operator SIGKILL —
    is relaunched after a capped-exponential-backoff-plus-jitter delay
    (:func:`relaunch_delay`): the attempt counter resets once
    the member is seen alive again, so a flapping member backs off
    while a one-off kill restarts fast. Because every member binds the
    same advertised port, the survivors keep answering the whole time;
    relaunch only restores capacity, never availability.

    Observable: ``router_group_relaunches_total`` counts every
    relaunch, ``router_group_size`` gauges the live member count.
    ``sleep_fn``/``popen_fn`` exist for tests (stub the clock and the
    spawn); ``max_relaunches`` bounds a runaway crash loop (None =
    unlimited). Runs until ``max_seconds`` (0 = until interrupted);
    children are terminated on the way out. Returns a report dict.
    """
    if sleep_fn is None:
        sleep_fn = time.sleep
    if popen_fn is None:
        def popen_fn(argv):
            return subprocess.Popen(argv, cwd=REPO)
    relaunch_c = REGISTRY.counter(
        "router_group_relaunches_total",
        "dead router-group members relaunched by the supervisor")
    size_g = REGISTRY.gauge(
        "router_group_size",
        "live members of the SO_REUSEPORT router group")
    procs = [popen_fn(cmd_fn(i)) for i in range(n)]
    attempts = [0] * n
    relaunches = 0
    t0 = time.monotonic()
    try:
        while True:
            live = 0
            for i in range(n):
                if procs[i].poll() is None:
                    live += 1
                    attempts[i] = 0
                    continue
                if (max_relaunches is not None
                        and relaunches >= max_relaunches):
                    continue
                delay = relaunch_delay(attempts[i], backoff_base_s)
                log_rec = {"event": "router_relaunch", "member": i,
                           "attempt": attempts[i],
                           "delay_s": round(delay, 3),
                           "rc": procs[i].returncode}
                print(json.dumps(log_rec), flush=True)
                sleep_fn(delay)
                procs[i] = popen_fn(cmd_fn(i))
                attempts[i] += 1
                relaunches += 1
                relaunch_c.inc()
            size_g.set(float(live))
            if max_seconds and time.monotonic() - t0 >= max_seconds:
                break
            sleep_fn(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:  # pragma: no cover - already gone
                    pass
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover - stuck
                try:
                    p.kill()
                except OSError:
                    pass
    return {"ok": True, "members": n, "relaunches": relaunches}


def cmd_routers(args) -> int:
    if not args.port:
        print(json.dumps({"ok": False,
                          "reason": "routers needs an explicit --port "
                                    "(the group's one advertised port)"}))
        return 1

    def cmd_fn(i):
        argv = [sys.executable, "-m", "difacto_tpu_torch.tools.fleet",
                "route", "--takeover",
                "--host", args.host, "--port", str(args.port),
                "--endpoints", args.endpoints,
                "--chunk", str(args.chunk),
                "--retries", str(args.retries),
                "--balance", args.balance,
                "--affinity-capacity", str(args.affinity_capacity)]
        if args.blacklist:
            argv += ["--blacklist", args.blacklist]
        if args.endpoints_file:
            argv += ["--endpoints-file", args.endpoints_file]
        if args.max_seconds:
            argv += ["--max-seconds", str(args.max_seconds)]
        return argv

    # SIGTERM ends the supervisor the way ^C does: through
    # run_router_group's finally, which terminates the members
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    rep = run_router_group(args.n, cmd_fn, max_seconds=args.max_seconds,
                           backoff_base_s=args.backoff_s,
                           max_relaunches=args.max_relaunches)
    print(json.dumps(rep))
    return 0 if rep["ok"] else 1


def cmd_scale(args) -> int:
    import socket
    import tempfile

    from ..serve import fleet as fleet_ops
    from ..serve.autoscale import Autoscaler

    def spawn_fn(idx):
        # ephemeral port chosen here (not 0) so the endpoint is known
        # before the child answers; the ready-file wait closes the race
        with socket.socket() as s:
            s.bind((args.spawn_host, 0))
            port = s.getsockname()[1]
        fd, ready = tempfile.mkstemp(suffix=f".scale{idx}.ready")
        os.close(fd)
        os.unlink(ready)
        proc = fleet_ops.spawn_successor(args.model, port, ready,
                                         extra=args.serve_arg,
                                         host=args.spawn_host)
        # raises on child exit or timeout -> the autoscaler counts an
        # abort and keeps measuring (Autoscaler._scale_up)
        fleet_ops._wait_ready_file(ready, proc, args.wait_s, 0.05)
        return (args.spawn_host, port)

    router = None
    if args.router:
        router = parse_endpoints(args.router)[0]
    scaler = Autoscaler(
        args.endpoints, spawn_fn, router=router,
        min_replicas=args.min, max_replicas=args.max,
        poll_s=args.poll_s,
        up_queue_frac=args.up_queue_frac, up_shed_rate=args.up_shed_rate,
        down_queue_frac=args.down_queue_frac,
        up_ticks=args.up_ticks, down_ticks=args.down_ticks,
        cooldown_s=args.cooldown_s,
        endpoints_file=args.endpoints_file)
    try:
        rep = scaler.run(args.max_seconds or None)
    except KeyboardInterrupt:  # pragma: no cover - interactive exit
        rep = {"ok": True, "interrupted": True, "events": scaler.events}
    finally:
        scaler.close()
    print(json.dumps(rep))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--endpoints", required=True,
                        help="replica list, h1:p1,h2:p2")
    common.add_argument("--queue-frac", type=float, default=0.9,
                        help="gate: abort past this fraction of a "
                             "replica's queue_cap")
    common.add_argument("--shed-spike", type=float, default=0.25,
                        help="gate: abort when shed_rate rises this much "
                             "over the rollout-start baseline")

    roll = sub.add_parser("roll", parents=[common],
                          help="health-gated rolling restart")
    roll.add_argument("--model", required=True,
                      help="model_in for the successor processes")
    roll.add_argument("--serve-arg", action="append", default=[],
                      help="extra k=v for successors (repeatable)")
    roll.add_argument("--wait-s", type=float, default=180.0)
    roll.set_defaults(fn=cmd_roll)

    routing = argparse.ArgumentParser(add_help=False)
    routing.add_argument("--host", default="127.0.0.1")
    routing.add_argument("--port", type=int, default=0)
    routing.add_argument("--chunk", type=int, default=64,
                         help="max rows pipelined per backend forward")
    routing.add_argument("--retries", type=int, default=2,
                         help="per-backend retry budget per forward")
    routing.add_argument("--blacklist", default="",
                         help="shared endpoint-health file "
                              "(serve/fleethealth.py)")
    routing.add_argument("--balance", default="p2c",
                         choices=("p2c", "affinity"),
                         help="p2c = power-of-two-choices; affinity = "
                              "consistent-hash rows to the replica whose "
                              "fs-shard owns their keys (p2c fallback "
                              "when the owner is ejected)")
    routing.add_argument("--affinity-capacity", type=int, default=0,
                         help="the model's hash_capacity, so the "
                              "affinity ring mirrors fs_shard_bounds "
                              "(0 = plain key hashing)")
    routing.add_argument("--endpoints-file", default="",
                         help="durable membership: whitespace-separated "
                              "h:p list re-read on (mtime,size) change "
                              "(the autoscaler rewrites it)")
    routing.add_argument("--max-seconds", type=float, default=0.0)

    route = sub.add_parser("route", parents=[common, routing],
                           help="start one router process")
    route.add_argument("--takeover", action="store_true",
                       help="bind SO_REUSEPORT so group members / a "
                            "successor can share the port")
    route.add_argument("--ready-file", default="",
                       help="write 'host port' here once listening")
    route.set_defaults(fn=cmd_route)

    routers = sub.add_parser("routers", parents=[common, routing],
                             help="supervise an N-router SO_REUSEPORT "
                                  "group with relaunch-on-death")
    routers.add_argument("--n", type=int, default=2,
                         help="group size (members on the one port)")
    routers.add_argument("--backoff-s", type=float, default=1.0,
                         help="relaunch backoff base (doubles per "
                              "consecutive death, capped, jittered)")
    routers.add_argument("--max-relaunches", type=int, default=None,
                         help="stop relaunching after this many "
                              "(default: unlimited)")
    routers.set_defaults(fn=cmd_routers)

    scale = sub.add_parser("scale", parents=[common],
                           help="run the elastic autoscaler")
    scale.add_argument("--model", required=True,
                       help="model_in for scale-up replicas")
    scale.add_argument("--serve-arg", action="append", default=[],
                       help="extra k=v for spawned replicas (repeatable)")
    scale.add_argument("--router", default="",
                       help="router h:p to nudge with '#backends "
                            "add|remove' on every decision")
    scale.add_argument("--endpoints-file", default="",
                       help="rewritten atomically on every decision "
                            "(the routers' durable membership)")
    scale.add_argument("--spawn-host", default="127.0.0.1")
    scale.add_argument("--min", type=int, default=1)
    scale.add_argument("--max", type=int, default=8)
    scale.add_argument("--poll-s", type=float, default=0.5)
    scale.add_argument("--up-queue-frac", type=float, default=0.6)
    scale.add_argument("--up-shed-rate", type=float, default=0.02)
    scale.add_argument("--down-queue-frac", type=float, default=0.1)
    scale.add_argument("--up-ticks", type=int, default=2)
    scale.add_argument("--down-ticks", type=int, default=6)
    scale.add_argument("--cooldown-s", type=float, default=5.0)
    scale.add_argument("--wait-s", type=float, default=180.0,
                       help="ready-file wait for a spawned replica")
    scale.add_argument("--max-seconds", type=float, default=0.0)
    scale.set_defaults(fn=cmd_scale)

    health = sub.add_parser("health", parents=[common],
                            help="one gate pass over the fleet")
    health.set_defaults(fn=cmd_health)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
