"""Online serving (counterpart of difacto_tpu/serve): a read-only
weights-only store on the card (model.py), the bucketed predict executor
(executor.py), a dynamic micro-batcher (batcher.py), a threaded TCP
front-end (server.py), hot reload with blue/green swaps (reload.py), the
takeover, the health-gated rolling restart and the router group roll
over the wire (fleet.py), the retrying failover client (client.py), the
shared endpoint blacklist (fleethealth.py), the router in front of N
replicas (router.py) and the autoscaler that sizes them
(autoscale.py). ``task=serve`` (__main__.py) is the CLI entry;
``python -m difacto_tpu_torch.tools.fleet`` runs the fleet."""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..config import KWArgs, Param
from ..utils.manifest import CheckpointCorrupt
from .autoscale import Autoscaler
from .batcher import MicroBatcher, ServeStats
from .client import ServeClient
from .executor import PredictExecutor, sigmoid
from .fleet import (HealthGate, drain_endpoint, notify_backends,
                    run_rolling_restart, run_router_group_roll,
                    run_takeover, spawn_router)
from .fleethealth import FleetHealth
from .model import model_meta, open_serving_store, resolve_model_path
from .reload import ModelReloader
from .router import RouterServer
from .server import ServeServer

log = logging.getLogger("difacto_tpu_torch")


@dataclass
class ServeParam(Param):
    """task=serve knobs, under the JAX CLI's names."""
    model_in: str = ""
    serve_host: str = "127.0.0.1"
    serve_port: int = 0                 # 0 = ephemeral, logged at startup
    # flush a micro-batch at this many rows ...
    serve_batch_size: int = field(default=256, metadata=dict(lo=1))
    # ... or when the oldest queued request has waited this long
    serve_max_delay_ms: float = field(default=2.0, metadata=dict(lo=0))
    # admission bound, in ROWS of queued work; beyond it requests shed
    serve_queue_cap: int = field(default=1024, metadata=dict(lo=1))
    # reject single rows wider than this before they reach the executor
    serve_max_row_nnz: int = field(default=4096, metadata=dict(lo=1))
    # throttle for the reporter stats row (seconds)
    serve_report_every: float = 30.0
    # exit after this many seconds; 0 = serve until interrupted
    serve_max_seconds: float = 0.0
    # write "host port\n" here once listening (scripts/tests poll it)
    serve_ready_file: str = ""
    # on SIGTERM/SIGINT: stop accepting, answer new rows "!shed
    # draining", wait this long for admitted work, then exit 0
    serve_drain_timeout_s: float = field(default=10.0, metadata=dict(lo=0))
    # poll model_in every this many seconds and swap a new generation in
    # (0 = off; `#reload` over the wire works either way)
    serve_reload_poll_s: float = field(default=0.0, metadata=dict(lo=0))
    # bind SO_REUSEPORT so a successor process can bind the SAME port
    # while this replica drains (`#handoff`); every replica of a
    # takeover pair needs it, the incumbent included
    serve_takeover: bool = False
    # `#handoff <ready_file>`: wait at most this long for the successor
    serve_handoff_wait_s: float = field(default=30.0, metadata=dict(lo=0))
    # append every served row to this training-log directory (task=online
    # tails it); empty = no logging. One log instance per directory.
    online_log_dir: str = ""
    # rows per sealed rec2 segment
    online_segment_rows: int = field(default=256, metadata=dict(lo=1))
    # how long a served row waits for its delayed label
    label_delay_s: float = field(default=1.0, metadata=dict(lo=0))
    # an unlabeled row past the horizon: dropped, or kept with label 0
    label_default: str = field(default="negative", metadata=dict(
        enum=["drop", "negative"]))
    data_format: str = "libsvm"
    pred_prob: bool = True


def run_serve(kwargs: KWArgs, device="cuda") -> KWArgs:
    """CLI entry for task=serve: open the model read-only on ``device``
    (walking back to the newest generation that verifies), start the
    server with the reloader attached, block. SIGTERM and SIGINT drain
    admitted work and return, so the process exits 0."""
    import signal
    import threading

    param, remain = ServeParam.init_allow_unknown(kwargs)
    if not param.model_in:
        raise ValueError("please set model_in")
    # the store kwargs (updater overrides and serve_mesh_fs) also go to
    # the reloader: a reload rebuilds the same store on the same mesh
    store_kwargs = list(remain)
    store, _, remain = open_serving_store(param.model_in, remain,
                                          device=device)
    online_log = None
    if param.online_log_dir:
        from ..online.log import OnlineLog
        online_log = OnlineLog(param.online_log_dir,
                               segment_rows=param.online_segment_rows,
                               label_delay_s=param.label_delay_s,
                               label_default=param.label_default)
    server = ServeServer(
        store, host=param.serve_host, port=param.serve_port,
        batch_size=param.serve_batch_size,
        max_delay_ms=param.serve_max_delay_ms,
        queue_cap=param.serve_queue_cap,
        pred_prob=param.pred_prob, data_format=param.data_format,
        max_row_nnz=param.serve_max_row_nnz,
        report_every_s=param.serve_report_every,
        drain_timeout_s=param.serve_drain_timeout_s,
        takeover=param.serve_takeover,
        handoff_wait_s=param.serve_handoff_wait_s,
        online_log=online_log)
    server.ready_file = param.serve_ready_file
    reloader = ModelReloader(server.executor, param.model_in,
                             poll_s=param.serve_reload_poll_s,
                             kwargs=store_kwargs, server=server)
    server.reloader = reloader
    # signal.signal works on the main thread only; tests drive run_serve
    # from worker threads and shut it down themselves
    if threading.current_thread() is threading.main_thread():
        def _graceful(signum, _frame):
            log.info("signal %d: draining (timeout %.1fs)", signum,
                     param.serve_drain_timeout_s)
            server.drain()
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
    server.start()
    reloader.start()
    try:
        if param.serve_ready_file:
            from ..utils import stream
            with stream.open_stream(param.serve_ready_file, "w") as f:
                f.write(f"{server.host} {server.port}\n")
        server.wait(param.serve_max_seconds or None)
    finally:
        reloader.close()
        server.close()
        if online_log is not None:
            # flush, not end(): a restarting replica must not end the
            # trainer's tail
            online_log.flush()
        log.info("serve done: %s", server.stats_snapshot())
    return remain


__all__ = ["ServeParam", "run_serve", "ServeServer", "ServeClient",
           "PredictExecutor", "MicroBatcher", "ServeStats", "sigmoid",
           "model_meta", "open_serving_store", "resolve_model_path",
           "ModelReloader", "CheckpointCorrupt", "RouterServer",
           "FleetHealth", "HealthGate", "run_rolling_restart",
           "run_takeover", "Autoscaler", "run_router_group_roll",
           "notify_backends", "spawn_router", "drain_endpoint"]
