"""Loop orchestrator: trainer generations → fleet reloads (counterpart
of difacto_tpu/online/loop.py).

Each generation the online trainer commits (online/trainer.py
``_save_checkpoint``) is pushed to the serve fleet over the existing
``#reload`` control line (serve/reload.py handles verification,
blue/green swaps, and typed walk-back on a pruned/torn generation).
Pushes are best-effort per endpoint: a replica that is down, draining,
or mid-rotation is logged and skipped — its own reload watcher
(``serve_reload_poll_s``) or the next push catches it up. The loop
therefore never blocks training on a slow or dead replica.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from ..obs import counter
from ..serve.fleet import EndpointRpc

log = logging.getLogger("difacto_tpu_torch")

_c_pushes = counter(
    "online_reload_pushes_total",
    "per-endpoint #reload pushes attempted by the online loop")


def push_reload(endpoints: List[Tuple[str, int]], model_path: str,
                timeout: float = 10.0) -> Dict[str, int]:
    """Push ``#reload <model_path>`` to every endpoint. Returns
    ``{"ok": n, "failed": n}``; failures are logged, never raised —
    the incumbent model keeps serving on a failed replica (the
    reloader's contract) and training never stalls on the fleet."""
    ok = failed = 0
    for host, port in endpoints:
        _c_pushes.inc()
        try:
            rpc = EndpointRpc(host, port, timeout=timeout)
            try:
                out = rpc.call("#reload " + model_path)
            finally:
                rpc.close()
        except (OSError, ValueError) as e:
            # ConnectionError (incl. the !err reply path) is an OSError
            failed += 1
            log.warning("reload push to %s:%d failed: %s", host, port, e)
            continue
        if out.get("ok", False):
            ok += 1
            log.info("reload push to %s:%d -> generation %s", host, port,
                     out.get("model_generation"))
        else:
            # typed reloader walk-back (e.g. the generation was pruned
            # between the save and this push): old model keeps serving,
            # the next committed generation catches the replica up
            failed += 1
            log.warning("reload push to %s:%d rejected: %s", host, port,
                        out.get("error"))
    return {"ok": ok, "failed": failed}
