"""Zero-downtime replica takeover: spawn -> warm -> handoff -> exit
(counterpart of the JAX package's ``tools/takeover.py``).

The incumbent keeps serving on its port while a successor process of the
port binds the SAME port (both run ``serve_takeover=1``), loads and warms
its model (on the card unless ``--serve-arg device=cpu``), and writes
its ready file; then the incumbent is told ``#handoff <ready_file>`` and
drains — established connections finish on the incumbent, new
connections land on the successor.

    python -m difacto_tpu_torch.tools.takeover --host 127.0.0.1 \\
        --port 9000 --model /models/ctr --serve-arg serve_batch_size=256

Prints one JSON line: incumbent/successor ids, the successor's warm time
and ``takeover_gap_ms`` (handoff to the first fresh connection answered
ready by the successor). The sequencing is
``difacto_tpu_torch.serve.fleet.run_takeover``; ``python -m
difacto_tpu_torch.tools.fleet roll`` repeats it over a replica list.
"""

from __future__ import annotations

import argparse
import json

from ..serve.fleet import EndpointRpc, run_takeover, spawn_successor

__all__ = ["run_takeover", "spawn_successor", "EndpointRpc", "main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--model", required=True,
                    help="model_in for the successor process")
    ap.add_argument("--serve-arg", action="append", default=[],
                    help="extra k=v for the successor (repeatable)")
    ap.add_argument("--wait-s", type=float, default=180.0)
    args = ap.parse_args(argv)
    print(json.dumps(run_takeover(args.host, args.port, args.model,
                                  extra=args.serve_arg,
                                  wait_s=args.wait_s)))


if __name__ == "__main__":
    main()
