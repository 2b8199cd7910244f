"""Online continuous learning (counterpart of difacto_tpu/online):
serve → log → train → reload.

The serve path logs served rows with a delayed-label feedback join into
an append-only rec2 segment log (log.py); a tailing trainer drives the
port's SGD learner over each sealed segment with wall-clock verified
checkpoints and ``auto_resume`` recovery (tail.py, trainer.py);
freshness is measured (``train_behind_serve_s``, ``online_rows_behind``,
``serve_generation_age_s``); every committed generation is pushed to the
serving endpoints as ``#reload`` (loop.py). ``task=online``
(__main__.py) is the CLI entry.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from ..config import KWArgs, Param
from .log import OnlineLog, read_index, seg_path
from .loop import push_reload
from .tail import TailReader
from .trainer import OnlineTrainer

log = logging.getLogger("difacto_tpu_torch")


@dataclass
class OnlineParam(Param):
    """task=online knobs, under the JAX CLI's names. Learner knobs (lr,
    model_out, auto_resume, ckpt_keep, mesh_dp, mesh_fs, ...) pass
    through to the SGD learner unchanged, so the online trainer shards
    its table as the offline one does."""
    # the training log directory the serving replicas append to
    online_log_dir: str = ""
    # wall-clock seconds between committed generations (verified
    # checkpoint + reload push); 0 = only the final commit
    online_ckpt_interval_s: float = field(default=5.0, metadata=dict(lo=0))
    # tail poll while waiting on the next seal
    online_poll_s: float = field(default=0.05, metadata=dict(lo=0.001))
    # offline replay of a finished log prefix: stop at the first gap
    # instead of tailing (the trajectory-integrity path)
    online_replay: bool = False
    # exit after this many wall seconds of tailing; 0 = until log.end
    online_max_seconds: float = field(default=0.0, metadata=dict(lo=0))
    # "host:port,host:port" replicas to push #reload to on every
    # committed generation; empty = rely on the replicas' own watchers
    online_endpoints: str = ""


def run_online(kwargs: KWArgs, device="cuda") -> KWArgs:
    """CLI entry for task=online: the tailing trainer over the shared log
    directory on ``device``, run to completion."""
    param, remain = OnlineParam.init_allow_unknown(kwargs)
    if not param.online_log_dir:
        raise ValueError("please set online_log_dir")
    trainer = OnlineTrainer(param, remain, device=device)
    leftover = trainer.leftover
    trainer.run()
    return leftover


__all__ = ["OnlineParam", "run_online", "OnlineTrainer", "OnlineLog",
           "TailReader", "push_reload", "read_index", "seg_path"]
