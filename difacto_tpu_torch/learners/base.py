"""Learner base (counterpart of difacto_tpu/learners/base.py;
include/difacto/learner.h): ``init(kwargs) -> run() -> stop()``, plus the
epoch-end callbacks ``cb(epoch, train_progress, val_progress)``."""

from __future__ import annotations

from typing import Callable, List

from ..config import KWArgs
from ..utils.progress import Progress

EpochCallback = Callable[[int, Progress, Progress], None]


class Learner:
    def __init__(self) -> None:
        self.epoch_end_callbacks: List[EpochCallback] = []

    def init(self, kwargs: KWArgs) -> KWArgs:
        raise NotImplementedError

    def run(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass

    def add_epoch_end_callback(self, cb: EpochCallback) -> None:
        self.epoch_end_callbacks.append(cb)
