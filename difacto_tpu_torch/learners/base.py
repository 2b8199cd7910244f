"""Learner base and factory (counterpart of difacto_tpu/learners/base.py;
include/difacto/learner.h, src/learner.cc): ``init(kwargs) -> run() ->
stop()``, the epoch-end callbacks, and ``Learner.create(name, device)``
over the learners registered with :func:`register` (sgd, bcd, lbfgs).

The SGD learner's callbacks are ``cb(epoch, train_progress,
val_progress)``; the batch learners' are ``cb(epoch, progress)``, as in
the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ..config import KWArgs

_REGISTRY: Dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


class Learner:
    def __init__(self) -> None:
        self.epoch_end_callbacks: List[Callable] = []

    @staticmethod
    def create(name: str, device="cuda") -> "Learner":
        """A new learner of the registered ``name`` on ``device``."""
        from . import bcd, lbfgs, sgd  # noqa: F401  (they register)
        try:
            cls = _REGISTRY[name.lower()]
        except KeyError:
            raise ValueError(
                f"unknown learner {name!r}; have {sorted(_REGISTRY)}")
        return cls(device=device)

    def init(self, kwargs: KWArgs) -> KWArgs:
        raise NotImplementedError

    def run(self) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass

    def add_epoch_end_callback(self, cb: Callable) -> None:
        self.epoch_end_callbacks.append(cb)
