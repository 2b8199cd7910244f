"""Threaded batch prefetcher: overlap host parsing with device compute
(counterpart of difacto_tpu/data/prefetch.py).

The reference's worker hides data loading behind compute with its 3-thread
pipeline and the dmlc ThreadedParser (src/sgd/sgd_learner.h:85-102,
src/reader/reader.h:42-44). Here a producer thread runs the (reader ->
localize -> slot-map) host work while the main thread dispatches device
steps; a bounded queue of ``depth`` items is the analog of the <=2 in-flight
minibatches backpressure (sgd_learner.cc:310-312).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``it`` on a background thread, ``depth`` items ahead.

    Early consumer exit (break / close) sets a stop flag the producer checks
    on every put, so teardown is O(depth), not O(remaining items).
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    err = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            _put(_DONE)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            yield item
    finally:
        stop.set()
        t.join()
    if err:
        raise err[0]
