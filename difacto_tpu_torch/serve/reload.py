"""Serve hot reload (counterpart of difacto_tpu/serve/reload.py): pick up
a newly trained model without a restart.

- a **watcher** thread polls the model path every ``poll_s`` seconds
  (manifest generation first, mtime/size for files without a manifest)
  and reloads when the fingerprint moves; a new mtime under the old
  generation is a save in progress and is ignored;
- ``#reload [path]`` triggers the same reload on the requesting
  connection's reader thread, so scoring never waits behind a load;
- a reload opens the model weights-only through
  ``open_serving_store(fallback=False)`` (full manifest verification, no
  walk-back), then swaps it in atomically
  (``PredictExecutor.swap_store``); a failed or corrupt load keeps the
  old model serving and counts ``reload_failures``;
- a **geometry change** (``V_dim``, ``hash_capacity`` or ``slot_dtype``)
  with a server attached runs the **blue/green** swap: a second
  executor over the new store, seeded with the live executor's sticky
  caps and warmed on every recorded bucket (``warm_workers`` threads;
  ``reload.warm`` is a fault point in the loop), then the server's
  executor and its batcher's ``predict_fn`` are retargeted.
  ``swap_state`` (idle/warming/swapping) rides ``#health`` and
  ``#stats``; ``last_warm_ms`` is the warm's wall time.

On the card the new table is built on a side stream, so its 2 GiB of
copies and row packing never queue in front of the batcher's predicts on
the default stream. The reloading thread waits for that stream before the
swap, and every tensor of the new table is marked as used on the default
stream (``record_stream``): when a later reload drops it, the caching
allocator does not hand its blocks back to the side stream while a
predict may still read them.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Tuple

from ..utils import faultinject, stream
from ..utils.locktrace import mutex

log = logging.getLogger("difacto_tpu_torch")


def _open_on_side_stream(target: str, kwargs, device):
    """``open_serving_store(fallback=False)`` with its device work on side
    streams (the current stream on the CPU): one on every visible card,
    since a sharded table may put its key-range shards on any of them;
    returns once the new table is complete on every card."""
    import contextlib

    import torch

    from .model import open_serving_store
    if device.type != "cuda":
        return open_serving_store(target, kwargs, fallback=False,
                                  device=device)
    sides = [torch.cuda.Stream(device=torch.device("cuda", i))
             for i in range(torch.cuda.device_count())]
    with contextlib.ExitStack() as stack:
        for side in sides:
            stack.enter_context(torch.cuda.stream(side))
        # entering a stream makes its card current: the store's own
        # device is current while it is built
        stack.enter_context(torch.cuda.device(device))
        out = open_serving_store(target, kwargs, fallback=False,
                                 device=device)
    for side in sides:
        side.synchronize()
    for t in out[0].state:
        if t.is_cuda:
            t.record_stream(torch.cuda.default_stream(t.device))
    return out


class ModelReloader:
    def __init__(self, executor, model_uri: str, poll_s: float = 0.0,
                 kwargs=(), server=None, warm_workers: int = 4):
        # server=None: same-geometry swaps only (no batcher to retarget).
        # With a server the live executor is read through it, and this
        # one is not held: a blue/green swap must free blue's table
        self._executor = executor if server is None else None
        self._server = server
        self.model_uri = model_uri
        self.poll_s = poll_s
        self._kwargs = list(kwargs)
        self.warm_workers = warm_workers
        self.reloads = 0
        self.reload_failures = 0
        self.bluegreen_swaps = 0
        self.last_warm_ms = 0.0              # wall cost of the last warm
        self.swap_state = "idle"             # idle | warming | swapping
        self._reload_mu = mutex()            # serialize reloads
        self._stats_mu = mutex()             # the counters and state above
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cur = self._fingerprint()

    @property
    def executor(self):
        """The LIVE executor: read through the server when attached, since
        a blue/green swap replaces the server's executor object."""
        return (self._server.executor if self._server is not None
                else self._executor)

    # ------------------------------------------------------------ watch
    def _fingerprint(self) -> Optional[Tuple]:
        """(path, manifest generation, mtime, size) of the model file;
        None while unresolvable."""
        from ..utils import manifest as mft
        from .model import resolve_model_path
        try:
            path = resolve_model_path(self.model_uri)
            man = mft.read(path)
            gen = man.get("generation") if man else None
            return (path, gen, stream.getmtime(path), stream.getsize(path))
        except (FileNotFoundError, OSError, mft.CheckpointCorrupt):
            return None

    def start(self) -> "ModelReloader":
        if self.poll_s > 0 and self._thread is None:
            self._thread = threading.Thread(target=self._watch,
                                            name="serve-reload-watch",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _changed(self, fp: Optional[Tuple]) -> bool:
        """With manifest generations on both sides only a generation move
        counts: the npz lands before its manifest, so a new mtime under
        the old generation is a save in progress."""
        if fp is None or fp == self._cur:
            return False
        if self._cur is None:
            return True
        if fp[1] is not None and self._cur[1] is not None:
            return fp[0] != self._cur[0] or fp[1] != self._cur[1]
        return True

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            fp = self._fingerprint()
            if self._changed(fp):
                log.info("model watcher: %s changed (generation %s); "
                         "reloading", fp[0], fp[1])
                self.reload()

    # ----------------------------------------------------------- reload
    def reload(self, path: Optional[str] = None) -> dict:
        """Load + verify + swap, synchronously on the calling thread.
        Returns {'ok', 'model_generation', 'path'} or {'ok': False,
        'error'}; the old model keeps serving on any failure."""
        from ..obs import counter
        from .model import store_geometry
        target = path or self.model_uri
        with self._reload_mu:
            fp = self._fingerprint() if path is None else None
            try:
                blue = self.executor
                # the load holds _reload_mu on purpose (one reload at a
                # time); its only sleep is a ckpt.read delay_ms, the chaos
                # stand-in for a slow read, which holds it as a real one
                # lint: ok(lock-blocking) fault-injection delay only
                store, meta, _ = _open_on_side_stream(
                    target, self._kwargs, blue.store.device)
                if (store_geometry(store.param)
                        != store_geometry(blue.store.param)
                        and self._server is not None):
                    # the warm holds _reload_mu on purpose (one reload at a
                    # time); its one sleep is reload.warm's delay_ms chaos
                    # kind, which stretches exactly this window
                    # lint: ok(lock-blocking) fault-injection delay only
                    gen = self._bluegreen_swap(blue, store)
                else:
                    gen = blue.swap_store(store)
            except Exception as e:  # boundary: keep the current model
                with self._stats_mu:
                    self.reload_failures += 1
                counter("model_reload_failures_total",
                        "failed hot-reloads (old model kept)").inc()
                log.warning("model reload from %s failed; keeping the "
                            "current model: %s", target, e)
                return {"ok": False, "error": str(e)}
            with self._stats_mu:
                self.reloads += 1
            counter("model_reloads_total",
                    "successful model hot-reloads").inc()
            if fp is not None:
                self._cur = fp
            log.info("model reloaded from %s: generation %d",
                     meta["path"], gen)
            return {"ok": True, "model_generation": gen,
                    "path": meta["path"]}

    # ------------------------------------------------------- blue/green
    def _bluegreen_swap(self, blue, store) -> int:
        """Geometry-changing swap on the reloading thread: build and warm
        a green executor, then retarget the server. Any failure (an
        injected ``reload.warm`` fault included) propagates to the reload
        failure path: green is dropped, blue keeps serving."""
        from concurrent.futures import ThreadPoolExecutor

        from .executor import PredictExecutor
        self._set_state("warming")
        try:
            caps, keys = blue.warm_set()
            workers = max(1, min(self.warm_workers, len(keys) or 1))
            log.info("blue/green: warming %d buckets on %d threads for "
                     "geometry (V_dim=%d, hash_capacity=%d)", len(keys),
                     workers, store.param.V_dim,
                     store.param.hash_capacity)
            green = PredictExecutor(store)
            green.seed_caps(caps)

            def _warm_one(key):
                faultinject.fire("reload.warm")
                green.warm_bucket(key)

            t0 = time.monotonic()
            if workers == 1:
                for key in keys:
                    _warm_one(key)
            else:
                with ThreadPoolExecutor(
                        max_workers=workers,
                        thread_name_prefix="bluegreen-warm") as pool:
                    for _ in pool.map(_warm_one, keys):
                        pass
            with self._stats_mu:
                self.last_warm_ms = (time.monotonic() - t0) * 1e3
                self.swap_state = "swapping"
            green.generation = blue.generation + 1
            self._server.swap_executor(green)
            with self._stats_mu:
                self.bluegreen_swaps += 1
            self._server.obs.counter(
                "serve_bluegreen_swaps_total",
                "geometry-changing blue/green executor swaps").inc()
            log.info("blue/green: swapped to generation %d (%d buckets "
                     "warm)", green.generation, len(keys))
            return green.generation
        finally:
            self._set_state("idle")

    # ------------------------------------------------------------ stats
    def _set_state(self, state: str) -> None:
        with self._stats_mu:
            self.swap_state = state

    def stats(self) -> dict:
        """The reload counters for ``#stats``/``#health``, under their own
        lock: never blocked by a reload holding ``_reload_mu``."""
        with self._stats_mu:
            return {"reloads": self.reloads,
                    "reload_failures": self.reload_failures,
                    "bluegreen_swaps": self.bluegreen_swaps,
                    "last_warm_ms": round(self.last_warm_ms, 3),
                    "swap_state": self.swap_state}
