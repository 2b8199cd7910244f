"""Profiling: wall-clock section timers and the torch profiler hook
(counterpart of difacto_tpu/utils/profiling.py).

- :class:`Timer` — named cumulative wall-clock sections (host side);
- :func:`device_trace` — a context manager around a ``torch.profiler``
  session (CPU activity, and CUDA activity when a card is there) that
  exports a Chrome trace into ``log_dir`` (open it in Perfetto or
  chrome://tracing). A diagnostic, never on the main path: a profiler
  that fails to start is logged and the body runs unprofiled.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

log = logging.getLogger("difacto_tpu_torch")


class Timer:
    """Cumulative named sections: ``with timer("pull"): ...``; report()."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> str:
        rows = sorted(self.total.items(), key=lambda kv: -kv[1])
        return "\n".join(
            f"{name:24s} {tot:8.3f}s  x{self.count[name]}"
            for name, tot in rows)


def start_profiler(cuda: Optional[bool] = None):
    """A started ``torch.profiler.profile`` session: CPU activity, and
    CUDA activity when ``cuda`` (default: a card is visible)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_profiler(prof, log_dir: str) -> str:
    """Stop ``prof`` and export its Chrome trace as
    ``<log_dir>/trace-<pid>.json``; returns the path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: Optional[bool] = None
                 ) -> Iterator[None]:
    """Profile the body into ``log_dir``. Profiling failures never break
    the run they observe."""
    prof = None
    try:
        prof = start_profiler(cuda)
    except Exception as e:  # pragma: no cover - backend-dependent
        log.warning("device trace unavailable: %s", e)
    try:
        yield
    finally:
        if prof is not None:
            try:
                stop_profiler(prof, log_dir)
            except Exception as e:  # pragma: no cover
                log.warning("device trace export failed: %s", e)
