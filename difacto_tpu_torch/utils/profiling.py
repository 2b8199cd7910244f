"""Profiling: the torch profiler hook of ``DIFACTO_TRACE_DEVICE``
(obs/trace.start_device; counterpart of difacto_tpu/utils/profiling.py):
:func:`start_profiler` starts a ``torch.profiler`` session (CPU
activity, and CUDA activity when a card is there) and
:func:`stop_profiler` exports it as a Chrome trace (open it in Perfetto
or chrome://tracing).
"""

from __future__ import annotations

import os
from typing import Optional


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
