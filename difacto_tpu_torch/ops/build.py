"""Build the port's CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

A kernel source under ``ops/csrc/`` is compiled for ``sm_90a`` at its
first use, into ``difacto_tpu_torch/_build/`` (ignored by git). A library
is named by the content hash of its source and flags, so an edited source
rebuilds and an unchanged one is reused. Each library has its own lock,
so threads that ask for different kernels build them at the same time.
Nothing here runs at import
time: the CPU-only test environment has no ``nvcc`` and imports every
module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from ..utils.locktrace import mutex

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = mutex()                          # guards _locks
_locks: Dict[str, object] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels build at first use")
    return path


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{h[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, spills) of the build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if it is not on
    disk yet."""
    lib = _libs.get(name)
    if lib is not None:        # built and loaded: no lock on the hot path
        return lib
    with _lock:
        lock = _locks.setdefault(name, mutex())
    with lock:
        if name not in _libs:
            out = library_path(name)
            if not out.exists():
                _build(name, out)
            _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]


def _build(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    log = compile_source(CSRC_DIR / f"{name}.cu", tmp)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def compile_source(src: Path, out: Path) -> str:
    """nvcc ``src`` into the shared library ``out``; returns nvcc's output
    (``-Xptxas -v``) and raises when the build fails."""
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(out),
                           str(src)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src} (exit "
                           f"{proc.returncode}):\n{proc.stdout[-4000:]}")
    return proc.stdout
