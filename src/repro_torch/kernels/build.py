"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C entry point.  :func:`load`
compiles it with ``nvcc`` for Hopper (``sm_90a``) into a shared library on
first use and opens it with :mod:`ctypes` — no PyTorch headers, so a build
takes seconds.  The library's file name carries a hash of its source and
of every shared header ``csrc/*.cuh`` it may include, so an edited kernel
or header is rebuilt and a stale library is never loaded.  Nothing is
compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..compat import build_dir

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC))

_LOADED: dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels of repro_torch are built from source on first use")


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The shared library built from ``csrc/<name>.cu`` with the macros
    ``defines`` (content-addressed: the hash covers the source, every
    ``csrc/*.cuh`` and the macros)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for macro in defines:
        h.update(f"-D{macro}".encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def compile_library(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` with ``-D`` for each of ``defines``
    unless its library is already built."""
    out = library_path(name, defines)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{m}" for m in defines), "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built with the macros
    ``defines``), built on first use."""
    with _LOCK:
        lib = _LOADED.get((name, defines))
        if lib is None:
            lib = ctypes.CDLL(str(compile_library(name, defines)))
            _LOADED[(name, defines)] = lib
        return lib


OCCUPANCY_KEYS = ("registers", "local_bytes", "shared_bytes",
                  "blocks_per_sm", "threads")


def occupancy(fn, *args: int) -> dict:
    """What a kernel occupies on the current card, from a library's
    ``<name>_occupancy(..., int out[5])`` entry point (the CUDA runtime's
    ``cudaFuncGetAttributes`` and occupancy calculator): registers and
    local (spilled) bytes a thread, dynamic shared memory and threads a
    block, and blocks an SM holds."""
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    rc = fn(*args, out)
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY_KEYS, out))
