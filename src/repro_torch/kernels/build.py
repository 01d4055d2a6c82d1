"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``src/repro_torch/csrc/`` exposes a plain C
interface and is compiled by ``nvcc`` into its own shared library, which
is loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds).  Libraries are built at first use into ``build/kernels/`` at the
root of the checkout, under a name keyed by a hash of the source, the
``csrc/`` headers it includes (``#include "x.cuh"``, followed through the
headers) and the flags, so an edited source or header rebuilds and an
unchanged one is reused.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then
under ``/usr/local/cuda``; a machine without it raises with a message
saying so.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["REPO_ROOT", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "sources", "library_path", "build", "load"]

REPO_ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
# one lock per kernel, so that different kernels build in parallel
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 = reused)
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    cands: List[str] = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(str(Path(home) / "bin" / "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are built from src/repro_torch/csrc at "
        "first use and need the CUDA toolkit"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header, in the order first met."""
    seen = [CSRC / f"{name}.cu"]
    for path in seen:  # grows while it is walked
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.is_file() and dep not in seen:
                seen.append(dep)
    return seen


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: named by a hash of the
    source, its headers and the flags."""
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in sources(name)) + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source,
    its headers and the flag set already exists; returns the library path."""
    src = CSRC / f"{name}.cu"
    lib = library_path(name)
    if lib.exists():
        build_seconds.setdefault(name, 0.0)
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - t0
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            name_lock = _name_locks.setdefault(name, threading.Lock())
        with name_lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name)))
                _libs[name] = lib
    return lib
