"""Build a C++ or CUDA source of the port into a plain-C shared library at
first use.

Each kernel of the port (``csrc/*.cu``) is compiled by ``nvcc`` for
``sm_90a``, and the host graph runtime (``csrc/graph_runtime.cpp``) by
``g++``, into ``build/kernels/`` at the repo root; each is loaded with
``ctypes`` by its wrapper module. Nothing here runs at import time, so the
port imports without ``nvcc``, ``g++`` or a card.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc(src: Path) -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {src} is built at first use and "
                           "needs the CUDA toolkit")
    return nvcc


def _host_cpu() -> str:
    """The host CPU's feature flags (Linux) or its architecture: a library
    built with ``-march=native`` is only reused on a CPU that has them."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), platform.machine())
    except OSError:
        return platform.machine()


def _compile(compiler: str, flags: list[str], src: Path, name: str, key: str = "") -> Path:
    """Compile ``src`` unless this exact source is built already, and return
    the library's path. The file name carries a hash of the source, the
    compiler, its flags and ``key``, so an edited source is rebuilt; the
    library is written under a temporary name and renamed into place, under
    a file lock, so concurrent callers build it once. A failed build raises
    with the compiler's error output."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join([compiler, *flags, key]).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one builder at a time per library; the others wait and reuse its
    # result (the lock is the open file's, released if the process dies)
    with open(BUILD_DIR / f"{lib.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            try:
                res = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                                     capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"cannot run {compiler!r} to build {src}: {e}") from e
            if res.returncode != 0:
                raise RuntimeError(f"{compiler} failed on {src}:\n{res.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib


def build_library(src: Path, name: str) -> Path:
    """Build a CUDA source with ``nvcc`` for ``sm_90a``."""
    return _compile(_nvcc(src), NVCC_FLAGS, src, name)


def build_host_library(src: Path, name: str, cxx: str, flags: list[str]) -> Path:
    """Build a C++ source with the host compiler ``cxx``; the hash also
    carries the host CPU's features (``flags`` may hold ``-march=native``)."""
    return _compile(cxx, flags, src, name, key=_host_cpu())
