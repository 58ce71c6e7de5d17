"""Build a CUDA source of the port into a plain-C shared library at first use.

Each kernel of the port (``csrc/*.cu``) is compiled by ``nvcc`` for
``sm_90a`` into ``build/kernels/`` at the repo root and loaded with
``ctypes`` by its wrapper module. Nothing here runs at import time, so the
port imports without ``nvcc`` or a card.
"""

from __future__ import annotations

import hashlib
import os
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


def build_library(src: Path, name: str) -> Path:
    """Compile ``src`` unless this exact source is built already, and return
    the library's path. The file name carries a hash of the source and the
    flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(src), *NVCC_FLAGS, "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
        os.replace(tmp, lib)  # atomic: concurrent builds race harmlessly
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib
