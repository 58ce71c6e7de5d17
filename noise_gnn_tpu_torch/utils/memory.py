"""Host-memory mitigation for slow-first-touch environments.

Port of ``noise_gnn_tpu/utils/memory.py`` (its ``configure_malloc`` and
``warm_heap``). Some sandboxed or ballooned VMs serve fresh anonymous pages
slowly, and glibc munmaps large buffers on free, so every big numpy
temporary pays the page faults again. (1) ``mallopt`` keeps large
allocations on the reusable heap instead of fresh mmaps; (2) ``warm_heap``
optionally pre-faults an arena once so later allocations reuse warm pages.
Both are no-ops where glibc's ``mallopt`` is missing. The JAX package's
``configure_jax_cache`` (the XLA compile cache) has no counterpart: the
port's compiled code is its kernel build cache, ``build/kernels/``.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_configured = False


def configure_malloc(mmap_threshold: int = 1 << 31) -> bool:
    """Keep large allocations on the reusable sbrk heap (``mallopt``);
    returns whether both settings took."""
    global _configured
    if _configured:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, ctypes.c_int(mmap_threshold))
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, ctypes.c_int(-1))
        _configured = bool(ok1 and ok2)
    except (OSError, AttributeError):
        _configured = False
    return _configured


def warm_heap(n_bytes: int) -> None:
    """Pre-fault an arena of ``n_bytes`` so later allocations reuse warm
    pages (after :func:`configure_malloc`, or the arena is unmapped on free
    and the warming is lost)."""
    if n_bytes <= 0:
        return
    configure_malloc()
    arena = np.empty(n_bytes // 8, np.float64)
    arena[::512] = 0.0  # touch one word per 4 KB page
    del arena
