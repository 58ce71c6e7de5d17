"""ctypes bindings of the port's host graph runtime (``csrc/graph_runtime.cpp``).

Port of ``noise_gnn_tpu/native/__init__.py``, with the same entry points
and signatures:

  coo_to_csr(src, dst, n)              -> (indptr int64 [n+1], indices int32 [e])
  expand_rows(indptr, n)               -> dst int32 [e] (per-edge CSR row)
  sample_hop(indptr, indices, frontier, fanout, seed, frontier_mask=None)
                                       -> (children int32, mask bool) host fanout sample
  hash_i32(arr)                        -> FNV-1a checksum
  label_prop(src, dst, n, d, part, iters, sticky)
                                       -> part int32 [n] (shard locality)

The library is built with ``g++`` at first use into ``build/kernels/``
(``ops/cuda_build.py``). There is no fallback: where the build fails, every
entry point raises with the compiler's output. The numpy versions below
(``*_reference``) are the plain versions the tests hold the native ones
against; the port's own code never calls them.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops.cuda_build import CSRC, build_host_library

CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread"]
SOURCE = CSRC / "graph_runtime.cpp"

_LIB = None


def build():
    """Compile the runtime (unless built already) and return its path."""
    return build_host_library(SOURCE, "ngt_graph", CXX, CXX_FLAGS)


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ngt_coo_to_csr.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32, i64p, i32p]
    lib.ngt_expand_rows.argtypes = [i64p, ctypes.c_int32, i32p]
    lib.ngt_sample_hop.argtypes = [i64p, i32p, i32p, u8p, ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_uint64, i32p, u8p]
    lib.ngt_hash_i32.argtypes = [i32p, ctypes.c_int64]
    lib.ngt_hash_i32.restype = ctypes.c_uint64
    lib.ngt_label_prop.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_float, i32p]
    _LIB = lib
    return lib


def _p(arr, ct):
    return arr.ctypes.data_as(ctypes.POINTER(ct))


def _check_ids(name: str, ids: np.ndarray, n: int) -> None:
    """The C code indexes with these ids unchecked: they must lie in [0, n)."""
    if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise ValueError(f"{name} ids span [{ids.min()}, {ids.max()}], outside [0, {n})")


def coo_to_csr(src: np.ndarray, dst: np.ndarray, n: int):
    """Destination-major CSR of a COO edge list by a counting sort: each
    row keeps its sources in edge-list order."""
    lib = _lib()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be one [E] shape")
    _check_ids("dst", dst, n)
    indptr = np.zeros(n + 1, np.int64)
    indices = np.zeros(src.shape[0], np.int32)
    lib.ngt_coo_to_csr(_p(src, ctypes.c_int32), _p(dst, ctypes.c_int32), src.shape[0], n,
                       _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int32))
    return indptr, indices


def expand_rows(indptr: np.ndarray, n: int) -> np.ndarray:
    """The per-edge dst row of a dst-major CSR."""
    lib = _lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    if indptr.shape != (n + 1,):
        raise ValueError(f"indptr is {indptr.shape}, expected ({n + 1},)")
    dst = np.zeros(int(indptr[-1]), np.int32)
    lib.ngt_expand_rows(_p(indptr, ctypes.c_int64), n, _p(dst, ctypes.c_int32))
    return dst


def sample_hop(indptr: np.ndarray, indices: np.ndarray, frontier: np.ndarray,
               fanout: int, seed: int, frontier_mask: np.ndarray | None = None):
    """``fanout`` in-neighbours of every frontier node on the host, with the
    device sampler's policy (all of them where deg <= fanout, else i.i.d.
    picks from a per-node ``mt19937_64`` stream keyed by ``seed``)."""
    lib = _lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    frontier = np.ascontiguousarray(frontier, np.int32)
    _check_ids("frontier", frontier, indptr.shape[0] - 1)
    nf = frontier.shape[0]
    children = np.zeros(nf * fanout, np.int32)
    mask = np.zeros(nf * fanout, np.uint8)
    fm = None if frontier_mask is None else np.ascontiguousarray(frontier_mask, np.uint8)
    if fm is not None and fm.shape != (nf,):
        raise ValueError(f"frontier_mask is {fm.shape}, expected ({nf},)")
    lib.ngt_sample_hop(_p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int32),
                       _p(frontier, ctypes.c_int32),
                       None if fm is None else _p(fm, ctypes.c_uint8), nf, fanout, seed,
                       _p(children, ctypes.c_int32), _p(mask, ctypes.c_uint8))
    return children, mask.astype(bool)


def hash_i32(arr: np.ndarray) -> int:
    """FNV-1a checksum of an int32 buffer."""
    lib = _lib()
    arr = np.ascontiguousarray(arr, np.int32)
    return int(lib.ngt_hash_i32(_p(arr, ctypes.c_int32), arr.shape[0]))


def label_prop(src: np.ndarray, dst: np.ndarray, n: int, d: int, part: np.ndarray,
               iters: int = 8, sticky: float = 1.1) -> np.ndarray:
    """Balanced label propagation of ``part`` [n] over ``d`` shards; mutates
    ``part`` where it is already contiguous int32, and returns the result."""
    lib = _lib()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    part = np.ascontiguousarray(part, np.int32)
    _check_ids("src", src, n)
    _check_ids("dst", dst, n)
    if part.shape != (n,):
        raise ValueError(f"part is {part.shape}, expected ({n},)")
    _check_ids("part", part, d)
    lib.ngt_label_prop(_p(src, ctypes.c_int32), _p(dst, ctypes.c_int32), src.shape[0], n, d,
                       iters, ctypes.c_float(sticky), _p(part, ctypes.c_int32))
    return part


# ------------------------------------------------------- plain versions


def coo_to_csr_reference(src: np.ndarray, dst: np.ndarray, n: int):
    """:func:`coo_to_csr` in numpy: a stable sort by dst."""
    dst = np.asarray(dst)
    order = np.argsort(dst, kind="stable")
    indices = np.asarray(src)[order].astype(np.int32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    return indptr, indices


def expand_rows_reference(indptr: np.ndarray, n: int) -> np.ndarray:
    """:func:`expand_rows` in numpy."""
    indptr = np.asarray(indptr, np.int64)
    return np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))


def hash_i32_reference(arr: np.ndarray) -> int:
    """:func:`hash_i32` in Python."""
    h = 1469598103934665603
    for v in np.asarray(arr, np.int32).astype(np.uint32).tolist():
        h = ((h ^ int(v)) * 1099511628211) % (1 << 64)
    return h
