"""Gather-ring probe: per-block gathers through a ring of in-flight copies.

The hand-written CUDA kernel (``csrc/gather_ring.cu``) that replaces the
Pallas TPU kernel ``tools/exp_dma_gather.py:56`` (``make().kernel``), and its
plain PyTorch version.

``x3`` is ``[n_blocks, 8, F]`` f32 (a row table viewed as aligned 8-row
blocks) and ``idx`` ``[E]`` int32 block ids, ``E`` a multiple of ``chunk``.
Grid step ``(p, c)``, ``p < passes``, ``c < E / chunk``, copies the blocks
``x3[idx[c * chunk + i]]``, ``i < chunk``, in order into slot ``i % depth`` of
a ring of ``depth`` blocks. The result is every step's final ring,
``[passes, E / chunk, depth, 8, F]``: slot ``s`` of step ``(p, c)`` holds
``x3[idx[c * chunk + i_s]]``, with ``i_s`` the largest ``i < chunk`` such that
``i = s (mod depth)``. ``out[-1, -1, 0]`` is the ``[8, F]`` block the TPU
kernel returns.

* :func:`gather_ring` launches the kernel on a CUDA tensor (and counts the
  launch in ``launch_counts``) and raises on any other device, the CPU
  included: it is a probe of the card's gather throughput, which a plain
  version on the host would not measure. The kernel runs the grid
  chunk-major in thread-block clusters of ``C`` consecutive passes of one
  chunk, which share every block copy by TMA multicast
  (:func:`block_coords` mirrors its index arithmetic); :func:`cluster_size`
  is the one rule that picks ``C``, and :func:`plan` applies it on the card.
* :func:`gather_ring_reference` makes the same ``passes * E`` copies with
  one plain ``index_select`` and keeps each slot's last, on any device; the
  tests and ``chip_smoke.py`` hold the kernel against it.

The library is built by ``nvcc`` at first use (``ops/cuda_build.py``) and
loaded with ``ctypes``; importing this module needs neither ``nvcc`` nor a
card.
"""

from __future__ import annotations

import collections
import ctypes
import weakref
from pathlib import Path

import torch

from .cuda_build import CSRC, build_library

_SRC = CSRC / "gather_ring.cu"
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
CLUSTER_SIZES = (8, 4, 2, 1)  # clusters of 16 measured slower than 8

# Kernel launches by ring depth, counted where the wrapper launches the
# kernel and nowhere else (the plain version never counts).
launch_counts: collections.Counter = collections.Counter()

_lib = None
_plans: dict = {}
# The last ids found in range: (weak reference, version, data_ptr, numel,
# n_blocks). The range check syncs with the host, so an unchanged tensor is
# checked once; an in-place change bumps its version and is checked again.
_checked: tuple | None = None


def build() -> Path:
    """Compile ``csrc/gather_ring.cu`` unless it is built already; the library's path."""
    return build_library(_SRC, "ngt_gather_ring")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ngt_gather_ring.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
        lib.ngt_gather_ring.restype = ctypes.c_int
        lib.ngt_gather_ring_smem.argtypes = [i32, i32, i32, i32]
        lib.ngt_gather_ring_smem.restype = ctypes.c_longlong
        lib.ngt_gather_ring_active_clusters.argtypes = [i32, i32, i32, i32, i32]
        lib.ngt_gather_ring_active_clusters.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x3: torch.Tensor, idx: torch.Tensor, depth: int, chunk: int, passes: int) -> int:
    """Validate the arguments; returns the number of chunks."""
    if x3.dim() != 3 or x3.shape[1] != 8 or x3.dtype != torch.float32:
        raise ValueError(f"x3 must be [n_blocks, 8, F] float32, got "
                         f"{tuple(x3.shape)} {x3.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be [E] int32, got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != x3.device:
        raise ValueError(f"idx is on {idx.device}, x3 on {x3.device}")
    if not 1 <= depth <= chunk:
        raise ValueError(f"need 1 <= depth <= chunk, got depth {depth}, chunk {chunk}")
    if passes < 1 or idx.shape[0] == 0 or idx.shape[0] % chunk:
        raise ValueError(f"E = {idx.shape[0]} must be a positive multiple of chunk "
                         f"{chunk}, passes {passes} >= 1")
    return idx.shape[0] // chunk


def _check_range(idx: torch.Tensor, n_blocks: int) -> None:
    """Raise unless every id is in ``[0, n_blocks)``; skips the check (and
    its host sync) for the same tensor, unchanged, as last time."""
    global _checked
    key = (idx._version, idx.data_ptr(), idx.numel(), n_blocks)
    if _checked is not None and _checked[0]() is idx and _checked[1:] == key:
        return
    if bool(((idx < 0) | (idx >= n_blocks)).any()):
        raise ValueError(f"idx outside [0, {n_blocks})")
    _checked = (weakref.ref(idx), *key)


def last_positions(depth: int, chunk: int) -> list[int]:
    """``i_s`` for each slot ``s``: the last index of a chunk copied into it."""
    return [s + (chunk - 1 - s) // depth * depth for s in range(depth)]


def cluster_size(passes: int, blocks: int, resident) -> int:
    """The rule that picks the cluster size ``C`` for a grid of ``blocks``
    blocks, ``passes`` of each chunk; ``resident(C)`` is how many blocks in
    clusters of ``C`` the card holds at once (0 if one does not fit).

    C = 1 if the whole grid is resident at once without clusters: every
    chunk's passes then run side by side and share L2 already, and a cluster
    would only add its handshake to each of a block's chunk / depth ring
    rounds. Otherwise the largest ``C`` of ``CLUSTER_SIZES`` that divides
    ``passes`` and of which one cluster fits. 0 if none does."""
    if resident(1) >= blocks:
        return 1
    return next((c for c in CLUSTER_SIZES if passes % c == 0 and resident(c) >= c), 0)


def block_coords(passes: int, nchunks: int, csize: int) -> list[tuple[int, int, int]]:
    """The kernel's grid, block by block: ``(p, c, rank)`` of block ``b``
    in a chunk-major grid of clusters of ``csize`` blocks (``b % passes``,
    ``b // passes``, ``b % csize``), as ``csrc/gather_ring.cu`` computes
    them."""
    return [(b % passes, b // passes, b % csize) for b in range(passes * nchunks)]


def plan(depth: int, chunk: int, f: int, passes: int, nchunks: int,
         device: torch.device) -> tuple[int, int]:
    """``(C, clusters of C resident at once)`` for these shapes on
    ``device``: :func:`cluster_size` on ``cudaOccupancyMaxActiveClusters``;
    remembered per shape. Raises if no block of this ring fits in shared
    memory."""
    dev = device.index if device.index is not None else torch.cuda.current_device()
    key = (dev, depth, chunk, f, passes, nchunks)
    if key not in _plans:
        lib = _load()
        active = {}

        def resident(c: int) -> int:
            if lib.ngt_gather_ring_smem(chunk, depth, f, c) > SMEM_LIMIT:
                active[c] = 0
            else:
                n = lib.ngt_gather_ring_active_clusters(chunk, depth, f, c, dev)
                if n < 0:
                    raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError {-n}")
                active[c] = n
            return active[c] * c

        c = cluster_size(passes, passes * nchunks, resident)
        if c == 0:
            smem = lib.ngt_gather_ring_smem(chunk, depth, f, 1)
            raise ValueError(f"depth {depth} x [8, {f}] blocks + {chunk} indices need {smem} "
                             f"bytes of shared memory, above the {SMEM_LIMIT} a block may use")
        _plans[key] = (c, active[c])
    return _plans[key]


def gather_ring_reference(x3: torch.Tensor, idx: torch.Tensor, depth: int, chunk: int,
                          passes: int) -> torch.Tensor:
    """Plain version: the final rings ``[passes, E / chunk, depth, 8, F]``.
    Like the kernel it makes every one of the ``passes * E`` copies (one
    ``index_select``), then keeps each slot's last."""
    nchunks = _check(x3, idx, depth, chunk, passes)
    copies = torch.index_select(x3, 0, idx.repeat(passes))
    pos = torch.tensor(last_positions(depth, chunk), device=idx.device)
    return copies.view(passes, nchunks, chunk, *x3.shape[1:])[:, :, pos].contiguous()


def gather_ring(x3: torch.Tensor, idx: torch.Tensor, depth: int, chunk: int,
                passes: int) -> torch.Tensor:
    """The probe's kernel on CUDA tensors; raises on any other device.
    Returns the final rings ``[passes, E / chunk, depth, 8, F]``."""
    nchunks = _check(x3, idx, depth, chunk, passes)
    if x3.device.type != "cuda":
        raise ValueError(f"gather_ring runs on a CUDA card only, got {x3.device}; "
                         "gather_ring_reference is its plain version")
    if not (x3.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x3 and idx must be contiguous")
    if x3.data_ptr() % 16:
        raise ValueError("x3 must be 16-byte aligned (TMA bulk copies)")
    _check_range(idx, int(x3.shape[0]))
    f = int(x3.shape[2])
    csize, _ = plan(depth, chunk, f, passes, nchunks, x3.device)
    out = torch.empty((passes, nchunks, depth, 8, f), dtype=torch.float32, device=x3.device)
    dev = x3.device.index if x3.device.index is not None else torch.cuda.current_device()
    err = _load().ngt_gather_ring(x3.data_ptr(), idx.data_ptr(), out.data_ptr(), passes,
                                  nchunks, chunk, depth, f, csize, dev,
                                  torch.cuda.current_stream(x3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_ring kernel launch failed: cudaError {err}")
    launch_counts[depth] += 1
    return out
