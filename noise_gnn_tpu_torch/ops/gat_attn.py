"""CSR graph attention, GATConv's aggregation, forward only:

    out[v, h] = sum_{u in N_in(v)} a[v, u, h] x[u, h],
    a[v, :, h] = softmax_u(LeakyReLU_0.2(s_src[u, h] + s_dst[v, h]))

per head h over the columns ``h * C : (h + 1) * C`` of ``x`` [N, H * C],
with the scores ``s_src``/``s_dst`` [N, H] float32 (each node's projected
features against the layer's ``att_src``/``att_dst``, ``models/layers.py::
gat_scores``). PyG's ``GATConv`` (heads, no attention dropout) aggregates so
over ``N_in(v)`` with its self-loops removed and one added; the callers
hand this module such a CSR, built once per graph by :func:`self_loop_csr`.

* :class:`GatAttn` — pack once (device CSR and, on the card, the SpMM's
  edge-balanced segment schedule, ``ops/spmm.py::segment_schedule``), apply
  often. On a CUDA tensor it launches the hand-written kernel
  (``csrc/gat_attn.cu``) or raises; on a CPU tensor it runs
  :func:`gat_attn_reference`. It serves the full-graph eval, under
  ``no_grad``: no ``[E, H, C]`` message buffer exists on the card, where
  products' pair eval would need 64.3 M x 1024 x 2 B = 132 GB for one.
* :func:`gat_attn_reference` — the plain version, a scatter softmax and a
  weighted ``index_add_`` over chunks of edges, in float32.

This kernel replaces no TPU kernel: the JAX package has no multi-head GAT.
It was added because products cannot be evaluated by a GAT without it; the
note at the top of ``csrc/gat_attn.cu`` says what bounds it and what its
design does about that. Built by ``nvcc`` into a plain-C library at first
use (``ops/cuda_build.py``) and loaded with ``ctypes``.
"""

from __future__ import annotations

import collections
import ctypes
from pathlib import Path

import torch

from .cuda_build import CSRC, build_library
from .spmm import segment_schedule

_SRC = CSRC / "gat_attn.cu"

NEGATIVE_SLOPE = 0.2  # GATConv's LeakyReLU on the scores
MAX_HEADS = 16  # the kernel keeps each head's max and sum in registers

# Kernel launches by row width, counted where the wrapper launches the
# kernel and nowhere else (the plain version never counts).
launch_counts: collections.Counter = collections.Counter()

# [chunk, W] messages the plain version holds at once (~512 MB fp32)
_SLAB_ELEMS = 1 << 27

_lib = None


def build() -> Path:
    """Compile ``csrc/gat_attn.cu`` unless it is built already; the library's path."""
    return build_library(_SRC, "ngt_gat_attn")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ngt_gat_attn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i64, vp, vp, i64, vp, vp,
                                     vp, i64, i32, i32, ctypes.c_float, i32, vp]
        lib.ngt_gat_attn.restype = ctypes.c_int
        _lib = lib
    return _lib


def self_loop_csr(indptr: torch.Tensor, indices: torch.Tensor):
    """(indptr, indices) of the same in-neighbour CSR with every existing
    self-loop removed and one added per row, first in its row (so every
    row has an edge and its first score is its own), the other edges in
    their order. Torch ops on the CSR's device, once per graph."""
    dev = indptr.device
    n = int(indptr.shape[0]) - 1
    deg = indptr[1:] - indptr[:-1]
    row = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    keep = indices.long() != row
    kept = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, row, keep.long())
    new_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    new_ptr[1:] = torch.cumsum(kept + 1, 0)
    # a kept edge's place: its row's start, after the self-loop, then its
    # rank among the row's kept edges
    rank = torch.cumsum(keep.long(), 0) - 1 - (torch.cumsum(kept, 0) - kept)[row]
    out = torch.empty(int(new_ptr[-1]), dtype=indices.dtype, device=dev)
    out[new_ptr[:-1]] = torch.arange(n, device=dev, dtype=indices.dtype)
    out[(new_ptr[:-1][row] + 1 + rank)[keep]] = indices[keep]
    return new_ptr, out


def _check_scores(h: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor) -> int:
    if h.dim() != 2 or s_src.dim() != 2 or s_src.shape != s_dst.shape:
        raise ValueError(f"h must be [N, W] and the scores [N, H], got {tuple(h.shape)}, "
                         f"{tuple(s_src.shape)}, {tuple(s_dst.shape)}")
    heads = int(s_src.shape[1])
    if heads < 1 or h.shape[1] % heads or s_src.shape[0] != h.shape[0]:
        raise ValueError(f"{heads} heads do not divide h's {h.shape[1]} columns over "
                         f"{h.shape[0]} rows")
    return heads


def gat_attn_reference(indptr: torch.Tensor, indices: torch.Tensor, h: torch.Tensor,
                       s_src: torch.Tensor, s_dst: torch.Tensor,
                       slab_elems: int = _SLAB_ELEMS) -> torch.Tensor:
    """The plain version of the kernel over a CSR (row v lists the sources
    of its in-edges): each head's scatter softmax of the edges' scores over
    their destination, then the weighted sum of the sources' rows, in
    float32 over chunks of edges, cast to h's dtype. A row without edges
    gives 0."""
    heads = _check_scores(h, s_src, s_dst)
    n, w = int(indptr.shape[0]) - 1, h.shape[1]
    c = w // heads
    src = indices.long()
    dst = torch.repeat_interleave(torch.arange(n, device=indptr.device), indptr[1:] - indptr[:-1])
    e = torch.nn.functional.leaky_relu(s_src.float()[src] + s_dst.float()[dst], NEGATIVE_SLOPE)
    m = torch.full((n, heads), float("-inf"), device=h.device)
    m = m.scatter_reduce(0, dst[:, None].expand(-1, heads), e, "amax")
    p = torch.exp(e - m[dst])
    den = torch.zeros((n, heads), device=h.device).index_add_(0, dst, p)
    acc = torch.zeros((n, w), device=h.device)
    chunk = max(slab_elems // max(w, 1), 1)
    for lo in range(0, int(src.shape[0]), chunk):
        hi = lo + chunk
        msg = h[src[lo:hi]].float().view(-1, heads, c) * p[lo:hi, :, None]
        acc.index_add_(0, dst[lo:hi], msg.view(-1, w))
    den = den.clamp(min=torch.finfo(torch.float32).tiny).repeat_interleave(c, dim=1)
    return (acc / den).to(h.dtype)


class GatAttn:
    """Pack-once/apply-often attention over a fixed destination-major CSR
    (GATConv's: :func:`self_loop_csr`; a row without edges gives 0). ``h``
    [N, W] (float32 or bfloat16), ``s_src`` and ``s_dst`` [N, H] float32;
    the result is [N, W] in h's dtype. A CPU
    operator runs the plain version; a CUDA operator launches the kernel
    and counts the launch in ``launch_counts``. A CUDA operator builds its
    segment schedule here, once, on the card."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor):
        if indptr.device != indices.device:
            raise ValueError("indptr and indices must be on one device")
        self.indptr = indptr.to(torch.int64).contiguous()
        self.indices = indices.to(torch.int32).contiguous()
        self.num_rows = int(self.indptr.shape[0]) - 1
        self.device = self.indices.device
        self.schedule = self.seg_row = None
        if self.device.type == "cuda":
            self.schedule = segment_schedule(self.indptr)
            # each segment's destination row, split rows' segments included
            self.seg_row = (torch.searchsorted(self.indptr[1:], self.schedule.seg_start,
                                               right=True)).to(torch.int32)

    @classmethod
    def self_looped(cls, csr) -> "GatAttn":
        return cls(*self_loop_csr(csr.indptr, csr.indices))

    @torch.no_grad()
    def __call__(self, h: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor) -> torch.Tensor:
        heads = _check_scores(h, s_src, s_dst)
        if h.shape[0] != self.num_rows:
            raise ValueError(f"h must be [{self.num_rows}, W], got {tuple(h.shape)}")
        if h.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
        if s_src.dtype != torch.float32 or s_dst.dtype != torch.float32:
            raise TypeError("the scores must be float32")
        if {h.device, s_src.device, s_dst.device} != {self.device}:
            raise ValueError(f"h and the scores must be on the operator's {self.device}")
        if h.device.type == "cpu":
            return gat_attn_reference(self.indptr, self.indices, h, s_src, s_dst)
        if h.device.type != "cuda":
            raise ValueError(f"unsupported device {h.device}")
        if heads > MAX_HEADS:
            raise ValueError(f"the kernel takes at most {MAX_HEADS} heads, got {heads}")
        if not (h.is_contiguous() and s_src.is_contiguous() and s_dst.is_contiguous()):
            raise ValueError("h and the scores must be contiguous")
        return self._launch(h, s_src, s_dst, heads)

    def _launch(self, h, s_src, s_dst, heads: int) -> torch.Tensor:
        lib = _load()
        w = int(h.shape[1])
        sch = self.schedule
        out = torch.empty_like(h)
        partial = torch.empty((sch.num_partials, w), dtype=torch.float32, device=h.device)
        part_ml = torch.empty((sch.num_partials, 2 * heads), dtype=torch.float32,
                              device=h.device)
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.ngt_gat_attn(
            self.indices.data_ptr(), h.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            sch.seg_start.data_ptr(), sch.seg_len.data_ptr(), sch.seg_dst.data_ptr(),
            self.seg_row.data_ptr(), int(sch.seg_len.shape[0]), sch.comb_row.data_ptr(),
            sch.comb_ptr.data_ptr(), int(sch.comb_row.shape[0]), partial.data_ptr(),
            part_ml.data_ptr(), out.data_ptr(), w, heads, int(h.dtype == torch.bfloat16),
            NEGATIVE_SLOPE,
            h.device.index if h.device.index is not None else torch.cuda.current_device(),
            stream,
        )
        if err != 0:
            raise RuntimeError(f"gat_attn kernel launch failed: cudaError {err}")
        launch_counts[w] += 1
        return out
