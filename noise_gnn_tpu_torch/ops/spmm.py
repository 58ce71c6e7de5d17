"""CSR SpMM: ``out[v] = scale(v) * sum_{u in N_in(v)} x[u]``.

The hand-written CUDA kernel (``csrc/spmm.cu``) that replaces the Pallas TPU
kernel ``noise_gnn_tpu/ops/pallas_spmm.py:147`` (``_reduce_kernel_chunked``,
with the XLA gather around it), and its plain PyTorch version.

* :class:`Spmm` — pack once (device CSR), apply often: ``mean`` or sum,
  fp32 accumulation, f32 or bf16 input and output. On a CUDA tensor it
  launches the kernel (or raises); on a CPU tensor it runs
  :func:`spmm_reference`. Forward only, under ``no_grad``: the SpMM serves
  the exact-leaf table and full-graph eval, never a training backward.
* :func:`spmm_reference` — the plain version: an edge-chunked ``index_add_``
  that never holds more than a bounded ``[chunk, F]`` slab of messages.

The kernel is memory-bound on the H100; see the note at the top of
``csrc/spmm.cu``. The library is compiled with ``nvcc`` into a plain-C shared
object at first use (``ops/cuda_build.py``) and loaded with ``ctypes``;
importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import collections
import ctypes
from pathlib import Path

import torch

from .cuda_build import CSRC, build_library

_SRC = CSRC / "spmm.cu"

# Kernel launches by feature width, counted where the wrapper launches the
# kernel and nowhere else (the plain version never counts). A run resets it
# with ``launch_counts.clear()`` and reads it afterwards to show that its
# path went through the kernel.
launch_counts: collections.Counter = collections.Counter()

# rows of [E, F] messages the plain version gathers at once (~512 MB fp32)
_SLAB_ELEMS = 1 << 27

_lib = None


def build() -> Path:
    """Compile ``csrc/spmm.cu`` unless it is built already; the library's path."""
    return build_library(_SRC, "ngt_spmm")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.ngt_spmm_csr.argtypes = [vp, vp, vp, vp, i64, i64, i32, i32, i32, i32, vp]
        lib.ngt_spmm_csr.restype = ctypes.c_int
        _lib = lib
    return _lib


_DTYPES = (torch.float32, torch.bfloat16)


def spmm_reference(indptr: torch.Tensor, indices: torch.Tensor, x: torch.Tensor,
                   mean: bool = True, out_dtype: torch.dtype | None = None,
                   slab_elems: int = _SLAB_ELEMS) -> torch.Tensor:
    """Plain PyTorch SpMM with the kernel's semantics: fp32 sums over each
    row's in-edges, times ``1/max(deg, 1)`` (an f32 reciprocal, as the
    kernel and the Pallas pack compute it) for mean, cast to ``out_dtype``.
    Edges are processed in chunks of at most ``slab_elems // F`` rows."""
    n = indptr.shape[0] - 1
    f = x.shape[1]
    out_dtype = out_dtype or x.dtype
    acc = torch.zeros((n, f), dtype=torch.float32, device=x.device)
    e = int(indices.shape[0])
    chunk = max(slab_elems // max(f, 1), 1)
    for lo in range(0, e, chunk):
        k = torch.arange(lo, min(lo + chunk, e), device=x.device, dtype=torch.int64)
        dst = torch.searchsorted(indptr, k, right=True) - 1
        acc.index_add_(0, dst, x[indices[lo:lo + chunk].long()].float())
    if mean:
        deg = (indptr[1:] - indptr[:-1]).clamp(min=1).float()
        acc *= (1.0 / deg)[:, None]
    return acc.to(out_dtype)


class Spmm:
    """Pack-once/apply-often CSR SpMM over a fixed destination-major graph.

    ``indptr`` [N+1] and ``indices`` [E] (sources of each destination row,
    in [0, N)) live on the device the operator runs on; ``x`` is [N, F]. A
    CPU operator runs the plain version; a CUDA operator launches the
    kernel and counts the launch in ``launch_counts``.
    """

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor):
        if indptr.device != indices.device:
            raise ValueError("indptr and indices must be on one device")
        self.indptr = indptr.to(torch.int64).contiguous()
        self.indices = indices.to(torch.int32).contiguous()
        self.num_rows = int(self.indptr.shape[0]) - 1
        if self.indices.numel():
            lo, hi = int(self.indices.min()), int(self.indices.max())
            if lo < 0 or hi >= self.num_rows:
                raise ValueError(f"indices span [{lo}, {hi}], outside "
                                 f"[0, {self.num_rows})")
        self.device = self.indices.device

    @classmethod
    def from_csr(cls, csr) -> "Spmm":
        return cls(csr.indptr, csr.indices)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, mean: bool = True,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
        out_dtype = out_dtype or x.dtype
        if x.dim() != 2 or x.shape[0] != self.num_rows:
            raise ValueError(f"x must be [{self.num_rows}, F], got {tuple(x.shape)}")
        if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
            raise TypeError(f"dtypes must be float32 or bfloat16, got "
                            f"{x.dtype} -> {out_dtype}")
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on {self.device}")
        if x.device.type == "cpu":
            return spmm_reference(self.indptr, self.indices, x, mean, out_dtype)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        return self._launch(x, mean, out_dtype)

    def _launch(self, x: torch.Tensor, mean: bool, out_dtype: torch.dtype) -> torch.Tensor:
        lib = _load()
        f = int(x.shape[1])
        out = torch.empty((self.num_rows, f), dtype=out_dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ngt_spmm_csr(
            self.indptr.data_ptr(), self.indices.data_ptr(), x.data_ptr(),
            out.data_ptr(), self.num_rows, f, int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), int(bool(mean)),
            x.device.index if x.device.index is not None else torch.cuda.current_device(),
            stream,
        )
        if err != 0:
            raise RuntimeError(f"spmm_csr kernel launch failed: cudaError {err}")
        launch_counts[f] += 1
        return out
