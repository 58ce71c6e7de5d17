"""SDDMM-style similarity ops and blockwise global top-k.

Port of ``noise_gnn_tpu/ops/sddmm.py``. The similarity matrix ``h @ h.T``
stays implicit: per-edge cosines take E values, and the global top-k runs
over row blocks with a running top-k merge, O(block * N) memory.

Every top-k here is :func:`stable_topk`, which returns what
``jax.lax.top_k`` returns: the k largest values in descending order in the
total order of floats (-0.0 < 0.0), equal values in ascending index order.
The rewiring picks edges by these ranks, and the sampled tree repeats node
ids, so equal similarities are common; ``torch.topk`` promises no order
among them. So the helper ranks a unique int64 key per element: the
float's order-preserving int32 image in the high word and the complement
of its index in the low word.

The similarity products are f32 matmuls. They need
``torch.get_float32_matmul_precision() == 'highest'`` (torch's default; no
TF32) to pick the edges the JAX package picks.
"""

from __future__ import annotations

import torch

_LOW = (1 << 32) - 1


def l2_normalize(h: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt((h * h).sum(dim=-1, keepdim=True))
    return h / n.clamp(min=eps)


def sddmm_cosine(h: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
    """Cosine similarity per edge: sim[e] = <h_norm[src_e], h_norm[dst_e]>."""
    hn = l2_normalize(h)
    return (hn[edge_index[0].long()] * hn[edge_index[1].long()]).sum(dim=-1)


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 image of f32 ``x`` whose integer order is the floats' total
    order (-0.0 below 0.0; XLA's top-k comparison)."""
    b = x.contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices int64) of the ``k`` largest entries of 1-D f32
    ``x``, as ``jax.lax.top_k``: descending, ties in ascending index order."""
    idx = torch.arange(x.shape[0], device=x.device, dtype=torch.int64)
    key = order_key(x).long() * (1 << 32) + (_LOW - idx)
    top = torch.topk(key, k, sorted=True).values
    i = _LOW - (top & _LOW)
    return x[i], i


def _segment_max(segs: torch.Tensor) -> torch.Tensor:
    """Row maxima of [S, seg] f32 in the total order (-0.0 below +0.0, as
    XLA's reduction ranks them; ``amax`` may return either zero), in one
    pass and without a host sync. As int32, a float with the sign bit clear
    orders as the float does, and a negative one orders by its magnitude: so
    a row's maximum is its largest int32 image if that is >= 0, else its
    smallest."""
    lo, hi = torch.aminmax(segs.view(torch.int32), dim=1)
    return torch.where(hi >= 0, hi, lo).view(torch.float32)


def hier_topk(flat: torch.Tensor, k: int, seg: int = 128):
    """Exact top-k of a large 1-D array via a segment-max hierarchy
    (JAX ``ops/sddmm.py::hier_topk``, step for step): per-segment maxima,
    the top-k segments by their maxima, then the top-k of those segments'
    elements laid out segment by segment in that order. Ties therefore go
    to the earlier segment in that layout. Exact: at most k segments can
    hold an element >= the k-th largest. -inf winners (fewer than k real
    entries) may point into the padding; their index is clamped to n - 1."""
    n = flat.shape[0]
    if n <= max(4 * seg, 4 * k):
        return stable_topk(flat, min(k, n))
    pad = (-n) % seg
    if pad:
        flat = torch.cat([flat, torch.full((pad,), float("-inf"), dtype=flat.dtype,
                                           device=flat.device)])
    segs = flat.view(-1, seg)
    _, si = stable_topk(_segment_max(segs), min(k, segs.shape[0]))
    cand = segs[si].reshape(-1)
    vals, ci = stable_topk(cand, min(k, cand.shape[0]))
    idx = si[torch.div(ci, seg, rounding_mode="floor")] * seg + ci % seg
    return vals, idx.clamp(max=n - 1)


def merge_topk(vals, rows, cols, new_vals, new_rows, new_cols, k: int):
    """The running top-k: the k largest of the carry followed by a new
    block (so the carry wins ties)."""
    mv, mi = stable_topk(torch.cat([vals, new_vals]), k)
    return mv, torch.cat([rows, new_rows])[mi], torch.cat([cols, new_cols])[mi]


def blockwise_topk(h_norm: torch.Tensor, k: int, mask_fn, largest: bool = True,
                   block: int = 1024):
    """Top-k entries of (h_norm @ h_norm.T) under a caller-supplied mask.

    mask_fn(row_start, row_ids [B], sim [B, N]) -> sim with excluded entries
    set to -inf (for smallest-k the similarities are negated first).
    Returns (values [k], rows [k], cols [k]) with rows and cols int64."""
    n = h_norm.shape[0]
    block = min(block, n)
    nblocks = -(-n // block)
    hp = torch.nn.functional.pad(h_norm, (0, 0, 0, nblocks * block - n))
    sign = 1.0 if largest else -1.0
    dev = h_norm.device
    vals = torch.full((k,), float("-inf"), dtype=torch.float32, device=dev)
    rows = torch.zeros(k, dtype=torch.int64, device=dev)
    cols = torch.zeros(k, dtype=torch.int64, device=dev)
    for i in range(nblocks):
        row0 = i * block
        sim = (hp[row0:row0 + block] @ h_norm.T).float() * sign
        row_ids = row0 + torch.arange(block, device=dev)
        sim = torch.where((row_ids < n)[:, None], sim, float("-inf"))
        sim = mask_fn(row0, row_ids, sim)
        bv, bc = hier_topk(sim.reshape(-1), k)
        width = sim.shape[1]
        vals, rows, cols = merge_topk(vals, rows, cols, bv,
                                      row0 + torch.div(bc, width, rounding_mode="floor"),
                                      bc % width, k)
    return vals * sign, rows, cols
