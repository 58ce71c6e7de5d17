"""Segment reductions and edge-list message passing as plain torch ops.

Port of ``noise_gnn_tpu/ops/scatter.py``. ``edge_index`` is [2, E] (row 0 =
source, row 1 = destination); masked edges are routed to a dead row
``num_nodes`` that is sliced off. Accumulation is fp32 regardless of input
dtype. The JAX module's ``fast_take`` (a TPU gather workaround) is one
``torch.index_select`` here. Large graphs (E * F above ~128 M elements) accumulate over
edge chunks so the [E, F] message matrix never materializes.

On a CUDA tensor ``index_add_`` (and so the backward of ``index_select``)
adds repeated ids with float atomics, in an order that changes from run to
run. :func:`segment_sum` does not use it: the ids are stable-sorted and each
run of equal ids is summed in its original order, which is also the order
of the CPU's ``index_add_``, so on the CPU the numbers do not change.
:func:`fast_take` takes that path for its backward whenever the source
requires grad.
"""

from __future__ import annotations

import torch

_CHUNK_THRESHOLD_ELEMS = 1 << 27
_EDGE_CHUNK = 1 << 21


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _routed(edge_index, edge_mask, num_nodes):
    src, dst = edge_index[0].long(), edge_index[1].long()
    if edge_mask is not None:
        dst = torch.where(edge_mask, dst, torch.full_like(dst, num_nodes))
    return src, dst


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets in a fixed order on
    every device: stable-sort the ids, then sum each run of equal ids in its
    original order (``torch.segment_reduce`` adds a segment's rows one after
    another). fp32 accumulation, result in ``data``'s dtype; no host sync.
    Ids must lie in [0, num_segments)."""
    ids = segment_ids.reshape(-1).long()
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 1, device=ids.device, dtype=ids.dtype))
    rows = data.reshape(ids.shape[0], *data.shape[segment_ids.dim():])
    out = torch.segment_reduce(rows.to(_acc_dtype(data.dtype))[order], "sum",
                               lengths=bounds[1:] - bounds[:-1], axis=0, unsafe=True)
    return out.to(data.dtype)


class _SortedTake(torch.autograd.Function):
    """``index_select`` along axis 0 whose backward adds the rows of the
    gradient into the source's rows with :func:`segment_sum`."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = x.shape[0]
        return torch.index_select(x, 0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return segment_sum(grad, idx, ctx.num_rows), None


def fast_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``x[idx]`` along axis 0, for an index tensor of any shape. When
    ``x`` requires grad, the backward is a :func:`segment_sum`."""
    flat = idx.reshape(-1)
    if x.requires_grad and torch.is_grad_enabled():
        rows = _SortedTake.apply(x, flat)
    else:
        rows = torch.index_select(x, 0, flat)
    return rows.reshape(*idx.shape, *x.shape[1:])


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Number of (valid) entries per segment, f32 [num_segments]. The sums
    are of ones, exact in any order, so they are the same on every run."""
    ones = torch.ones(segment_ids.shape, dtype=torch.float32, device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, 0.0)
    out = torch.zeros(num_segments, dtype=torch.float32, device=segment_ids.device)
    return out.index_add_(0, segment_ids.long(), ones)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of the (valid) ``data`` rows per segment, 0 for an empty one (PyG
    semantics): the :func:`segment_sum` of the rows, rounded to their dtype,
    over the count, in fp32."""
    if mask is not None:
        data = torch.where(mask[:, None], data, torch.zeros_like(data))
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments, mask)
    return (total.float() / count.clamp(min=1.0)[:, None]).to(data.dtype)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Max of the (valid) ``data`` rows per segment, 0 for an empty one (and
    wherever the max is not finite, as the JAX package's)."""
    if mask is not None:
        data = torch.where(mask[:, None], data, torch.full_like(data, float("-inf")))
    ids = segment_ids.long().reshape(-1, *[1] * (data.dim() - 1)).expand_as(data)
    out = torch.full((num_segments, *data.shape[1:]), float("-inf"), dtype=data.dtype,
                     device=data.device)
    out.scatter_reduce_(0, ids, data, reduce="amax")
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def edge_chunk(num_edges: int, width: int) -> int:
    """Edges a gather-scatter takes at once: all of them, unless their
    [E, F] messages would pass ~128 M elements (then ``_EDGE_CHUNK``)."""
    if num_edges * width > _CHUNK_THRESHOLD_ELEMS:
        return _EDGE_CHUNK
    return max(num_edges, 1)


def _scatter_sum_f32(x, src, dst, num_nodes):
    """[num_nodes + 1, F] fp32 sums (last row = dead segment), chunked over
    edges when the message matrix would be large."""
    acc = torch.zeros((num_nodes + 1, x.shape[1]), dtype=_acc_dtype(x.dtype),
                      device=x.device)
    e = src.shape[0]
    chunk = edge_chunk(e, x.shape[1])
    for lo in range(0, e, chunk):
        acc.index_add_(0, dst[lo:lo + chunk], x[src[lo:lo + chunk]].to(acc.dtype))
    return acc


def gather_scatter_sum(x, edge_index, num_nodes: int, edge_mask=None) -> torch.Tensor:
    """out[i] = sum_{(j -> i) in E} x[j]."""
    src, dst = _routed(edge_index, edge_mask, num_nodes)
    return _scatter_sum_f32(x, src, dst, num_nodes)[:num_nodes].to(x.dtype)


def gather_scatter_mean(x, edge_index, num_nodes: int, edge_mask=None) -> torch.Tensor:
    """out[i] = mean_{(j -> i) in E} x[j]; 0 for isolated nodes."""
    src, dst = _routed(edge_index, edge_mask, num_nodes)
    total = _scatter_sum_f32(x, src, dst, num_nodes)[:num_nodes]
    if total.dtype != x.dtype:
        # the JAX path rounds the sum to the input dtype before dividing
        total = total.to(x.dtype)
    count = segment_count(dst, num_nodes + 1)[:num_nodes]
    return (total.float() / count.clamp(min=1.0)[:, None]).to(x.dtype)


def gather_scatter_max(x, edge_index, num_nodes: int, edge_mask=None) -> torch.Tensor:
    """out[i] = max_{(j -> i) in E} x[j]; 0 for isolated nodes (PyG
    MaxAggregation semantics behind SAGEConv(aggr='max'))."""
    src, dst = _routed(edge_index, edge_mask, num_nodes)
    acc = torch.full((num_nodes + 1, x.shape[1]), float("-inf"), dtype=x.dtype,
                     device=x.device)
    e = src.shape[0]
    chunk = edge_chunk(e, x.shape[1])
    for lo in range(0, e, chunk):
        d = dst[lo:lo + chunk][:, None].expand(-1, x.shape[1])
        acc.scatter_reduce_(0, d, x[src[lo:lo + chunk]], reduce="amax")
    out = acc[:num_nodes]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def degree(edge_index, num_nodes: int, edge_mask=None, axis: int = 1) -> torch.Tensor:
    """In-degree (axis=1, default) or out-degree (axis=0) per node."""
    ids = edge_index[axis].long()
    if edge_mask is not None:
        ids = torch.where(edge_mask, ids, torch.full_like(ids, num_nodes))
    return segment_count(ids, num_nodes + 1)[:num_nodes]
