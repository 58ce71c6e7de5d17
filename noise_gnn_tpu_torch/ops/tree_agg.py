"""Scatter-free aggregation over flat k-hop-tree subgraphs.

Port of ``noise_gnn_tpu/ops/tree_agg.py``. The CTP step (and later the
TE/TES/H steps) runs the conv stack on the sampled tree's flat subgraph view
(``ops/sampler.py``: seeds first, then each depth's children contiguously).
Its structural edge list is regular: the children of parent ``j`` at depth
``d`` occupy one contiguous fanout-sized slot. So a segment reduction over
those edges is a reshape and a masked reduction, and the reverse direction
(each node's out-neighbour, its parent) is a repeat.

:class:`TreeTopo` is the edge-structure argument the conv layers accept in
place of a ``[2, E]`` edge list, with the same numbers as the edge-list path
on ``TreeBatch.flat_edges()``.

A rewired graph (``augment/rewire.py::topk_rewire_tree``) is the structural
edges with a keep-mask (removals) plus a small list of extra edges
(additions). The extras go through :func:`~.scatter.segment_sum`,
so their sums, and the gradients of their gathers, come out the same on
every run of the card.
"""

from __future__ import annotations

import torch

from .scatter import fast_take, segment_count, segment_sum


class TreeTopo:
    """Flat-tree subgraph topology: the structural child -> parent edges of
    ``flat_edge_index(batch_size, fanouts)`` masked by ``edge_mask``, plus
    the ``extra_src -> extra_dst`` edges masked by ``extra_mask``."""

    def __init__(self, batch_size: int, fanouts: tuple[int, ...], edge_mask: torch.Tensor,
                 extra_src: torch.Tensor | None = None, extra_dst: torch.Tensor | None = None,
                 extra_mask: torch.Tensor | None = None):
        self.batch_size = int(batch_size)
        self.fanouts = tuple(int(f) for f in fanouts)
        self.edge_mask = edge_mask
        self.extra_src = extra_src
        self.extra_dst = extra_dst
        self.extra_mask = extra_mask

    @property
    def sizes(self) -> list[int]:
        s = [self.batch_size]
        for f in self.fanouts:
            s.append(s[-1] * f)
        return s

    @property
    def bases(self) -> list[int]:
        b, acc = [], 0
        for s in self.sizes:
            b.append(acc)
            acc += s
        return b

    @property
    def num_nodes(self) -> int:
        return sum(self.sizes)

    def parent_of(self, flat_ids: torch.Tensor) -> torch.Tensor:
        """Structural parent of each flat node id (seeds map to themselves)."""
        sizes, bases = self.sizes, self.bases
        parent = flat_ids
        for d, f in enumerate(self.fanouts):
            j = flat_ids - bases[d + 1]
            in_depth = (j >= 0) & (j < sizes[d + 1])
            parent = torch.where(in_depth, bases[d] + torch.div(j, f, rounding_mode="floor"),
                                 parent)
        return parent

    def _routed(self, ids: torch.Tensor) -> torch.Tensor:
        """``ids`` with the masked extra edges sent to the dead row n."""
        if self.extra_mask is None:
            return ids
        return torch.where(self.extra_mask, ids, torch.full_like(ids, self.num_nodes))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def tree_gather_scatter(x: torch.Tensor, topo: TreeTopo, aggr: str = "mean") -> torch.Tensor:
    """out[i] = aggr over the in-neighbours (children and extras) of flat
    node i; 0 for nodes without one. The same numbers as
    ``gather_scatter_<aggr>(x, edge_index, n, edge_mask)`` on the equivalent
    edge list, with no scatter."""
    sizes, bases = topo.sizes, topo.bases
    f_dim = x.shape[-1]
    acc = _acc_dtype(x.dtype)
    neg = torch.tensor(float("-inf"), dtype=acc, device=x.device)
    sums, counts = [], []
    off = 0
    for d, f in enumerate(topo.fanouts):
        n_child = sizes[d + 1]
        cb = x[bases[d + 1]:bases[d + 1] + n_child].reshape(sizes[d], f, f_dim).to(acc)
        mm = topo.edge_mask[off:off + n_child].reshape(sizes[d], f)
        off += n_child
        if aggr == "max":
            sums.append(torch.where(mm[..., None], cb, neg).amax(dim=1))
        else:
            sums.append((cb * mm.to(acc)[..., None]).sum(dim=1))
        counts.append(mm.sum(dim=1).float())
    # the deepest depth has no children
    sums.append(torch.full((sizes[-1], f_dim), float("-inf") if aggr == "max" else 0.0,
                           dtype=acc, device=x.device))
    counts.append(torch.zeros(sizes[-1], dtype=torch.float32, device=x.device))
    total = torch.cat(sums, dim=0)
    count = torch.cat(counts)
    if topo.extra_src is not None:
        n_sub = topo.num_nodes
        msgs = fast_take(x, topo.extra_src).to(acc)
        dst = topo._routed(topo.extra_dst.long())
        if aggr == "max":
            idx = dst[:, None].expand(-1, f_dim)
            extra = torch.full((n_sub + 1, f_dim), float("-inf"), dtype=acc, device=x.device)
            extra = extra.scatter_reduce(0, idx, msgs, reduce="amax")[:n_sub]
            total = torch.maximum(total, extra)
        else:
            total = total + segment_sum(msgs, dst, n_sub + 1)[:n_sub]
        count = count + segment_count(dst, n_sub + 1)[:n_sub]
    if aggr == "max":
        return torch.where(torch.isfinite(total), total, torch.zeros_like(total)).to(x.dtype)
    if aggr == "sum":
        return total.to(x.dtype)
    return (total.float() / count.clamp(min=1.0)[:, None]).to(x.dtype)


def tree_parent_gather(p: torch.Tensor, topo: TreeTopo) -> tuple[torch.Tensor, torch.Tensor]:
    """For each flat node as an edge SOURCE: the sum of its out-neighbours'
    rows and its out-degree (``get_uncertainty``'s A^T-style aggregation).
    In the tree every child's one out-edge points to its parent, so this is
    a structural repeat of the parents' rows, plus the extras' sums."""
    sizes, bases = topo.sizes, topo.bases
    outs = [torch.zeros((sizes[0], p.shape[-1]), dtype=p.dtype, device=p.device)]
    degs = [torch.zeros(sizes[0], dtype=torch.float32, device=p.device)]
    off = 0
    for d, f in enumerate(topo.fanouts):
        n_child = sizes[d + 1]
        rep = p[bases[d]:bases[d] + sizes[d]].repeat_interleave(f, dim=0)
        cm = topo.edge_mask[off:off + n_child]
        off += n_child
        outs.append(torch.where(cm[:, None], rep, torch.zeros_like(rep)))
        degs.append(cm.float())
    total, deg = torch.cat(outs, dim=0), torch.cat(degs)
    if topo.extra_src is not None:
        n_sub = topo.num_nodes
        src = topo._routed(topo.extra_src.long())
        total = total + segment_sum(fast_take(p, topo.extra_dst), src, n_sub + 1)[:n_sub]
        deg = deg + segment_count(src, n_sub + 1)[:n_sub]
    return total, deg
