"""Similarity top-k rewiring without an N x N matrix in memory.

Port of ``noise_gnn_tpu/augment/rewire.py`` (reference ``topk_rewire``,
src/utils/augmentation.py:9-86). With k2 = 2 * int(N * k_percent):

  pos graph: remove the k2 LOWEST-similarity existing (off-diagonal) edges,
             add the k2 HIGHEST-similarity non-edges (against the kept
             adjacency);
  neg graph: remove the k2 HIGHEST-similarity existing edges, add the k2
             LOWEST-similarity non-edges (against the original adjacency).

Similarities are cosines of the detached embeddings; only integer edge ids
and boolean masks leave, so no gradient flows through them. Every top-k is
``ops/sddmm.py::stable_topk`` or ``hier_topk``, which pick what
``jax.lax.top_k`` picks, ties included. Quirks kept as the JAX package has
them: an addition whose value is -inf (fewer than k2 candidates) points at
row 0 or at index n - 1 and is still added with mask True.
"""

from __future__ import annotations

import torch

from ..ops.sddmm import blockwise_topk, hier_topk, l2_normalize, merge_topk, stable_topk
from ..ops.tree_agg import TreeTopo

NEG_INF = float("-inf")


def _edge_scores(hn: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
    return (hn[edge_index[0].long()] * hn[edge_index[1].long()]).sum(dim=-1)


def _remove_k(edge_sim: torch.Tensor, valid: torch.Tensor, k: int,
              lowest: bool) -> torch.Tensor:
    """Boolean mask of the k lowest/highest-similarity valid edges."""
    scores = torch.where(valid, -edge_sim if lowest else edge_sim, NEG_INF)
    vals, idx = stable_topk(scores, min(k, edge_sim.shape[0]))
    sel = torch.zeros(edge_sim.shape, dtype=torch.bool, device=edge_sim.device)
    sel[idx] = vals > NEG_INF
    return sel


def _adj_mask_fn(edge_index: torch.Tensor, edge_valid: torch.Tensor, n: int):
    """mask_fn for ``blockwise_topk``: excludes the existing (valid) edges
    and the diagonal, from a [block, N] adjacency slice scattered per row
    block (edges outside the block land in a dead row)."""
    src, dst = edge_index[0].long(), edge_index[1].long()

    def mask_fn(row0, row_ids, sim):
        block = sim.shape[0]
        local = src - row0
        in_blk = edge_valid & (local >= 0) & (local < block)
        rows = torch.where(in_blk, local, block)
        adj = torch.zeros((block + 1, sim.shape[1]), dtype=torch.bool, device=sim.device)
        adj[rows, dst] = True
        sim = torch.where(adj[:block], NEG_INF, sim)
        diag = row_ids[:, None] == torch.arange(sim.shape[1], device=sim.device)[None, :]
        return torch.where(diag, NEG_INF, sim)

    return mask_fn


def topk_rewire(h: torch.Tensor, edge_index: torch.Tensor, edge_mask: torch.Tensor | None,
                k_percent: float = 0.1, block: int = 1024):
    """Returns ((pos_edges, pos_mask), (neg_edges, neg_mask)) for the
    [2, E] ``edge_index`` over the N rows of ``h``; each edge list is the
    original edges followed by k2 additions."""
    n, e = h.shape[0], edge_index.shape[1]
    k2 = max(2 * int(n * k_percent), 1)
    hn = l2_normalize(h.detach().float())
    if edge_mask is None:
        edge_mask = torch.ones(e, dtype=torch.bool, device=h.device)
    valid = edge_mask & (edge_index[0] != edge_index[1])
    sim = _edge_scores(hn, edge_index)
    ones = torch.ones(k2, dtype=torch.bool, device=h.device)

    pos_keep = edge_mask & ~_remove_k(sim, valid, k2, lowest=True)
    _, add_r, add_c = blockwise_topk(hn, k2, _adj_mask_fn(edge_index, pos_keep, n),
                                     largest=True, block=block)
    pos = (torch.cat([edge_index.long(), torch.stack([add_r, add_c])], dim=1),
           torch.cat([pos_keep, ones]))

    neg_keep = edge_mask & ~_remove_k(sim, valid, k2, lowest=False)
    _, nadd_r, nadd_c = blockwise_topk(hn, k2, _adj_mask_fn(edge_index, edge_mask, n),
                                       largest=False, block=block)
    neg = (torch.cat([edge_index.long(), torch.stack([nadd_r, nadd_c])], dim=1),
           torch.cat([neg_keep, ones]))
    return pos, neg


def _tree_edge_scores(hn: torch.Tensor, topo: TreeTopo) -> torch.Tensor:
    """<hn[child], hn[parent]> per structural tree edge (edge e is the
    out-edge of flat child node e + batch_size): a structural repeat."""
    sizes, bases = topo.sizes, topo.bases
    parents = torch.cat([hn[bases[d]:bases[d] + sizes[d]].repeat_interleave(f, dim=0)
                         for d, f in enumerate(topo.fanouts)], dim=0)
    return (hn[bases[1]:topo.num_nodes] * parents).sum(dim=-1)


def topk_rewire_tree(h: torch.Tensor, topo: TreeTopo, k_percent: float = 0.1,
                     block: int = 2048, neg: bool = True) -> tuple[TreeTopo, TreeTopo | None]:
    """Tree-subgraph ``topk_rewire`` in delta form: (pos_topo, neg_topo).

    The same picks as :func:`topk_rewire` on ``topo``'s equivalent edge
    list: removals become edge-mask updates, additions extra edges. Both
    sweeps share one similarity matmul per row block of ``block`` rows. The
    excluded entries of a block are few and known from the tree's
    structure (the diagonal, and each child's one out-edge to its parent),
    so they are set to -inf in place rather than through [block, N] masks;
    rows past N are -inf whole. With ``neg=False`` the negative graph is
    neither built nor returned (None): a caller that reads only the
    positive one skips its half of the work, as XLA drops it from the JAX
    package's jitted steps."""
    n, b_seed = topo.num_nodes, topo.batch_size
    e = n - b_seed  # structural edge count
    k2 = max(2 * int(n * k_percent), 1)
    dev = h.device
    hn = l2_normalize(h.detach().float())

    sim_e = _tree_edge_scores(hn, topo)
    valid = topo.edge_mask
    pos_keep = valid & ~_remove_k(sim_e, valid, k2, lowest=True)

    block = min(block, n)
    nblocks = -(-n // block)
    hp = torch.nn.functional.pad(hn, (0, 0, 0, nblocks * block - n))
    local = torch.arange(block, device=dev)

    def carry():
        return (torch.full((k2,), NEG_INF, dtype=torch.float32, device=dev),
                torch.zeros(k2, dtype=torch.int64, device=dev),
                torch.zeros(k2, dtype=torch.int64, device=dev))

    def sweep(s, keep, acc, row0, rid, par, eid, has_edge):
        """Write the block's exclusions into ``s`` (in place) and merge its
        top-k into the carry ``acc``."""
        s[n - row0:] = NEG_INF
        s[local, rid] = NEG_INF
        # each row's structural out-edge (rid -> parent) where this graph has
        # it; elsewhere the diagonal again
        s[local, torch.where(has_edge & keep[eid], par, rid)] = NEG_INF
        v, idx = hier_topk(s.reshape(-1), k2)
        return merge_topk(*acc, v, row0 + torch.div(idx, n, rounding_mode="floor"),
                          idx % n, k2)

    pos, negs = carry(), carry()
    for i in range(nblocks):
        row0 = i * block
        rid = (row0 + local).clamp(max=n - 1)
        where = (row0, rid, topo.parent_of(rid), (rid - b_seed).clamp(0, max(e - 1, 0)),
                 rid >= b_seed)  # rows past n are -inf whole
        sim = hp[row0:row0 + block] @ hn.T
        if neg:
            negs = sweep(-sim, valid, negs, *where)  # first: the next sweep writes into sim
        pos = sweep(sim, pos_keep, pos, *where)
        del sim

    ones = torch.ones(k2, dtype=torch.bool, device=dev)
    pos_topo = TreeTopo(b_seed, topo.fanouts, pos_keep, pos[1], pos[2], ones)
    if not neg:
        return pos_topo, None
    neg_keep = valid & ~_remove_k(sim_e, valid, k2, lowest=False)
    return pos_topo, TreeTopo(b_seed, topo.fanouts, neg_keep, negs[1], negs[2], ones)
