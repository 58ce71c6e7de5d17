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

from ..ops.sddmm import (SEG, blockwise_topk, exclude_, hier_flat, hier_topk, l2_normalize,
                         merge_topk, padded_rows, pick_from_segments, segment_extrema,
                         segment_values, select_segments, stable_topk)
from ..ops.tree_agg import TreeTopo
from ..parallel.mesh import all_gather
from ..utils.profiling import count, counting, trace

NEG_INF = float("-inf")
# row blocks whose selection the fused sweep runs at once: at the TE cell's
# shape (2048 x 159,232) a group's keys and candidates take ~1 GB beside the
# extrema's 1.48 GiB, under the 2.7 GiB the block sweep took, and groups of
# 1, 2, 4 and 8 swept in 468, 345, 289 and 262 ms on an H100
GROUP = 8


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


def block_range(nblocks: int, mesh=None) -> range:
    """The row blocks a rank sweeps: a contiguous ``nblocks * r // D`` to
    ``nblocks * (r + 1) // D`` (all of them without a mesh)."""
    if mesh is None:
        return range(nblocks)
    return range(nblocks * mesh.rank // mesh.size, nblocks * (mesh.rank + 1) // mesh.size)


def _plan(h: torch.Tensor, topo: TreeTopo, k_percent: float):
    """(hn, k2, structural-edge scores, valid edges, pos keep mask): the
    rewire's inputs over the E = n - batch_size structural edges, the same
    on every rank."""
    k2 = max(2 * int(topo.num_nodes * k_percent), 1)
    hn = l2_normalize(h.detach().float())
    sim_e = _tree_edge_scores(hn, topo)
    valid = topo.edge_mask
    return hn, k2, sim_e, valid, valid & ~_remove_k(sim_e, valid, k2, lowest=True)


def _carry(k2: int, dev):
    """A running top-k before any block: k2 entries of (-inf, 0, 0)."""
    return (torch.full((k2,), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros(k2, dtype=torch.int64, device=dev),
            torch.zeros(k2, dtype=torch.int64, device=dev))


def _sweep(hn, topo: TreeTopo, pos_keep, k2: int, blocks: range, block: int, neg: bool):
    """The row blocks ``blocks`` (of ``block`` rows each) swept in order
    into fresh carries: (pos carry, neg carry or None). Where N and the
    block are multiples of ``SEG`` the fused route runs
    (:func:`_sweep_fused`), else the block-by-block one
    (:func:`_sweep_blocks`); the same picks either way. While a profiler
    runs, the counter ``rewire_fused`` counts the blocks the fused route
    swept over all swept.

    What keeps the block sweep is the kernels, not the picks: they take
    whole 128-row tiles only. The fused route's plain versions, with the
    columns past N padded with -inf to whole segments, pass the JAX-parity
    tests on unaligned trees as well; one route for every tree would need
    a column bound and row ranges that start inside a tile in both
    kernels."""
    n = topo.num_nodes
    block = min(block, n)
    fused = n % SEG == 0 and block % SEG == 0 and not hier_flat(block * n, k2, SEG)
    if counting():
        count("rewire_fused", torch.full((len(blocks),), fused))
    return (_sweep_fused if fused else _sweep_blocks)(hn, topo, pos_keep, k2, blocks, block, neg)


def _exclusions(topo: TreeTopo, keep: torch.Tensor) -> torch.Tensor:
    """Per flat row, its one excluded column beside the diagonal: its
    structural parent where this graph keeps the row's out-edge, else -1."""
    n, b_seed = topo.num_nodes, topo.batch_size
    rid = torch.arange(n, device=keep.device)
    eid = (rid - b_seed).clamp(0, max(n - b_seed - 1, 0))
    return torch.where((rid >= b_seed) & keep[eid], topo.parent_of(rid), -1).to(torch.int32)


def _sweep_fused(hn, topo: TreeTopo, pos_keep, k2: int, blocks: range, block: int, neg: bool):
    """:func:`_sweep_blocks`'s carries without a similarity block in
    memory: the segment extrema of every swept row come from one
    :func:`segment_extrema` call (``ngt.rewire_sim``), and the chosen
    segments from :func:`segment_values`; the selection between them is
    ``hier_topk``'s own two stages, run on ``GROUP`` blocks at once. Each
    block's picks do not depend on the carry, so merging a group's in block
    order is merging them block by block (see :func:`merge_carries`). Needs
    N and ``block`` multiples of ``SEG``, so that every segment of a
    block's flat view lies in one row."""
    n, dev = topo.num_nodes, hn.device
    carries = [_carry(k2, dev)] + ([_carry(k2, dev)] if neg else [])
    if not len(blocks):
        return carries[0], (carries[1] if neg else None)
    excl = [_exclusions(topo, pos_keep)] + ([_exclusions(topo, topo.edge_mask)] if neg else [])
    hnt = hn.T.contiguous() if dev.type == "cuda" else None
    with trace("ngt.rewire_sim"):
        ext = segment_extrema(hn, blocks, block, excl[0], excl[1] if neg else None, hnt)
    for g in range(0, len(blocks), GROUP):
        grp = blocks[g:g + GROUP]
        rows = slice(g * block, (g + len(grp)) * block)
        picks = [(select_segments(x[rows].view(len(grp), -1), k2), e, sign)
                 for x, e, sign in zip(ext, excl, (False, True))]
        row0 = torch.arange(grp.start, grp.stop, device=dev)[:, None] * block
        for j, (cand, (si, _, _)) in enumerate(zip(segment_values(hn, grp, block, picks, hnt),
                                                   picks)):
            v, idx = pick_from_segments(cand, si, block * n, k2)
            hit = (row0 + torch.div(idx, n, rounding_mode="floor"), idx % n)
            carries[j] = merge_topk(*carries[j], v.reshape(-1), *(x.reshape(-1) for x in hit),
                                    k2)
    return carries[0], (carries[1] if neg else None)


def _sweep_blocks(hn, topo: TreeTopo, pos_keep, k2: int, blocks: range, block: int,
                  neg: bool):
    """The sweep block by block. Both signs share one similarity matmul per
    row block. The excluded entries of a block are few and known from the
    tree's structure (the diagonal, and each child's one out-edge to its
    parent), so they are set to -inf in place (``exclude_``) rather than
    through [block, N] masks; rows past N are -inf whole."""
    n, dev = topo.num_nodes, hn.device
    hp = padded_rows(hn, block)
    excl = [_exclusions(topo, pos_keep), _exclusions(topo, topo.edge_mask)]

    def merge(acc, s, row0):
        v, idx = hier_topk(s.reshape(-1), k2)
        return merge_topk(*acc, v, row0 + torch.div(idx, n, rounding_mode="floor"),
                          idx % n, k2)

    pos, negs = _carry(k2, dev), (_carry(k2, dev) if neg else None)
    for i in blocks:
        row0 = i * block
        sim = hp[row0:row0 + block] @ hn.T
        if neg:  # first: the pos exclusions are written into sim
            negs = merge(negs, exclude_(-sim, row0, excl[1]), row0)
        pos = merge(pos, exclude_(sim, row0, excl[0]), row0)
        del sim
    return pos, negs


def merge_carries(carries, k2: int):
    """The one carry of a sweep split into contiguous block ranges, from
    the ranges' carries in block order: the top-k of their concatenation,
    ties to the earlier position (``stable_topk``). A stable top-k under
    (value, position) keeps the k2 first of a total order, so it is the
    carry one sweep over every block would hold; and a carry's -inf entries
    are always its initial (0, 0) ones, since the carry wins ties, so the
    -inf quirk comes out the same too."""
    if len(carries) == 1:
        return carries[0]
    vals, rows, cols = (torch.cat(part) for part in zip(*carries))
    _, i = stable_topk(vals, k2)
    return vals[i], rows[i], cols[i]


def rewire_carries(h: torch.Tensor, topo: TreeTopo, k_percent: float, block: int,
                   blocks: range, neg: bool = True):
    """The carries (pos, neg or None) of the sweep of :func:`topk_rewire_tree`
    over the row blocks ``blocks``: what each rank computes under a mesh
    before :func:`merge_carries`."""
    hn, k2, _, _, pos_keep = _plan(h, topo, k_percent)
    return _sweep(hn, topo, pos_keep, k2, blocks, block, neg)


def _gather_carries(mesh, carries, k2: int):
    """Every rank's carries, merged in rank order: one all-gather of the
    (value bits, row, col) triples of both carries."""
    packed = torch.stack([t for c in carries for t in
                          (c[0].view(torch.int32).long(), c[1], c[2])], dim=1)
    every = all_gather(mesh, packed).view(mesh.size, k2, -1)
    out = []
    for j in range(len(carries)):
        part = every[:, :, 3 * j:3 * j + 3]
        out.append(merge_carries(
            [(p[:, 0].int().view(torch.float32), p[:, 1], p[:, 2]) for p in part], k2))
    return out


def topk_rewire_tree(h: torch.Tensor, topo: TreeTopo, k_percent: float = 0.1,
                     block: int = 2048, neg: bool = True,
                     mesh=None) -> tuple[TreeTopo, TreeTopo | None]:
    """Tree-subgraph ``topk_rewire`` in delta form: (pos_topo, neg_topo).

    The same picks as :func:`topk_rewire` on ``topo``'s equivalent edge
    list: removals become edge-mask updates, additions extra edges (see
    :func:`_sweep`). With ``neg=False`` the negative graph is neither built
    nor returned (None): a caller that reads only the positive one skips
    its half of the work, as XLA drops it from the JAX package's jitted
    steps. With a ``mesh`` of several ranks, ``h`` and ``topo`` are the
    whole subgraph's on every rank, each rank sweeps its own contiguous
    range of row blocks (:func:`block_range`), and the ranks' carries are
    gathered and merged in rank order (:func:`merge_carries`): every rank
    gets the one-process picks. The structural-edge scores run whole on
    every rank (E values)."""
    hn, k2, sim_e, valid, pos_keep = _plan(h, topo, k_percent)
    nblocks = -(-topo.num_nodes // min(block, topo.num_nodes))
    pos, negs = _sweep(hn, topo, pos_keep, k2, block_range(nblocks, mesh), block, neg)
    if mesh is not None and mesh.group is not None and mesh.size > 1:
        merged = _gather_carries(mesh, [pos, negs] if neg else [pos], k2)
        pos, negs = merged[0], (merged[1] if neg else None)
    ones = torch.ones(k2, dtype=torch.bool, device=h.device)
    pos_topo = TreeTopo(topo.batch_size, topo.fanouts, pos_keep, pos[1], pos[2], ones)
    if not neg:
        return pos_topo, None
    neg_keep = valid & ~_remove_k(sim_e, valid, k2, lowest=False)
    return pos_topo, TreeTopo(topo.batch_size, topo.fanouts, neg_keep, negs[1], negs[2], ones)
