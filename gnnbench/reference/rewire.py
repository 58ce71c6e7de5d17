"""Similarity top-k rewiring of a flat tree subgraph (reference
``topk_rewire``, src/utils/augmentation.py), and the positive view's
column shuffle (``shuffle_pos``).

With k2 = 2 * int(n * k_percent) and cosine similarities of the rows'
embeddings:
  positive graph: drop the k2 lowest-similarity existing edges, add the k2
    highest-similarity pairs (r, c) that are neither the diagonal nor a
    kept edge r -> c;
  negative graph: drop the k2 highest-similarity existing edges, add the k2
    lowest-similarity pairs that are neither the diagonal nor an edge.
An added pair (r, c) carries messages from r to c. Ties are broken by the
lower index, as the reference's top-k does.
"""

from __future__ import annotations

import torch

from .sage import FlatGraph, tree_flat_graph

BLOCK = 2048  # rows of the n x n similarity held at once


def _lowest_first(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest of ``v``, ties to the lower index."""
    return torch.sort(v, stable=True).indices[:k]


def _topk_pairs(hn: torch.Tensor, k: int, excluded, largest: bool):
    """(rows, cols) of the k largest (or smallest) entries of hn hn^T
    outside ``excluded(row0, sim_block)`` (which sets them to -inf in the
    signed block), ties to the lower flat index r * n + c."""
    n = hn.shape[0]
    sign = 1.0 if largest else -1.0
    best_v = torch.full((0,), float("-inf"), device=hn.device)
    best_i = torch.zeros((0,), dtype=torch.int64, device=hn.device)
    for row0 in range(0, n, BLOCK):
        s = sign * (hn[row0:row0 + BLOCK] @ hn.T)
        excluded(row0, s)
        v, i = torch.topk(s.reshape(-1), min(k, s.numel()))
        vals = torch.cat([best_v, v])
        idx = torch.cat([best_i, i + row0 * n])
        # keep the k best, ties to the lower flat index: sort by index, then
        # stably by value, descending
        o = torch.argsort(idx)
        vals, idx = vals[o], idx[o]
        o = torch.sort(vals, descending=True, stable=True).indices[:k]
        best_v, best_i = vals[o], idx[o]
    return torch.div(best_i, n, rounding_mode="floor"), best_i % n


def rewire_tree(h: torch.Tensor, sizes: list[int], fanouts, child_mask: torch.Tensor,
                k_percent: float):
    """(positive graph, negative graph) of the flat tree whose structural
    edges are each child -> its parent, masked by ``child_mask``."""
    n = sum(sizes)
    k2 = max(2 * int(n * k_percent), 1)
    hn = h.float() / torch.sqrt((h.float() ** 2).sum(-1, keepdim=True)).clamp(min=1e-12)
    tree = tree_flat_graph(sizes, fanouts, child_mask)
    sim_e = (hn[tree.src] * hn[tree.dst]).sum(-1)
    valid = child_mask
    big = torch.finfo(torch.float32).max

    def drop(lowest: bool) -> torch.Tensor:
        score = torch.where(valid, sim_e if lowest else -sim_e, big)
        out = torch.zeros_like(valid)
        out[_lowest_first(score, k2)] = True
        return out & valid

    pos_keep = valid & ~drop(lowest=True)
    neg_keep = valid & ~drop(lowest=False)
    b = sizes[0]
    parent = torch.arange(n, device=h.device)
    parent[b:] = tree.dst

    def excluder(keep: torch.Tensor):
        def excluded(row0: int, s: torch.Tensor) -> None:
            rows = torch.arange(row0, row0 + s.shape[0], device=s.device)
            local = rows - row0
            s[local, rows] = float("-inf")
            child = rows >= b
            e = (rows - b).clamp(min=0)
            has = child & keep[e]
            s[local[has], parent[rows[has]]] = float("-inf")
        return excluded

    pr, pc = _topk_pairs(hn, k2, excluder(pos_keep), largest=True)
    nr, nc = _topk_pairs(hn, k2, excluder(valid), largest=False)
    ones = torch.ones(k2, dtype=torch.bool, device=h.device)
    pos = FlatGraph(torch.cat([tree.src, pr]), torch.cat([tree.dst, pc]),
                    torch.cat([pos_keep, ones]), n)
    neg = FlatGraph(torch.cat([tree.src, nr]), torch.cat([tree.dst, nc]),
                    torch.cat([neg_keep, ones]), n)
    return pos, neg


def shuffle_cols(gen: torch.Generator, x: torch.Tensor, prob: float) -> torch.Tensor:
    """Per row, m = int(F * prob) distinct columns (the first m of a random
    order, from one [n, F] draw) get their values permuted among them (a
    second [n, m] draw); no draw where m <= 1."""
    n, f = x.shape
    m = int(f * prob)
    if m <= 1:
        return x
    sel = torch.argsort(torch.rand((n, f), generator=gen, device=x.device), dim=1)[:, :m]
    perm = torch.argsort(torch.rand((n, m), generator=gen, device=x.device), dim=1)
    return x.scatter(1, sel, torch.gather(x, 1, torch.gather(sel, 1, perm)))
