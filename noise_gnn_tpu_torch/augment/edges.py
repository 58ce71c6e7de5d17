"""Whole-graph random edge augmentation with exact-count semantics.

Port of ``noise_gnn_tpu/augment/edges.py`` (reference
src/utils/augmentation.py:117-217): a copy of that host numpy code, which
draws from the ``np.random.Generator`` exactly as the JAX package does, so
both packages build the same views from the same seed. ``PipelineCT`` builds
its augmented graph views once, before training
(reference src/pipeline_contrast.py:60-68).

  * ``augment_edges_pos``: delete exactly ``prob * E_und`` undirected edges
    and add exactly that many new undirected edges (not previously present,
    no self-loops), returning the symmetrized edge list;
  * ``augment_edges_neg``: a random graph with exactly as many undirected
    edges as the input, disjoint from the input's edge set.
"""

from __future__ import annotations

import numpy as np


def _undirected_pairs(edge_index: np.ndarray) -> set[tuple[int, int]]:
    src, dst = edge_index[0], edge_index[1]
    keep = src != dst
    lo = np.minimum(src[keep], dst[keep])
    hi = np.maximum(src[keep], dst[keep])
    return set(zip(lo.tolist(), hi.tolist()))


def _pairs_to_edge_index(pairs) -> np.ndarray:
    if not pairs:
        return np.zeros((2, 0), np.int32)
    arr = np.asarray(sorted(pairs), dtype=np.int32).T
    return np.concatenate([arr, arr[::-1]], axis=1)


def _sample_new_pairs(
    existing: set, count: int, nbr_nodes: int, rng: np.random.Generator
) -> set:
    out: set = set()
    while len(out) < count:
        need = count - len(out)
        a = rng.integers(0, nbr_nodes, size=2 * need + 8)
        b = rng.integers(0, nbr_nodes, size=2 * need + 8)
        for i, j in zip(a.tolist(), b.tolist()):
            if len(out) >= count:
                break
            if i == j:
                continue
            p = (i, j) if i < j else (j, i)
            if p in existing or p in out:
                continue
            out.add(p)
    return out


def augment_edges_pos(
    edge_index: np.ndarray,
    nbr_nodes: int,
    prob: float = 0.1,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    pairs = _undirected_pairs(edge_index)
    k = int(len(pairs) * prob)
    plist = sorted(pairs)
    delete_idx = rng.choice(len(plist), size=k, replace=False)
    deleted = {plist[i] for i in delete_idx}
    kept = pairs - deleted
    added = _sample_new_pairs(pairs, k, nbr_nodes, rng)
    return _pairs_to_edge_index(kept | added)


def augment_edges_neg(
    edge_index: np.ndarray,
    nbr_nodes: int,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    pairs = _undirected_pairs(edge_index)
    added = _sample_new_pairs(pairs, len(pairs), nbr_nodes, rng)
    return _pairs_to_edge_index(added)
