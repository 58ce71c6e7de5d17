"""Throughput accounting shared with the JAX package's metrics."""

from __future__ import annotations


def tree_edges_per_batch(batch_size: int, fanouts: tuple[int, ...]) -> int:
    """Sampled (parent, child) pairs per k-hop tree batch — the unit behind
    the edges/s counter (matches the BASELINE.md north-star metric)."""
    total, width = 0, batch_size
    for f in fanouts:
        width *= f
        total += width
    return total
