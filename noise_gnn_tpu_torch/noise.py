"""Corruption engine: synthetic label, edge and feature noise.

Port of ``noise_gnn_tpu/noise.py`` (reference parity: src/utils/noise.py).
``flip_label`` builds a row-stochastic noise matrix (4 types) and samples
each node's noisy label from its row; ``noise_or_not = (y == yhn)`` — True
means the label is CLEAN (reference: src/pipeline.py:73). The host
functions take an explicit ``np.random.Generator``, consumed in the same
order as the JAX package, so a seed gives identical draws;
``flip_label_device`` re-noises labels on the device from a
``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch


def build_noise_matrix(
    num_classes: int,
    noise_type: str = "sym",
    prob: float = 0.3,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Row-stochastic noise matrix (reference noise.py:11-50).

    sym:       (1-p) I + p/(C-1) (J - I)
    next_pair: (1-p) I + p * circular shift(+1)
    rand_pair: (1-p) I + p at a random permutation-pair per class
    aim_pair:  rand_pair with pairs {0->3, 1->4, 2->5} pinned
    """
    C = num_classes
    rng = rng or np.random.default_rng(0)
    if noise_type == "sym":
        mat = np.diag([1 - prob] * C) + (np.ones((C, C)) - np.eye(C)) * (
            prob / (C - 1)
        )
    elif noise_type == "next_pair":
        mat = (
            np.diag([1 - prob] * C)
            + np.diag([prob] * (C - 1), k=1)
            + np.diag([prob], k=-(C - 1))
        )
    elif noise_type == "rand_pair":
        row1 = np.arange(C)[rng.permutation(C)]
        row2 = np.arange(C)[rng.permutation(C)]
        mat = np.diag([1 - prob] * C).astype(np.float64)
        mat[row1, row2] += prob
    elif noise_type == "aim_pair":
        pinned = np.array([[0, 1, 2], [3, 4, 5]])
        # the pinned pairs index classes up to 5, so C must exceed 5 — the
        # reference's guard (src/utils/noise.py:29-31) only rejects C<=3 and
        # crashes out-of-bounds for C in {4, 5}; fixed properly here
        if C <= int(pinned.max()):
            raise ValueError(
                f"aim_pair pins pairs over classes 0-{int(pinned.max())}; "
                f"needs num_classes > {int(pinned.max())}, got {C}"
            )
        numbers = np.arange(C)
        free1 = np.setdiff1d(numbers, pinned[0])
        free2 = np.setdiff1d(numbers, pinned[1])
        row1 = np.concatenate([free1[rng.permutation(len(free1))], pinned[0]])
        row2 = np.concatenate([free2[rng.permutation(len(free2))], pinned[1]])
        mat = np.diag([1 - prob] * C).astype(np.float64)
        mat[row1, row2] += prob
    else:
        raise ValueError(f"wrong noise type {noise_type!r}")
    return mat


def flip_label(
    labels: np.ndarray,
    num_classes: int,
    noise_type: str = "sym",
    prob: float = 0.3,
    rng: np.random.Generator | None = None,
):
    """Sample noisy labels; returns (yhn [N] int32, noise_mat [C, C]).

    Reference: noise.py:6-61 (per-node multinomial over the matrix row).
    """
    rng = rng or np.random.default_rng(0)
    mat = build_noise_matrix(num_classes, noise_type, prob, rng)
    labels = np.asarray(labels).reshape(-1)
    rows = mat[labels]  # [N, C]
    # vectorized per-row categorical sampling via inverse-CDF
    cdf = np.cumsum(rows, axis=1)
    u = rng.random((labels.shape[0], 1)) * cdf[:, -1:]
    yhn = (u > cdf).sum(axis=1).astype(np.int32)
    return yhn, mat


def noise_or_not(y: np.ndarray, yhn: np.ndarray) -> np.ndarray:
    """True where the (possibly noisy) label is actually clean
    (reference: src/pipeline.py:73)."""
    return np.asarray(y).reshape(-1) == np.asarray(yhn).reshape(-1)


def flip_label_device(gen: torch.Generator, labels: torch.Tensor,
                      noise_mat: torch.Tensor) -> torch.Tensor:
    """On-device re-noising: each label drawn from its noise-matrix row,
    the categorical over ``log(max(row, 1e-12))`` that the JAX package
    samples (rows are probabilities, so the draw is over the clamped row
    itself). Returns int64 labels on ``labels``' device."""
    rows = noise_mat.to(labels.device).float().clamp(min=1e-12)[labels.long()]
    return torch.multinomial(rows, 1, generator=gen)[:, 0]


def add_edge_noise(edge_index: np.ndarray, num_nodes: int, prob: float = 0.4,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Symmetric edge delete+add noise on an undirected graph (reference
    noise.py:63-95): delete ``prob`` of the upper-triangle edges, add as
    many random non-edges, re-symmetrize. Sparse: the reference
    materializes a dense N^2 adjacency."""
    rng = rng or np.random.default_rng(0)
    src, dst = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    upper = src < dst
    usrc, udst = src[upper], dst[upper]
    m = usrc.shape[0]
    k = int(m * prob)

    keep = np.ones(m, dtype=bool)
    keep[rng.choice(m, size=k, replace=False)] = False
    usrc, udst = usrc[keep], udst[keep]

    existing = set(zip(src.tolist(), dst.tolist()))
    added_s, added_d = [], []
    while len(added_s) < k:
        a = rng.integers(0, num_nodes, size=k)
        b = rng.integers(0, num_nodes, size=k)
        for i, j in zip(a.tolist(), b.tolist()):
            if len(added_s) >= k:
                break
            if i == j:
                continue
            lo, hi = (i, j) if i < j else (j, i)
            if (lo, hi) in existing:
                continue
            existing.add((lo, hi))
            added_s.append(lo)
            added_d.append(hi)
    usrc = np.concatenate([usrc, np.asarray(added_s, dtype=np.int64)])
    udst = np.concatenate([udst, np.asarray(added_d, dtype=np.int64)])
    out = np.stack([np.concatenate([usrc, udst]), np.concatenate([udst, usrc])])
    return out.astype(np.int32)


def add_feature_noise(x: np.ndarray, prob: float, mean: float = 0.0, std: float = 0.1,
                      rng: np.random.Generator | None = None) -> np.ndarray:
    """Masked Gaussian feature noise (reference noise.py:97-114)."""
    rng = rng or np.random.default_rng(0)
    noise = rng.normal(mean, std, size=x.shape)
    mask = rng.random(x.shape) < prob
    return (x + mask * noise).astype(x.dtype)
