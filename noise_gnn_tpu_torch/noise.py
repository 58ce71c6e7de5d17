"""Corruption engine, host part: synthetic label noise.

The port's copy of the host numpy half of ``noise_gnn_tpu/noise.py``
(reference parity: src/utils/noise.py). ``flip_label`` builds a
row-stochastic noise matrix (4 types) and samples each node's noisy label
from its row; ``noise_or_not = (y == yhn)`` — True means the label is CLEAN
(reference: src/pipeline.py:73). Explicit ``np.random.Generator``, consumed
in the same order as the JAX package, so a seed gives identical draws.
"""

from __future__ import annotations

import numpy as np


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
