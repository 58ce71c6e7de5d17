"""Label noise, worked out again from the seed: the noise matrix and each
node's draw from its row by the inverse CDF (reference src/utils/noise.py),
consuming one ``np.random.Generator`` in the order the reference does."""

from __future__ import annotations

import numpy as np


def noise_matrix(c: int, noise_type: str, prob: float, rng: np.random.Generator) -> np.ndarray:
    if noise_type == "sym":
        return np.diag([1 - prob] * c) + (np.ones((c, c)) - np.eye(c)) * (prob / (c - 1))
    if noise_type == "rand_pair":
        row1 = np.arange(c)[rng.permutation(c)]
        row2 = np.arange(c)[rng.permutation(c)]
        mat = np.diag([1 - prob] * c).astype(np.float64)
        mat[row1, row2] += prob
        return mat
    raise ValueError(f"noise type {noise_type!r} has no reference here")


def flip_labels(y: np.ndarray, c: int, noise_type: str, prob: float,
                rng: np.random.Generator) -> np.ndarray:
    mat = noise_matrix(c, noise_type, prob, rng)
    cdf = np.cumsum(mat[np.asarray(y).reshape(-1)], axis=1)
    u = rng.random((cdf.shape[0], 1)) * cdf[:, -1:]
    return (u > cdf).sum(axis=1).astype(np.int64)
