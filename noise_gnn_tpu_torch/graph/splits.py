"""Split generation with reference parity.

The port's copy of ``noise_gnn_tpu/graph/splits.py`` (numpy only).

Reference: src/utils/load_utils.py:54-173. Class-balanced random splits with
optional on-disk caching of the chosen indices (the reference saves them to
``../out_index/``; we cache under ``<out_dir>/index/`` keyed by run name).
"""

from __future__ import annotations

import numpy as np

from .containers import Graph


def index_to_mask(index: np.ndarray, size: int) -> np.ndarray:
    """Reference: load_utils.py:54-59."""
    mask = np.zeros(size, dtype=bool)
    mask[np.asarray(index, dtype=np.int64)] = True
    return mask


def _per_class_indices(y: np.ndarray, num_classes: int, rng: np.random.Generator):
    out = []
    for c in range(num_classes):
        idx = np.nonzero(y == c)[0]
        out.append(rng.permutation(idx))
    return out


def random_planetoid_splits(
    g: Graph,
    rng: np.random.Generator,
    train_per_class: int = 20,
    val_per_class: int = 30,
    val_total: int | None = None,
    test_total: int | None = None,
) -> Graph:
    """20/class train, 30/class val, rest test (reference
    random_coauthor_amazon_splits, load_utils.py:99-144). With
    ``val_total``/``test_total`` set, mimics the Planetoid public-split shape
    instead (20/class train, fixed-size val/test)."""
    indices = _per_class_indices(g.y, g.num_classes, rng)
    train = np.concatenate([i[:train_per_class] for i in indices])
    if val_total is not None:
        rest = rng.permutation(np.concatenate([i[train_per_class:] for i in indices]))
        val = rest[:val_total]
        test = rest[val_total : val_total + (test_total or len(rest))]
    else:
        hi = train_per_class + val_per_class
        val = np.concatenate([i[train_per_class:hi] for i in indices])
        test = rng.permutation(np.concatenate([i[hi:] for i in indices]))
    n = g.num_nodes
    return g.replace(
        train_mask=index_to_mask(train, n),
        val_mask=index_to_mask(val, n),
        test_mask=index_to_mask(test, n),
    )


def random_computers_splits(g: Graph, rng: np.random.Generator) -> Graph:
    """30/class train, 20/class val, rest test (reference
    random_computers_splits, load_utils.py:61-97)."""
    indices = _per_class_indices(g.y, g.num_classes, rng)
    train = np.concatenate([i[:30] for i in indices])
    val = np.concatenate([i[30:50] for i in indices])
    test = rng.permutation(np.concatenate([i[50:] for i in indices]))
    n = g.num_nodes
    return g.replace(
        train_mask=index_to_mask(train, n),
        val_mask=index_to_mask(val, n),
        test_mask=index_to_mask(test, n),
    )


def ogb_products_splits(g: Graph, config: dict, rng: np.random.Generator) -> Graph:
    """Subsample the official split by 1/train_frac etc. (reference
    ogb_products_splits, load_utils.py:146-173)."""
    idx = g.split_idx()
    out = {}
    for part, frac_key in (
        ("train", "train_frac"),
        ("valid", "tvalid_frac"),
        ("test", "test_frac"),
    ):
        part_idx = idx[part]
        n_keep = int(part_idx.shape[0] / float(config.get(frac_key, 1)))
        out[part] = rng.permutation(part_idx)[:n_keep]
    n = g.num_nodes
    return g.replace(
        train_mask=index_to_mask(out["train"], n),
        val_mask=index_to_mask(out["valid"], n),
        test_mask=index_to_mask(out["test"], n),
    )
