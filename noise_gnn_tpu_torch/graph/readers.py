"""Native readers for the reference's real on-disk dataset formats.

The port's copy of ``noise_gnn_tpu/graph/readers.py`` (numpy only).

The reference loads every dataset through torch_geometric / ogb downloaders
(src/utils/load_utils.py:24-47: PygNodePropPredDataset, Planetoid,
CitationFull, Amazon). A user can drop the already-downloaded raw files
under ``data_dir`` — these parsers read the exact on-disk layouts those
libraries produce, with no PyG anywhere:

* ``read_planetoid``   — the Planetoid pickle family
  (``<root>/<name>/raw/ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}``);
  scipy-sparse feature blocks, one-hot label blocks, adjacency dict, and
  the permuted-test-row fixup. Carries the PUBLIC split (20/class train,
  500 val, test.index) exactly as PyG's Planetoid does.
* ``read_npz_graph``   — the graph2gauss/GNN-benchmark npz schema used by
  both CitationFull (``cora.npz``) and Amazon
  (``amazon_electronics_computers.npz``): CSR adjacency
  (``adj_{data,indices,indptr,shape}``), CSR or dense attributes
  (``attr_*`` / ``attr_matrix``), ``labels``. No split in the format —
  the reference draws random per-class splits (splits.py).
* ``read_ogb_nodeprop`` — the OGB node-prop csv.gz layout
  (``<root>/<ogbn_name>/raw/{edge,node-feat,node-label}.csv.gz`` plus
  ``split/<scheme>/{train,valid,test}.csv.gz``). Carries the official
  split. Parsed once, then cached to the repo's own npz schema so the
  csv.gz cost is paid a single time.

``detect_and_read`` probes the layouts in place; ``graph.datasets
.load_network`` calls it first, so dropping real raw files under ``data/``
yields a real-data parity run with no code changes.
"""

from __future__ import annotations

import glob
import gzip
import os
import pickle

import numpy as np

from .containers import Graph
from .splits import index_to_mask

__all__ = [
    "read_planetoid",
    "read_npz_graph",
    "read_ogb_nodeprop",
    "detect_and_read",
]


# --------------------------------------------------------------- planetoid


def _unpickle(path: str):
    with open(path, "rb") as f:
        # the upstream Planetoid pickles were written by python2; latin1 is
        # the standard decode for their numpy/scipy payloads
        return pickle.load(f, encoding="latin1")


def _dense(block) -> np.ndarray:
    """scipy sparse or ndarray -> dense float32."""
    if hasattr(block, "todense"):
        return np.asarray(block.todense(), dtype=np.float32)
    return np.asarray(block, dtype=np.float32)


def read_planetoid(root: str, name: str, dirname: str | None = None) -> Graph:
    """Parse ``<root>/<dirname>/raw/ind.<name>.*`` into a Graph with the
    public Planetoid split (reference: PyG ``Planetoid``,
    src/utils/load_utils.py:35-37). ``dirname`` defaults to ``name`` (the
    raw file prefix is always the lowercase dataset name)."""
    raw = os.path.join(root, dirname or name, "raw")
    p = lambda suf: os.path.join(raw, f"ind.{name}.{suf}")  # noqa: E731

    x = _dense(_unpickle(p("x")))          # [n_train, F] labelled train block
    tx = _dense(_unpickle(p("tx")))        # [n_test, F] test block
    allx = _dense(_unpickle(p("allx")))    # [n_train+n_rest, F]
    y = np.asarray(_unpickle(p("y")), np.float32)      # one-hot blocks
    ty = np.asarray(_unpickle(p("ty")), np.float32)
    ally = np.asarray(_unpickle(p("ally")), np.float32)
    graph_dict = _unpickle(p("graph"))     # {node: [neighbors]}
    test_idx = np.loadtxt(p("test.index"), dtype=np.int64).reshape(-1)

    # test rows are stored in test.index ORDER; scatter them to their node
    # ids. Some variants (citeseer) have holes in the test range — allocate
    # the full span and leave holes zero, as PyG does.
    lo, hi = int(test_idx.min()), int(test_idx.max())
    span = hi - lo + 1
    tx_full = np.zeros((span, tx.shape[1]), np.float32)
    ty_full = np.zeros((span, ty.shape[1]), np.float32)
    tx_full[test_idx - lo] = tx
    ty_full[test_idx - lo] = ty

    feats = np.concatenate([allx, tx_full], axis=0)
    onehot = np.concatenate([ally, ty_full], axis=0)
    num_nodes = feats.shape[0]
    labels = onehot.argmax(axis=1).astype(np.int32)

    srcs, dsts = [], []
    for u, nbrs in graph_dict.items():
        for v in nbrs:
            if u != v and u < num_nodes and v < num_nodes:
                srcs.append(u)
                dsts.append(v)
    ei = np.stack([np.asarray(srcs, np.int64), np.asarray(dsts, np.int64)])
    ei = np.unique(ei, axis=1).astype(np.int32)  # the dict repeats symmetric pairs

    n_train = y.shape[0]
    train_idx = np.arange(n_train)
    val_idx = np.arange(n_train, min(n_train + 500, num_nodes))
    return Graph(
        x=feats,
        y=labels,
        edge_index=ei,
        num_classes=int(onehot.shape[1]),
        name=name,
        train_mask=index_to_mask(train_idx, num_nodes),
        val_mask=index_to_mask(val_idx, num_nodes),
        test_mask=index_to_mask(test_idx, num_nodes),
    )


# ------------------------------------------- graph2gauss / GNN-benchmark npz


def read_npz_graph(path: str, name: str) -> Graph:
    """Parse the CSR npz schema shared by CitationFull (``cora.npz``) and
    Amazon (``amazon_electronics_computers.npz``) — reference
    src/utils/load_utils.py:38-47. Matches the PyG ``parse_npz`` semantics
    the reference sees: features binarized (``x[x > 0] = 1``), self-loops
    dropped, adjacency symmetrized (to_undirected). No split in the format
    (the reference draws random per-class splits; graph.splits)."""
    with np.load(path, allow_pickle=True) as z:
        keys = set(z.files)
        labels = np.asarray(z["labels"]).astype(np.int32).reshape(-1)
        n = labels.shape[0]
        indptr = np.asarray(z["adj_indptr"], np.int64)
        indices = np.asarray(z["adj_indices"], np.int64)
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr[: n + 1]))
        dst = indices[: src.shape[0]]
        if "attr_matrix" in keys:
            x = np.asarray(z["attr_matrix"], np.float32)
        else:
            a_indptr = np.asarray(z["attr_indptr"], np.int64)
            a_indices = np.asarray(z["attr_indices"], np.int64)
            a_data = np.asarray(z["attr_data"], np.float32)
            f = int(z["attr_shape"][1])
            x = np.zeros((n, f), np.float32)
            rows = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(a_indptr[: n + 1]))
            x[rows, a_indices[: rows.shape[0]]] = a_data[: rows.shape[0]]
    x = (x > 0).astype(np.float32)  # PyG parse_npz: x[x > 0] = 1
    keep = src != dst
    # to_undirected: add reverse edges, dedupe
    ei = np.stack([
        np.concatenate([src[keep], dst[keep]]),
        np.concatenate([dst[keep], src[keep]]),
    ])
    ei = np.unique(ei, axis=1).astype(np.int32)
    return Graph(
        x=x,
        y=labels,
        edge_index=ei,
        num_classes=int(labels.max()) + 1,
        name=name,
    )


# ------------------------------------------------------------ OGB node-prop


def _read_csv_gz(path: str, dtype) -> np.ndarray:
    """csv.gz -> ndarray. pandas when available (C parser, ~10x faster on
    the real node-feat files), numpy otherwise."""
    try:
        import pandas as pd

        return pd.read_csv(path, header=None, dtype=dtype).to_numpy()
    except ImportError:
        with gzip.open(path, "rt") as f:
            return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def read_ogb_nodeprop(root: str, name: str) -> Graph:
    """Parse the OGB node-prop on-disk layout for ``ogbn-arxiv`` /
    ``ogbn-products`` (reference: PygNodePropPredDataset,
    src/utils/load_utils.py:25-33), carrying the official split."""
    ddir = os.path.join(root, name.replace("-", "_"))
    raw = os.path.join(ddir, "raw")
    ei = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64).T
    x = _read_csv_gz(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    y = _read_csv_gz(
        os.path.join(raw, "node-label.csv.gz"), np.int64
    ).reshape(-1).astype(np.int32)
    n = y.shape[0]

    split_files = sorted(glob.glob(os.path.join(ddir, "split", "*",
                                                "train.csv.gz")))
    masks = {}
    if split_files:
        sdir = os.path.dirname(split_files[0])
        for part in ("train", "valid", "test"):
            idx = _read_csv_gz(os.path.join(sdir, f"{part}.csv.gz"),
                               np.int64).reshape(-1)
            masks[part] = index_to_mask(idx, n)
    return Graph(
        x=np.asarray(x, np.float32),
        y=y,
        edge_index=ei.astype(np.int32),
        num_classes=int(y.max()) + 1,
        name=name,
        train_mask=masks.get("train"),
        val_mask=masks.get("valid"),
        test_mask=masks.get("test"),
    )


# -------------------------------------------------------------- dispatcher

# which reader layout each reference dataset name uses
# (src/utils/load_utils.py:24-47)
_NPZ_FILE = {
    "cora": "cora.npz",  # CitationFull
    "computers": "amazon_electronics_computers.npz",  # Amazon
}


def detect_and_read(data_dir: str, name: str) -> Graph | None:
    """Probe ``data_dir`` for the real raw layout of ``name``; parse it if
    present, else return None (caller falls back to npz/synthetic). OGB
    parses are cached to the repo npz schema next to the raw tree."""
    if name in ("ogbn-arxiv", "ogbn-products"):
        ddir = os.path.join(data_dir, name.replace("-", "_"))
        if os.path.exists(os.path.join(ddir, "raw", "edge.csv.gz")):
            cache = os.path.join(ddir, "parsed.npz")
            if os.path.exists(cache):
                with np.load(cache) as z:
                    nn = int(z["y"].shape[0])
                    return Graph(
                        x=z["x"].astype(np.float32),
                        y=z["y"].astype(np.int32),
                        edge_index=z["edge_index"].astype(np.int32),
                        num_classes=int(z["y"].max()) + 1,
                        name=name,
                        train_mask=index_to_mask(z["train_idx"], nn),
                        val_mask=index_to_mask(z["valid_idx"], nn),
                        test_mask=index_to_mask(z["test_idx"], nn),
                    )
            g = read_ogb_nodeprop(data_dir, name)
            # cache only when the csv.gz parse cost matters (real-scale
            # graphs); tiny fixtures re-parse instantly and must not drop
            # npz files into the test tree
            if g.train_mask is not None and g.num_nodes >= 50_000:
                idx = g.split_idx()
                np.savez(cache, x=g.x, y=g.y, edge_index=g.edge_index,
                         train_idx=idx["train"], valid_idx=idx["valid"],
                         test_idx=idx["test"])
            return g
    elif name in _NPZ_FILE:
        # PyG dir casing differs per dataset class: CitationFull uses
        # name.lower() ('cora'), Amazon uses name.capitalize()
        # ('Computers') — probe both
        for d in (name, name.capitalize()):
            path = os.path.join(data_dir, d, "raw", _NPZ_FILE[name])
            if os.path.exists(path):
                return read_npz_graph(path, name)
    else:  # planetoid family (the reference uses it for pubmed)
        for d in (name, name.capitalize(), name.title()):
            if os.path.exists(os.path.join(data_dir, d, "raw",
                                           f"ind.{name}.x")):
                return read_planetoid(data_dir, name, dirname=d)
    return None
