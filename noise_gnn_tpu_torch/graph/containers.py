"""Graph containers.

The host-side :class:`Graph` holds numpy arrays (features, labels, COO edges,
splits), exactly as ``noise_gnn_tpu/graph/containers.py`` does;
:class:`CSRGraph` is the device-resident CSR form (torch tensors) that the
neighbor sampler and the full-graph SpMM consume. The CSR is built on the
host by the native counting sort (``native.coo_to_csr``, the JAX package's
own runtime in the port's copy), so both packages order every row's
sources alike.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..native import coo_to_csr


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_edges(edge_index: np.ndarray, multiple: int = 128):
    """Pad a [2, E] COO edge list to a multiple of ``multiple`` (at least
    one multiple). Returns (padded_edge_index int32, edge_mask bool): the
    padded entries point 0 -> 0 and are masked out."""
    e = edge_index.shape[1]
    e_pad = max(_round_up(e, multiple), multiple)
    out = np.zeros((2, e_pad), dtype=np.int32)
    out[:, :e] = edge_index
    mask = np.zeros((e_pad,), dtype=bool)
    mask[:e] = True
    return out, mask


@dataclass
class Graph:
    """Host-side graph: numpy arrays, the unit of dataset loading.

    edge_index is [2, E] int32, row 0 = source, row 1 = destination
    (messages flow source -> destination, PyG convention).
    """

    x: np.ndarray  # [N, F] float32
    y: np.ndarray  # [N] int32
    edge_index: np.ndarray  # [2, E] int32
    num_classes: int
    train_mask: np.ndarray | None = None  # [N] bool
    val_mask: np.ndarray | None = None
    test_mask: np.ndarray | None = None
    yhn: np.ndarray | None = None  # noisy labels, set by noise.flip_label
    name: str = "graph"

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)

    def to_undirected(self) -> "Graph":
        """Symmetrize + dedupe the edge list (reference: ToUndirected on arxiv,
        src/utils/load_utils.py:31-33)."""
        src, dst = self.edge_index
        both = np.concatenate(
            [self.edge_index, np.stack([dst, src])], axis=1
        )
        key = both[0].astype(np.int64) * self.num_nodes + both[1].astype(np.int64)
        _, idx = np.unique(key, return_index=True)
        return self.replace(edge_index=both[:, np.sort(idx)].astype(np.int32))

    def csr(self, device: torch.device | str = "cpu") -> "CSRGraph":
        return CSRGraph.from_coo(self.edge_index, self.num_nodes, device)

    def split_idx(self) -> dict:
        """{'train','valid','test'} index arrays from the boolean masks."""
        return {
            "train": np.nonzero(self.train_mask)[0].astype(np.int32),
            "valid": np.nonzero(self.val_mask)[0].astype(np.int32),
            "test": np.nonzero(self.test_mask)[0].astype(np.int32),
        }


@dataclass
class CSRGraph:
    """Device-resident CSR adjacency.

    Rows are destinations and columns the sources that message them, i.e.
    the CSR of the reversed edge list: ``indices[indptr[i]:indptr[i+1]]``
    are exactly the j with (j -> i) in E, the in-neighbors the sampler
    expands (reference: src/pipeline.py:75).
    """

    indptr: torch.Tensor  # [N+1] int64
    indices: torch.Tensor  # [E] int32, grouped by destination row
    num_nodes: int

    @classmethod
    def from_coo(cls, edge_index: np.ndarray, num_nodes: int,
                 device: torch.device | str = "cpu") -> "CSRGraph":
        indptr, indices = coo_to_csr(edge_index[0], edge_index[1], int(num_nodes))
        return cls(
            indptr=torch.from_numpy(indptr).to(device),
            indices=torch.from_numpy(indices).to(device),
            num_nodes=int(num_nodes),
        )

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def edge_index(self) -> torch.Tensor:
        """The [2, E] int64 (source, destination) COO view, in CSR order."""
        dst = torch.repeat_interleave(
            torch.arange(self.num_nodes, device=self.indices.device), self.degrees())
        return torch.stack([self.indices.long(), dst])
