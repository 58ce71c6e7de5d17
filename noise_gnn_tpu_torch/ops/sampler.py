"""On-device fanout neighbor sampling into a dense k-hop tree.

Port of ``noise_gnn_tpu/ops/sampler.py`` (the ``NeighborLoader``
replacement, reference src/pipeline.py:75-92). The tree has static shapes:

    depth 0: the B seed nodes
    depth d: [B * f1 * ... * fd] sampled in-neighbors of depth d-1

Semantics kept from the JAX package:
  * deg <= fanout: ALL neighbors taken (offsets 0..deg-1, rest masked);
  * deg  > fanout: fanout i.i.d. uniform picks (with replacement);
  * padding masks (a masked parent has only masked children);
  * child-major order (children of frontier[i] occupy i*f .. (i+1)*f - 1).

The tree also has a flat subgraph view with PyG's seed-first contract:
local nodes 0..B-1 are the seeds, ``flat_n_id`` maps local -> global, and
``flat_edge_index`` points each child at its parent.

Random numbers come from an explicit ``torch.Generator`` on the graph's
device; they cannot equal ``jax.random``'s, so the tests compare exactly
only where no pick is random (every in-degree <= fanout). Under data
parallelism (a ``mesh``, ``parallel/mesh.py``) each rank samples the tree
of its own block of seeds but draws the whole batch's uniforms and keeps
its rows: a seed's subtree is a contiguous block of rows at every hop
(child-major), so the ranks' trees are the rows of the one-process tree,
as the JAX package's partitionable draws are.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import count


class TreeBatch(NamedTuple):
    """Static-shape sampled k-hop tree."""

    n_ids: tuple[torch.Tensor, ...]  # n_ids[d]: [B * prod(fanouts[:d])] int64 ids
    masks: tuple[torch.Tensor, ...]  # same shapes, True = real node
    fanouts: tuple[int, ...]
    batch_size: int

    def gather_features(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [x[ids] for ids in self.n_ids]

    @property
    def num_sub_nodes(self) -> int:
        """Rows of the flat subgraph view: the tree's nodes at every depth."""
        return int(sum(ids.shape[0] for ids in self.n_ids))

    def flat_n_id(self) -> torch.Tensor:
        return torch.cat(self.n_ids)

    def flat_node_mask(self) -> torch.Tensor:
        return torch.cat(self.masks)

    def flat_edge_mask(self) -> torch.Tensor:
        """[E_sub] bool: which structural child -> parent edges are real."""
        if len(self.masks) > 1:
            return torch.cat(self.masks[1:])
        return torch.zeros((0,), dtype=torch.bool, device=self.masks[0].device)

    def flat_edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(edge_index_local [2, E_sub] int64, edge_mask [E_sub]): child -> parent."""
        ei = flat_edge_index(self.batch_size, self.fanouts)
        return torch.from_numpy(ei).to(self.masks[0].device).long(), self.flat_edge_mask()


@functools.lru_cache(maxsize=64)
def flat_edge_index(batch_size: int, fanouts: tuple[int, ...]) -> np.ndarray:
    """Structural edge list of the sampled tree (constant per config): the
    child at depth d+1, flat position base_{d+1} + j, connects to its parent
    base_d + j // fanouts[d]; messages flow child -> parent."""
    sizes = [batch_size]
    for f in fanouts:
        sizes.append(sizes[-1] * f)
    bases = np.cumsum([0] + sizes[:-1])
    src, dst = [], []
    for d, f in enumerate(fanouts):
        j = np.arange(sizes[d + 1], dtype=np.int32)
        src.append(bases[d + 1] + j)
        dst.append(bases[d] + j // f)
    if not src:
        return np.zeros((2, 0), np.int32)
    return np.stack([np.concatenate(src), np.concatenate(dst)]).astype(np.int32)


def _sample_one_hop(gen: torch.Generator, indptr: torch.Tensor, indices: torch.Tensor,
                    frontier: torch.Tensor, frontier_mask: torch.Tensor, fanout: int,
                    mesh=None):
    """Sample ``fanout`` in-neighbors for every frontier node (with a
    ``mesh``: this rank's rows of the whole batch's draw).

    Returns (children [N*f] int64, child_mask [N*f] bool), child-major."""
    n = frontier.shape[0]
    start = indptr[frontier]
    deg = indptr[frontier + 1] - start
    if mesh is None:
        u = torch.rand((n, fanout), generator=gen, device=frontier.device)
    else:
        u = mesh.rand(gen, (n, fanout), frontier.device)
    off_rep = torch.floor(u * deg[:, None].float()).long()
    off_seq = torch.arange(fanout, device=frontier.device).expand(n, fanout)
    take_all = (deg <= fanout)[:, None]
    off = torch.where(take_all, off_seq, off_rep)
    valid = frontier_mask[:, None] & (off < deg[:, None])
    off = torch.minimum(off, (deg - 1).clamp(min=0)[:, None])
    if indices.numel() == 0:
        children = torch.zeros_like(off)
    else:
        # a node with no in-edges at the end of the CSR points one past the
        # last edge; clamp (its slots are masked) where JAX's gather clamps
        pos = (start[:, None] + off).clamp(max=indices.numel() - 1)
        children = indices[pos].long()
    children = torch.where(valid, children, torch.zeros_like(children))
    return children.reshape(-1), valid.reshape(-1)


def sample_khop_tree(gen: torch.Generator, csr, seeds: torch.Tensor,
                     fanouts: tuple[int, ...],
                     seed_mask: torch.Tensor | None = None, mesh=None) -> TreeBatch:
    """Sample the dense k-hop tree rooted at ``seeds`` (one hop per fanout);
    with a ``mesh``, ``seeds`` is this rank's block of the batch. While a
    profiler runs, the counter ``sample_fill`` adds each hop's real child
    slots over its allocated ones (``utils/profiling.py::count``)."""
    b = seeds.shape[0]
    if seed_mask is None:
        seed_mask = torch.ones(b, dtype=torch.bool, device=seeds.device)
    n_ids = [seeds.long()]
    masks = [seed_mask]
    for f in fanouts:
        children, child_mask = _sample_one_hop(
            gen, csr.indptr, csr.indices, n_ids[-1], masks[-1], int(f), mesh)
        n_ids.append(children)
        masks.append(child_mask)
        count("sample_fill", child_mask)
    return TreeBatch(tuple(n_ids), tuple(masks), tuple(int(f) for f in fanouts), b)
