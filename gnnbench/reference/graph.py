"""Graph arithmetic from the raw edge list: the in-neighbour CSR, the
exact neighbour mean, and the sampler's picks replayed from its draws."""

from __future__ import annotations

import numpy as np
import torch

EDGE_CHUNK = 1 << 23  # edges gathered at once by the neighbour sums


def in_csr(edge_index: np.ndarray, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(indptr [n+1] int64, indices [E] int64): row v lists the sources of
    v's in-edges in edge-list order (a stable sort by destination)."""
    src = torch.from_numpy(np.ascontiguousarray(edge_index[0])).to(device).long()
    dst = torch.from_numpy(np.ascontiguousarray(edge_index[1])).to(device).long()
    order = torch.sort(dst, stable=True).indices
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(dst, minlength=n), 0)
    return indptr, src[order]


def neighbor_mean(x: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
                  chunk: int = EDGE_CHUNK) -> torch.Tensor:
    """out[v] = mean of x over v's in-neighbours (0 where there are none),
    summed in float32 over chunks of edges."""
    n = indptr.shape[0] - 1
    deg = indptr[1:] - indptr[:-1]
    dst = torch.repeat_interleave(torch.arange(n, device=x.device), deg)
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    for lo in range(0, indices.shape[0], chunk):
        out.index_add_(0, dst[lo:lo + chunk], x[indices[lo:lo + chunk]].float())
    return out / deg.clamp(min=1).float()[:, None]


def sample_hop(gen: torch.Generator, indptr: torch.Tensor, indices: torch.Tensor,
               frontier: torch.Tensor, frontier_mask: torch.Tensor, fanout: int):
    """``fanout`` in-neighbours of each frontier node: all of them (in CSR
    order, the rest masked) where the degree is at most the fanout, else
    i.i.d. uniform picks ``floor(u * deg)`` from one [n, fanout] draw of
    ``gen``; a masked parent has masked children. Child-major."""
    n = frontier.shape[0]
    start = indptr[frontier]
    deg = indptr[frontier + 1] - start
    u = torch.rand((n, fanout), generator=gen, device=frontier.device)
    picked = torch.floor(u * deg[:, None].float()).long()
    seq = torch.arange(fanout, device=frontier.device).expand(n, fanout)
    off = torch.where((deg <= fanout)[:, None], seq, picked)
    valid = frontier_mask[:, None] & (off < deg[:, None])
    pos = (start[:, None] + torch.minimum(off, (deg - 1).clamp(min=0)[:, None]))
    pos = pos.clamp(max=max(indices.shape[0] - 1, 0))
    children = torch.where(valid, indices[pos], torch.zeros_like(pos))
    return children.reshape(-1), valid.reshape(-1)


def sample_tree(gen, indptr, indices, seeds, seed_mask, fanouts):
    """The dense k-hop tree: (ids per depth, masks per depth)."""
    ids, masks = [seeds.long()], [seed_mask]
    for f in fanouts:
        c, m = sample_hop(gen, indptr, indices, ids[-1], masks[-1], int(f))
        ids.append(c)
        masks.append(m)
    return ids, masks
