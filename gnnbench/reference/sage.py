"""GraphSAGE forwards (reference src/models/sage.py, sagePL.py):
out = mean_{u in N(v)} h_u W_neigh + h_v W_root + b, ReLU and inverted
dropout between layers; a dense sampled tree, a flat subgraph, or the
whole graph."""

from __future__ import annotations

import torch

from .graph import neighbor_mean
from .precision import Precision


def dropout(gen: torch.Generator | None, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout from one uniform draw of x's shape: keep where
    u < 1 - rate, scaled by 1 / (1 - rate). No draw without a generator."""
    if gen is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=gen, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def conv(prec: Precision, p: dict, x_self: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
    return prec.mm(agg, p["w_neigh"]) + prec.mm(x_self, p["w_root"]) + p["b"]


def tree_logits(prec: Precision, convs: list, xs: list, masks: list, fanouts, leaf_agg,
                gen, rate: float) -> torch.Tensor:
    """Logits of the seeds (depth 0) of a dense tree. ``xs[d]`` are depth
    d's features; with ``leaf_agg`` the tree is one hop shallower and the
    deepest depth's neighbour mean is given (the exact leaf). Dropout draws
    one mask per depth array after each hidden layer, shallowest first."""
    n_layers = len(convs)
    for i, p in enumerate(convs):
        new = []
        for d in range(n_layers - i):
            if i == 0 and d == n_layers - 1 and leaf_agg is not None:
                agg = leaf_agg
            else:
                n_d, f = xs[d].shape[0], int(fanouts[d])
                m = masks[d + 1].reshape(n_d, f).float()
                xn = xs[d + 1].reshape(n_d, f, -1)
                agg = (xn * m[..., None]).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)[:, None]
            new.append(conv(prec, p, xs[d], agg))
        xs = new
        if i != n_layers - 1:
            xs = [dropout(gen, torch.relu(x), rate) for x in xs]
    return xs[0]


class FlatGraph:
    """A flat subgraph's in-edges as a list: ``src -> dst`` where ``mask``."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor, n: int):
        self.src, self.dst, self.mask, self.n = src.long(), dst.long(), mask, n

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        w = self.mask.float()
        out = torch.zeros((self.n, x.shape[1]), dtype=x.dtype, device=x.device)
        out = out.index_add(0, self.dst, x[self.src] * w[:, None])
        cnt = torch.zeros(self.n, dtype=torch.float32, device=x.device).index_add(0, self.dst, w)
        return out / cnt.clamp(min=1.0)[:, None]


def tree_flat_graph(sizes: list[int], fanouts, child_mask: torch.Tensor) -> FlatGraph:
    """The structural child -> parent edges of a flat tree (seeds first,
    then each depth's children, child-major), masked by ``child_mask``."""
    dev = child_mask.device
    src, dst, base = [], [], 0
    for d, f in enumerate(fanouts):
        j = torch.arange(sizes[d + 1], device=dev)
        src.append(base + sizes[d] + j)
        dst.append(base + torch.div(j, int(f), rounding_mode="floor"))
        base += sizes[d]
    return FlatGraph(torch.cat(src), torch.cat(dst), child_mask, sum(sizes))


def stack(prec: Precision, convs: list, x: torch.Tensor, g: FlatGraph, gen, rate: float):
    """(logits, hidden) of a SAGE stack over every row of ``x``: ``hidden``
    is the last hidden layer after its ReLU, before its dropout."""
    h = x
    for i, p in enumerate(convs):
        x = conv(prec, p, x, g.mean(x))
        if i != len(convs) - 1:
            h = torch.relu(x)
            x = dropout(gen, h, rate)
    return x, h


def noisy_input(x: torch.Tensor, noise: torch.Tensor, n_id: torch.Tensor, rate: float):
    """sagePL's noisy view: x + rate * the rows' unit-norm learned noise."""
    nr = noise[n_id]
    return x + nr / torch.sqrt((nr * nr).sum(dim=-1, keepdim=True)).clamp(min=1e-12) * rate


def full_graph_logits(prec: Precision, convs: list, x: torch.Tensor, indptr, indices,
                      x_agg: torch.Tensor) -> torch.Tensor:
    """Eval over the whole graph (no dropout): every layer aggregates over
    all in-edges; layer 1's aggregate of the raw features is ``x_agg``."""
    for i, p in enumerate(convs):
        agg = x_agg if i == 0 else neighbor_mean(prec.q(x), indptr, indices)
        x = conv(prec, p, x, agg)
        if i != len(convs) - 1:
            x = torch.relu(x)
    return x
