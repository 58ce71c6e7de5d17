"""Functional GNN layers (params as plain dicts of tensors).

Port of ``noise_gnn_tpu/models/layers.py``: SAGEConv, GCNConv, linear,
batch norm, the SIMA similarity layer and PReLU. Weight
matrices keep the JAX package's ``[in, out]`` layout, so ``x @ w``; biases
are ``[out]``. Parameters stay f32 and are cast to the activation dtype at
use, so a bf16 ``compute_dtype`` runs bf16 matmuls with f32 master weights.

SAGEConv (PyG default, reference src/models/layers/sage.py:16):
    out[i] = mean_{(j->i) in E} x[j] @ W_l + b  +  x[i] @ W_r
GCNConv(normalize=False) with the self-loop the reference keeps
(src/models/layers/convolution.py:19):
    out[i] = (x[i] + sum_{(j->i) in E} x[j]) @ W + b

Three forms per conv: edge-list (``sage_conv``), dense tree
(``sage_conv_tree``: [N, K, F] neighbor blocks from the sampler) and
pre-aggregated (``sage_conv_pre``: the exact-leaf path).
"""

from __future__ import annotations

import math

import torch

from ..ops.scatter import gather_scatter_max, gather_scatter_mean, gather_scatter_sum
from ..ops.tree_agg import TreeTopo, tree_gather_scatter


def glorot(gen: torch.Generator, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """Glorot-uniform: U(-sqrt(6/(fan_in+fan_out)), +...), f32."""
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2 * limit) - limit


def linear_init(gen: torch.Generator, in_size: int, out_size: int, device=None) -> dict:
    return {"w": glorot(gen, (in_size, out_size), device),
            "b": torch.zeros(out_size, dtype=torch.float32, device=device)}


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    out = x @ params["w"].to(x.dtype)
    if "b" in params:
        out = out + params["b"].to(x.dtype)
    return out


def _neighbor_agg(x, edge_index, num_nodes, edge_mask, aggr):
    """[2, E] edge list -> gather + scatter; TreeTopo (flat tree subgraph) ->
    the scatter-free structured aggregation (ops/tree_agg.py)."""
    if isinstance(edge_index, TreeTopo):
        return tree_gather_scatter(x, edge_index, aggr=aggr)
    if aggr == "max":
        return gather_scatter_max(x, edge_index, num_nodes, edge_mask)
    if aggr == "sum":
        return gather_scatter_sum(x, edge_index, num_nodes, edge_mask)
    return gather_scatter_mean(x, edge_index, num_nodes, edge_mask)


# ---------------------------------------------------------------- SAGEConv


def sage_conv_init(gen: torch.Generator, in_size: int, out_size: int, device=None) -> dict:
    return {
        "w_neigh": glorot(gen, (in_size, out_size), device),  # PyG lin_l
        "w_root": glorot(gen, (in_size, out_size), device),  # PyG lin_r
        "b": torch.zeros(out_size, dtype=torch.float32, device=device),
    }


def sage_conv_pre(params: dict, x_self: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
    """SAGEConv from an already-aggregated neighbor feature:
    out = agg @ W_l + x_self @ W_r + b."""
    dt = x_self.dtype
    out = agg @ params["w_neigh"].to(dt) + x_self @ params["w_root"].to(dt)
    return out + params["b"].to(dt)


def sage_conv(params: dict, x: torch.Tensor, edge_index: torch.Tensor,
              num_nodes: int | None = None, edge_mask=None, aggr: str = "mean"):
    """Edge-list SAGEConv; edge_index [2, E] (messages src -> dst) or a
    TreeTopo."""
    n = num_nodes if num_nodes is not None else x.shape[0]
    agg = _neighbor_agg(x, edge_index, n, edge_mask, aggr)
    return sage_conv_pre(params, x[:n], agg)


def _tree_agg(x_neigh, neigh_mask, aggr):
    if aggr == "max":
        neg = torch.tensor(float("-inf"), dtype=x_neigh.dtype, device=x_neigh.device)
        agg = torch.where(neigh_mask[..., None], x_neigh, neg).amax(dim=1)
        return torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))
    m = neigh_mask.to(x_neigh.dtype)[..., None]
    count = m.sum(dim=1).clamp(min=1.0)
    return (x_neigh * m).sum(dim=1) / count


def sage_conv_tree(params: dict, x_self: torch.Tensor, x_neigh: torch.Tensor,
                   neigh_mask: torch.Tensor, aggr: str = "mean") -> torch.Tensor:
    """Dense-tree SAGEConv: x_self [N, F], x_neigh [N, K, F], neigh_mask
    [N, K]; mean (or max) over the sampled-neighbor axis."""
    return sage_conv_pre(params, x_self, _tree_agg(x_neigh, neigh_mask, aggr))


# ----------------------------------------------------------------- GCNConv


def gcn_conv_init(gen: torch.Generator, in_size: int, out_size: int, device=None) -> dict:
    return {
        "w": glorot(gen, (in_size, out_size), device),
        "b": torch.zeros(out_size, dtype=torch.float32, device=device),
    }


def gcn_conv_pre(params: dict, x_self: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
    """GCNConv(normalize=False) from a precomputed neighbor SUM:
    out = (agg + x_self) @ W + b."""
    dt = x_self.dtype
    return (agg + x_self) @ params["w"].to(dt) + params["b"].to(dt)


def gcn_conv(params: dict, x: torch.Tensor, edge_index: torch.Tensor,
             num_nodes: int | None = None, edge_mask=None) -> torch.Tensor:
    """GCNConv(normalize=False): neighbor-sum + self loop, then linear."""
    n = num_nodes if num_nodes is not None else x.shape[0]
    agg = _neighbor_agg(x, edge_index, n, edge_mask, "sum")
    return gcn_conv_pre(params, x[:n], agg)


def gcn_conv_tree(params: dict, x_self: torch.Tensor, x_neigh: torch.Tensor,
                  neigh_mask: torch.Tensor) -> torch.Tensor:
    m = neigh_mask.to(x_neigh.dtype)[..., None]
    return gcn_conv_pre(params, x_self, (x_neigh * m).sum(dim=1))


# ---------------------------------------------------------------- dropout


def dropout(gen: torch.Generator | None, x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout with an explicit generator: keep with prob 1-rate,
    scale kept values by 1/(1-rate)."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


# -------------------------------------------------------------- batch norm


def batch_norm_init(size: int, device=None) -> dict:
    return {"scale": torch.ones(size, dtype=torch.float32, device=device),
            "bias": torch.zeros(size, dtype=torch.float32, device=device)}


def batch_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalization by the batch's statistics in training and at eval alike
    (the reference's nn.BatchNorm1d is only exercised in training), with
    the population variance. As ``jnp.mean``/``jnp.var`` do, the mean and
    the two-pass variance are taken in f32 and rounded to x's dtype, and
    the rest runs in x's dtype, ``eps`` included, with the reciprocal root
    rounded once from f32 (the CPU's bf16 ``rsqrt`` rounds twice)."""
    xf = x.float()
    mean = xf.mean(dim=0, keepdim=True)
    var = (xf - mean).square().mean(dim=0, keepdim=True)
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    inv = torch.rsqrt((var + torch.tensor(eps, dtype=x.dtype, device=x.device)).float())
    xn = (x - mean) * inv.to(x.dtype)
    return xn * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


# ------------------------------------------------------------------- SIMA


def sima_init(gen: torch.Generator, nbr_nodes: int, nbr_features: int, device=None) -> dict:
    """Learned pairwise-similarity layer (reference attention.py:5-21 SIMA,
    which no pipeline of the reference imports): two [F, N] projections,
    standard-normal init."""
    return {"w_i": torch.randn((nbr_features, nbr_nodes), generator=gen, device=device),
            "w_j": torch.randn((nbr_features, nbr_nodes), generator=gen, device=device)}


def sima(params: dict, x: torch.Tensor, rate: float = 0.5, train: bool = False,
         gen: torch.Generator | None = None) -> torch.Tensor:
    """similarity = drop(relu(x W_i)) @ drop(relu(x W_j))^T -> [N, N]: both
    projections ReLU'd and dropped out on their own, each with a mask
    drawn from ``gen`` (reference attention.py:13-20)."""
    ai = torch.relu(x @ params["w_i"].to(x.dtype))
    aj = torch.relu(x @ params["w_j"].to(x.dtype))
    ai = dropout(gen, ai, rate, train)
    aj = dropout(gen, aj, rate, train)
    return ai @ aj.T


# ------------------------------------------------------------------ PReLU


def prelu_init(device=None) -> dict:
    return {"alpha": torch.tensor(0.25, dtype=torch.float32, device=device)}


def prelu(params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, params["alpha"].to(x.dtype) * x)
