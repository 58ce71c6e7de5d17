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

Multi-head GATConv (PyG's defaults: one shared projection, LeakyReLU 0.2
scores, no attention dropout), with the skip ``Linear`` of PyG's ogbn-products
example, in the same forms (``models/nets.py`` composes them):
    h = x @ W  ([n, H * C]),  s_src = <h[., head], att_src[head]>,
    s_dst = <h[., head], att_dst[head]>  (``gat_scores``),
    out[i] = sum_{j in N(i) + i} softmax_j(LeakyReLU(s_src[j] + s_dst[i])) h[j]
             (heads concatenated, or averaged in a last layer) + b
             + x[i] @ W_skip + b_skip  (``gat_out``);
the tree form attends over a parent's sampled child slots and the parent
itself (``gat_tree_attend``), the edge-list and full-graph forms over the
in-edges with self-loops removed and one added (``ops/gat_attn.py``).

Every weight product goes through :func:`tp_matmul`: the plain product for
a whole weight, and under tensor parallelism (a ``mesh`` whose model axis
has M > 1 ranks) Megatron's column-parallel product for a weight of which
this rank holds a block of columns. Every form takes the ``mesh``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.scatter import gather_scatter_max, gather_scatter_mean, gather_scatter_sum
from ..ops.tree_agg import TreeTopo, tree_gather_scatter
from ..parallel.mesh import gather_cols, model_input, sum_ranks


def glorot(gen: torch.Generator, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """Glorot-uniform: U(-sqrt(6/(fan_in+fan_out)), +...), f32."""
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2 * limit) - limit


def linear_init(gen: torch.Generator, in_size: int, out_size: int, device=None) -> dict:
    return {"w": glorot(gen, (in_size, out_size), device),
            "b": torch.zeros(out_size, dtype=torch.float32, device=device)}


def tp_matmul(pairs, out: int, mesh=None) -> torch.Tensor:
    """``x1 @ w1 + x2 @ w2 + ...`` over ``pairs`` [(x, w), ...], [n, out].
    Weights of ``out`` columns are whole: the plain products, summed in
    order. Weights of out / M columns are this rank's blocks of
    column-sharded weights (``parallel/mesh.py::param_sharding``), and the
    product is Megatron's column-parallel layer: (a) the inputs pass
    unchanged, and their gradients are summed over the model axis in
    backward (``model_input``: each rank's ``dy_local @ w_local^T`` is a
    share of them); (b) the local products, summed; (c) the column blocks
    all-gathered over the model axis (``gather_cols``), whose backward
    keeps this rank's columns. Everything after it is replicated over the
    model axis, so a bias added after it gets the same whole gradient on
    every model rank."""
    dt = pairs[0][0].dtype
    cols = pairs[0][1].shape[-1]
    sharded = cols != out
    if sharded:
        m = 1 if mesh is None else mesh.model_size
        if m == 1 or cols * m != out:
            raise ValueError(f"a weight of {cols} columns for {out} outputs: not a column "
                             f"block of a model axis of {m}")
        pairs = list(zip(model_input(mesh, *(x for x, _ in pairs)), (w for _, w in pairs)))
    acc = None
    for x, w in pairs:
        y = x @ w.to(dt)
        acc = y if acc is None else acc + y
    return gather_cols(mesh, acc) if sharded else acc


def linear(params: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x @ w + b`` (with a bias: its width is the output's; without one,
    the weight is whole)."""
    out_size = params["b"].shape[0] if "b" in params else params["w"].shape[-1]
    out = tp_matmul([(x, params["w"])], out_size, mesh)
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


def sage_conv_pre(params: dict, x_self: torch.Tensor, agg: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """SAGEConv from an already-aggregated neighbor feature:
    out = agg @ W_l + x_self @ W_r + b."""
    out = tp_matmul([(agg, params["w_neigh"]), (x_self, params["w_root"])],
                    params["b"].shape[0], mesh)
    return out + params["b"].to(x_self.dtype)


def sage_conv(params: dict, x: torch.Tensor, edge_index: torch.Tensor,
              num_nodes: int | None = None, edge_mask=None, aggr: str = "mean", mesh=None):
    """Edge-list SAGEConv; edge_index [2, E] (messages src -> dst) or a
    TreeTopo."""
    n = num_nodes if num_nodes is not None else x.shape[0]
    agg = _neighbor_agg(x, edge_index, n, edge_mask, aggr)
    return sage_conv_pre(params, x[:n], agg, mesh)


def _tree_agg(x_neigh, neigh_mask, aggr):
    if aggr == "max":
        agg = torch.where(neigh_mask[..., None], x_neigh, float("-inf")).amax(dim=1)
        return torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))
    m = neigh_mask.to(x_neigh.dtype)[..., None]
    count = m.sum(dim=1).clamp(min=1.0)
    return (x_neigh * m).sum(dim=1) / count


def sage_conv_tree(params: dict, x_self: torch.Tensor, x_neigh: torch.Tensor,
                   neigh_mask: torch.Tensor, aggr: str = "mean", mesh=None) -> torch.Tensor:
    """Dense-tree SAGEConv: x_self [N, F], x_neigh [N, K, F], neigh_mask
    [N, K]; mean (or max) over the sampled-neighbor axis."""
    return sage_conv_pre(params, x_self, _tree_agg(x_neigh, neigh_mask, aggr), mesh)


# ----------------------------------------------------------------- GCNConv


def gcn_conv_init(gen: torch.Generator, in_size: int, out_size: int, device=None) -> dict:
    return {
        "w": glorot(gen, (in_size, out_size), device),
        "b": torch.zeros(out_size, dtype=torch.float32, device=device),
    }


def gcn_conv_pre(params: dict, x_self: torch.Tensor, agg: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """GCNConv(normalize=False) from a precomputed neighbor SUM:
    out = (agg + x_self) @ W + b."""
    out = tp_matmul([(agg + x_self, params["w"])], params["b"].shape[0], mesh)
    return out + params["b"].to(x_self.dtype)


def gcn_conv(params: dict, x: torch.Tensor, edge_index: torch.Tensor,
             num_nodes: int | None = None, edge_mask=None, mesh=None) -> torch.Tensor:
    """GCNConv(normalize=False): neighbor-sum + self loop, then linear."""
    n = num_nodes if num_nodes is not None else x.shape[0]
    agg = _neighbor_agg(x, edge_index, n, edge_mask, "sum")
    return gcn_conv_pre(params, x[:n], agg, mesh)


def gcn_conv_tree(params: dict, x_self: torch.Tensor, x_neigh: torch.Tensor,
                  neigh_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    m = neigh_mask.to(x_neigh.dtype)[..., None]
    return gcn_conv_pre(params, x_self, (x_neigh * m).sum(dim=1), mesh)


# ---------------------------------------------------------------- dropout


def dropout(gen: torch.Generator | None, x: torch.Tensor, rate: float,
            train: bool, mesh=None, flat=None) -> torch.Tensor:
    """Inverted dropout with an explicit generator: keep with prob 1-rate,
    scale kept values by 1/(1-rate). With a ``mesh`` (data parallelism),
    x holds this rank's rows of the batch's, and its mask is those rows of
    the whole batch's draw, so the masks equal the one-process masks: one
    block of the rows (``parallel/mesh.py::Mesh.rand``), or, for a flat
    subgraph whose per-depth row counts here are ``flat``, the rank's
    block of each depth (``Mesh.rand_flat``). The model axis draws nothing
    of its own: x is whole over it."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    if mesh is None:
        u = torch.rand(x.shape, generator=gen, device=x.device)
    elif flat is not None:
        u = mesh.rand_flat(gen, flat, x.shape, x.device)
    else:
        u = mesh.rand(gen, x.shape, x.device)
    mask = u < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


# -------------------------------------------------------------- batch norm


def batch_norm_init(size: int, device=None) -> dict:
    return {"scale": torch.ones(size, dtype=torch.float32, device=device),
            "bias": torch.zeros(size, dtype=torch.float32, device=device)}


def batch_norm(params: dict, x: torch.Tensor, eps: float = 1e-5, mesh=None) -> torch.Tensor:
    """Normalization by the batch's statistics in training and at eval alike
    (the reference's nn.BatchNorm1d is only exercised in training), with
    the population variance. As ``jnp.mean``/``jnp.var`` do, the mean and
    the two-pass variance are taken in f32 and rounded to x's dtype, and
    the rest runs in x's dtype, ``eps`` included, with the reciprocal root
    rounded once from f32 (the CPU's bf16 ``rsqrt`` rounds twice). With a
    ``mesh`` of several ranks x is this rank's rows of the batch (every
    rank holding as many), and the two passes' sums run over every rank's
    rows (``parallel/mesh.py::sum_ranks``), as GSPMD takes the JAX
    package's over the sharded array."""
    xf = x.float()
    if mesh is None or mesh.size == 1:
        mean = xf.mean(dim=0, keepdim=True)
        var = (xf - mean).square().mean(dim=0, keepdim=True)
    else:
        n = xf.shape[0] * mesh.size
        mean = sum_ranks(mesh, xf.sum(dim=0, keepdim=True)) / n
        var = sum_ranks(mesh, (xf - mean).square().sum(dim=0, keepdim=True)) / n
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    inv = torch.rsqrt((var + torch.full((), eps, dtype=x.dtype, device=x.device)).float())
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


# -------------------------------------------------------- multi-head GAT


def gat_conv_init(gen: torch.Generator, in_size: int, heads: int, out_per_head: int,
                  concat: bool, device=None) -> dict:
    """A GATConv layer with its skip linear: Glorot ``w`` [in, H * C],
    ``att_src`` and ``att_dst`` [H, C] (PyG's glorot over [1, H, C]) and
    ``skip_w`` [in, out] (out = H * C concatenated, else C), drawn in that
    order; zero ``b`` [out] and ``skip_b`` [out]."""
    hc = heads * out_per_head
    out = hc if concat else out_per_head
    zeros = torch.zeros(out, dtype=torch.float32, device=device)
    return {"w": glorot(gen, (in_size, hc), device),
            "att_src": glorot(gen, (heads, out_per_head), device),
            "att_dst": glorot(gen, (heads, out_per_head), device),
            "b": zeros,
            "skip_w": glorot(gen, (in_size, out), device),
            "skip_b": zeros.clone()}


def _att_matrix(att_src: torch.Tensor, att_dst: torch.Tensor, dtype) -> torch.Tensor:
    """[H * C, 2H]: column h holds att_src[h] on head h's rows, column H + h
    att_dst[h], zeros elsewhere."""
    heads = att_src.shape[0]
    eye = torch.eye(heads, dtype=att_src.dtype, device=att_src.device)
    a = torch.cat([att_src[:, :, None] * eye[:, None, :], att_dst[:, :, None] * eye[:, None, :]],
                  dim=2)
    return a.reshape(-1, 2 * heads).to(dtype)


def gat_scores(h: torch.Tensor, att_src: torch.Tensor, att_dst: torch.Tensor):
    """(s_src, s_dst), each [n, H] float32: every head's projected features
    against its attention vectors, as one [n, H * C] x [H * C, 2H] product
    in h's dtype (fp32 accumulation), rounded once."""
    heads = att_src.shape[0]
    s = (h @ _att_matrix(att_src, att_dst, h.dtype)).float()
    return s[:, :heads], s[:, heads:]


def gat_tree_attend(h_par: torch.Tensor, s_par, h_child: torch.Tensor, s_child,
                    mask: torch.Tensor) -> torch.Tensor:
    """Each parent row i of h_par [n, H * C] attends over its f child slots
    h_child [n * f, H * C] (valid where mask [n, f]) and itself: scores
    [n, f + 1, H], a masked softmax over the slots in float32, then the
    weighted sum in h's dtype; [n, H * C]. ``s_par``/``s_child`` are the
    rows' (s_src, s_dst) from :func:`gat_scores`."""
    n, f = mask.shape
    heads = s_par[0].shape[1]
    s_dst = s_par[1][:, None, :]
    kids = (s_child[0].view(n, f, heads) + s_dst).masked_fill(~mask[..., None], float("-inf"))
    e = F.leaky_relu(torch.cat([s_par[0][:, None, :] + s_dst, kids], dim=1), 0.2)
    a = torch.softmax(e, dim=1).to(h_par.dtype)
    c = h_par.shape[-1] // heads
    own = a[:, 0, :, None] * h_par.view(n, heads, c)
    kids = (a[:, 1:, :, None] * h_child.view(n, f, heads, c)).sum(dim=1)
    return (own + kids).view(n, heads * c)


def gat_out(params: dict, agg: torch.Tensor, x_self: torch.Tensor, concat: bool) -> torch.Tensor:
    """A GAT layer's output from its attention ``agg`` [n, H * C]: the
    heads as they are (concatenated) or averaged, plus the bias, plus the
    skip linear of the row's input; one product with both biases, then
    one add."""
    if not concat:
        heads = params["att_src"].shape[0]
        agg = agg.view(agg.shape[0], heads, -1).mean(dim=1)
    dt = x_self.dtype
    bias = (params["b"] + params["skip_b"]).to(dt)
    return torch.addmm(bias, x_self, params["skip_w"].to(dt)).add_(agg)
