"""SAGE, GCN, sagePL, sageH, sageFC, gcn_head and GAT networks: edge-list
forward (``apply``) and dense k-hop tree forward (``apply_tree``), with
params as plain dicts of f32 tensors.

Port of ``noise_gnn_tpu/models/nets.py``. Params have the JAX pytree's
structure, ``{"convs": [{"w_neigh", "w_root", "b"} | {"w", "b"}, ...]}``
with weights ``[in, out]``, plus ``"noise"`` [nbr_nodes, in_size] for
sagePL, ``"proj"`` {"w", "b"} and ``"bnl"`` {"scale", "bias"} for sageFC,
``"act"`` {"alpha"} for sageH and sageFC, and ``"bn1"`` [in_size] and
``"bn2"`` [hidden] {"scale", "bias"} under ``use_bn``; GAT's are
``{"layers": [{"w" [in, out], "a" [2 out, 1]}, ...]}`` (``models/convert.py``
maps one to the other). With a bf16 ``compute_dtype`` activations run in
bf16 and the outputs come back f32.

``use_bn`` (reference sage.py:21-24) normalizes the input with ``bn1`` and
each inter-layer ReLU's output with ``bn2`` by the batch's own statistics
(``layers.batch_norm``), in the tree forward one depth array at a time;
under data parallelism the statistics span every rank's rows.
GAT (reference attention.py, dead code there) is dense masked attention
over the [n, n] adjacency of an edge list; it has no tree forward, so it
trains on the flat subgraph of a sampled tree (the baseline epoch) and
evaluates on the full edge list.

sagePL (reference sagePL.py) is a SAGE stack with a learned per-node input
noise: ``apply`` runs a pure pass and a pass on ``x + 0.1 * normalize(noise
[n_id])`` and returns both branches' (hidden, log-softmax, logits). Its
tree forward is not ported: the CTP and TE steps run ``apply`` on the flat
subgraph. sageH (reference sageH.py) also returns ``h``, the post-ReLU
hidden of the last non-final layer before its dropout; sageFC (sageFC.py)
returns ``h = batch_norm(bnl, proj(h))`` instead. Both carry a PReLU
(``act``) that their forward never uses, as the reference's do. gcn_head
(gcn.py) is a dropout of the input and the first conv alone, though its
params hold ``num_layers`` convs, as the JAX package builds them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.scatter import fast_take
from ..ops.tree_agg import TreeTopo
from ..parallel.mesh import gather_cols
from .layers import (
    batch_norm,
    batch_norm_init,
    dropout,
    gcn_conv,
    gcn_conv_init,
    gcn_conv_pre,
    gcn_conv_tree,
    glorot,
    linear,
    linear_init,
    prelu_init,
    sage_conv,
    sage_conv_init,
    sage_conv_pre,
    sage_conv_tree,
    tp_matmul,
)

MODULES = ("sage", "gcn", "sagePL", "sageH", "sageFC", "gcn_head", "gat")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class NetSpec:
    """Static architecture description (reference src/models/model.py:14-35)."""

    module: str = "sage"
    in_size: int = 100
    hidden_size: int = 128
    out_size: int = 47
    num_layers: int = 2
    dropout: float = 0.5
    use_bn: bool = False
    nbr_nodes: int = 1  # rows of sagePL's per-node noise parameter
    proj_size: int = 128  # sageFC's projection head width
    aggr: str = "mean"  # SAGE neighbor aggregation: 'mean' | 'max'
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.module not in MODULES:
            raise ValueError(f"unknown module {self.module!r} (modules: {MODULES})")

    def layer_sizes(self) -> list[tuple[int, int]]:
        sizes = []
        for i in range(self.num_layers):
            fin = self.in_size if i == 0 else self.hidden_size
            fout = self.out_size if i == self.num_layers - 1 else self.hidden_size
            sizes.append((fin, fout))
        return sizes

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def make_network(config: dict, in_size: int, out_size: int, nbr_nodes: int = 1) -> NetSpec:
    """Build a NetSpec from a reference-style config dict."""
    return NetSpec(
        module=config.get("module", "sage"),
        in_size=in_size,
        hidden_size=int(config.get("hidden_size", 128)),
        out_size=out_size,
        num_layers=int(config.get("num_layers", 2)),
        dropout=float(config.get("dropout", 0.5)),
        use_bn=bool(config.get("use_bn", False)),
        nbr_nodes=nbr_nodes,
        compute_dtype=str(config.get("compute_dtype", "float32")),
        aggr=str(config.get("aggr", "mean")),
    )


def init_params(gen: torch.Generator, spec: NetSpec, device=None) -> dict:
    """Glorot weights, zero biases (and sagePL's N(0, 1) per-node noise),
    drawn from ``gen`` on ``device``; unit-scale, zero-bias batch norms."""
    if spec.module == "gat":
        return _gat_init(gen, spec, device)
    init = gcn_conv_init if spec.module == "gcn" else sage_conv_init
    params = {"convs": [init(gen, fin, fout, device) for fin, fout in spec.layer_sizes()]}
    if spec.use_bn:
        params["bn1"] = batch_norm_init(spec.in_size, device)
        params["bn2"] = batch_norm_init(spec.hidden_size, device)
    if spec.module == "sagePL":
        # learned per-node input noise (reference sagePL.py:22)
        params["noise"] = torch.randn((spec.nbr_nodes, spec.in_size), generator=gen,
                                      device=device, dtype=torch.float32)
    if spec.module == "sageFC":
        params["proj"] = linear_init(gen, spec.hidden_size, spec.proj_size, device)
        params["bnl"] = batch_norm_init(spec.proj_size, device)
    if spec.module in ("sageH", "sageFC"):
        params["act"] = prelu_init(device)  # in the reference, unused by its forward
    return params


def parameters(params: dict) -> list[torch.Tensor]:
    """The leaf tensors of a params dict, in a fixed order (for optimizers):
    each conv's (or GAT layer's) by sorted key, then ``noise``, ``bn1``,
    ``bn2``, ``proj``, ``bnl`` and ``act`` where present."""
    leaves = [p[k] for p in params.get("convs", params.get("layers")) for k in sorted(p)]
    if "noise" in params:
        leaves.append(params["noise"])
    for name in ("bn1", "bn2", "proj", "bnl", "act"):
        if name in params:
            leaves += [params[name][k] for k in sorted(params[name])]
    return leaves


def _conv(spec, p, x, edge_index, num_nodes, edge_mask, mesh=None):
    if spec.module == "gcn":
        return gcn_conv(p, x, edge_index, num_nodes, edge_mask, mesh)
    return sage_conv(p, x, edge_index, num_nodes, edge_mask, aggr=spec.aggr, mesh=mesh)


def _conv_tree(spec, p, x_self, x_neigh, mask, mesh=None):
    if spec.module == "gcn":
        return gcn_conv_tree(p, x_self, x_neigh, mask, mesh)
    return sage_conv_tree(p, x_self, x_neigh, mask, aggr=spec.aggr, mesh=mesh)


def _conv_pre(spec, p, x_self, agg, mesh=None):
    if spec.module == "gcn":
        return gcn_conv_pre(p, x_self, agg, mesh)
    return sage_conv_pre(p, x_self, agg, mesh)


def _l2_normalize_rows(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(dim=1) parity: v / max(||v||_2, eps)."""
    return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True)).clamp(min=eps)


def _stack_forward(spec, params, x, edge_index, n, edge_mask, train, gen, mesh=None):
    """[bn1] -> conv -> (relu, [bn2], dropout) between layers. Returns
    (logits, h): h is the post-ReLU (post-bn2) hidden of the last non-final
    layer, before its dropout (reference sagePL.py:60). With a ``mesh`` the
    rows are this rank's own flat subgraph (``edge_index`` a TreeTopo)."""
    flat = None if mesh is None else edge_index.sizes
    h = x
    if spec.use_bn:
        x = batch_norm(params["bn1"], x, mesh=mesh)
    for i, p in enumerate(params["convs"]):
        x = _conv(spec, p, x, edge_index, n, edge_mask, mesh)
        if i != spec.num_layers - 1:
            x = h = _relu_bn(spec, params, x, mesh)
            x = dropout(gen, x, spec.dropout, train, mesh, flat)
    return x, h


def _relu_bn(spec, params, x, mesh=None):
    x = torch.relu(x)
    return batch_norm(params["bn2"], x, mesh=mesh) if spec.use_bn else x


def _heads(spec: NetSpec, params: dict, z: torch.Tensor, h: torch.Tensor, mesh=None) -> dict:
    """The outputs of a plain stack from its logits ``z`` and hidden ``h``
    (sageFC's ``bnl`` takes its statistics over every rank's rows)."""
    if spec.module == "sageH":
        return {"logits": z.float(), "h": h.float()}
    if spec.module == "sageFC":
        return {"logits": z.float(),
                "h": batch_norm(params["bnl"], linear(params["proj"], h.float(), mesh),
                                mesh=mesh)}
    return {"logits": z.float()}


def apply(spec: NetSpec, params: dict, x: torch.Tensor, edge_index, *,
          num_nodes: int | None = None, edge_mask=None, train: bool = False,
          gen: torch.Generator | None = None, n_id: torch.Tensor | None = None,
          noise_rate: float = 0.1, branch: str | None = None, mesh=None) -> dict:
    """Edge-list forward (``edge_index`` [2, E] or a TreeTopo). Returns
    {"logits"} for sage/gcn/gcn_head, {"logits", "h"} for sageH/sageFC and,
    for sagePL, {"h_pure", "y_pure", "z_pure",
    "h_noisy", "y_noisy", "z_noisy"}, all f32; ``n_id`` maps the rows of x
    to the graph's nodes, whose noise rows the noisy pass adds. ``branch``
    ("pure" or "noisy") runs only that sagePL pass and returns its three
    outputs: the JAX package's jitted steps never compute a pass whose
    outputs they do not read. ``gat`` takes an edge list, not a TreeTopo.
    With a ``mesh`` (data parallelism) ``edge_index`` is this rank's own
    flat subgraph, a TreeTopo: its dropout masks are its rows of the whole
    subgraph's draws, and batch norm takes its statistics over every rank's
    rows (GAT, which has neither, takes the rank's own subgraph as it is).
    With a model axis (tensor parallelism) the params are this rank's
    (``models/convert.py::shard_params``): the products of sharded weights
    run column-parallel (``layers.tp_matmul``), and sagePL's sharded
    ``noise`` rows are gathered whole."""
    n = num_nodes if num_nodes is not None else x.shape[0]
    x = x.to(spec.dtype)
    if spec.module == "gat":
        return {"logits": _gat_forward(spec, params, x, edge_index, n, edge_mask, mesh).float()}
    if mesh is not None and not isinstance(edge_index, TreeTopo):
        raise ValueError("a flat forward under a mesh takes the rank's flat subgraph as a "
                         "TreeTopo")
    if spec.module == "gcn_head":
        # dropout of the input, then the first conv alone (reference gcn.py:19-23)
        x = dropout(gen, x, spec.dropout, train, mesh, None if mesh is None else edge_index.sizes)
        return {"logits": sage_conv(params["convs"][0], x, edge_index, n, edge_mask,
                                    mesh=mesh).float()}
    if spec.module != "sagePL":
        z, h = _stack_forward(spec, params, x, edge_index, n, edge_mask, train, gen, mesh)
        return _heads(spec, params, z, h, mesh)
    out = {}
    if branch != "noisy":
        z, h = _stack_forward(spec, params, x, edge_index, n, edge_mask, train, gen, mesh)
        out.update(h_pure=h.float(), y_pure=torch.log_softmax(z.float(), dim=-1),
                   z_pure=z.float())
    if branch != "pure":
        noise = params["noise"]
        nr = fast_take(noise, n_id) if n_id is not None else noise[:x.shape[0]]
        if nr.shape[1] != x.shape[1]:  # this rank's columns: the rows read, gathered whole
            nr = gather_cols(mesh, nr)
        x_noisy = x + (_l2_normalize_rows(nr) * noise_rate).to(x.dtype)
        z, h = _stack_forward(spec, params, x_noisy, edge_index, n, edge_mask, train, gen, mesh)
        out.update(h_noisy=h.float(), y_noisy=torch.log_softmax(z.float(), dim=-1),
                   z_noisy=z.float())
    return out


def apply_tree(spec: NetSpec, params: dict, xs: list[torch.Tensor],
               masks: list[torch.Tensor], fanouts: tuple[int, ...], *,
               train: bool = False, gen: torch.Generator | None = None,
               leaf_agg: torch.Tensor | None = None, mesh=None) -> dict:
    """Dense k-hop tree forward; rows of the result are the seeds.

    xs[d]: [N_d, F] features of depth-d tree nodes (N_d = B *
    prod(fanouts[:d])), masks[d]: [N_d] validity. Layer i maps depths
    0..L-1-i to depths 0..L-1-i. With ``leaf_agg`` [N_{L-1}, F] (exact-leaf
    mode) the tree is one hop shallower and the first layer's deepest conv
    uses the precomputed neighbor aggregate. Dropout draws one mask per
    depth array from ``gen``. Under ``use_bn`` each depth array is
    normalized on its own, by statistics over ALL its rows: the masked
    (invalid) rows and a padded batch's seeds count, exactly as the JAX
    package's ``jnp.mean``/``jnp.var`` over the whole array do (masking
    them out would change the numbers); exact-leaf mode is refused there,
    as in the JAX package. With a ``mesh`` (data parallelism) the tree is
    this rank's block of the batch's seeds, each dropout mask is that block
    of the whole batch's draw, and batch norm takes its statistics over
    every rank's block of the depth array. Under tensor parallelism the
    products run as :func:`apply`'s do. Returns what :func:`apply` returns,
    with the seeds as rows."""
    if spec.module == "sagePL":
        raise NotImplementedError("apply_tree for sagePL is not yet ported to "
                                  "noise_gnn_tpu_torch (the CTP and TE steps run apply "
                                  "on the flat subgraph)")
    if spec.module == "gat":
        raise NotImplementedError(
            "module 'gat' has no tree forward: the JAX package trains it only in the "
            "baseline epoch (the edge-list forward on the flat subgraph), and its "
            "co-teaching step fails there, so the port refuses it too")
    exact = leaf_agg is not None
    if exact and spec.module == "gcn_head":
        raise ValueError("exact-leaf mode unsupported for module 'gcn_head'")
    if exact and spec.use_bn:
        raise ValueError("exact-leaf mode is incompatible with input batch norm")
    xs = [x.to(spec.dtype) for x in xs]
    if spec.module == "gcn_head":
        xs = [dropout(gen, x, spec.dropout, train, mesh) for x in xs]
        n0, f = xs[0].shape[0], fanouts[0]
        return {"logits": sage_conv_tree(params["convs"][0], xs[0],
                                         xs[1].reshape(n0, f, xs[1].shape[-1]),
                                         masks[1].reshape(n0, f), mesh=mesh).float()}
    L = spec.num_layers
    want = L if exact else L + 1
    if len(xs) != want:
        raise ValueError(f"need {want} depth arrays, got {len(xs)}")
    h = xs[0]
    if spec.use_bn:
        xs = [batch_norm(params["bn1"], x, mesh=mesh) for x in xs]
    for i, p in enumerate(params["convs"]):
        new_xs = []
        for d in range(L - i):
            if i == 0 and d == L - 1 and exact:
                new_xs.append(_conv_pre(spec, p, xs[d], leaf_agg.to(xs[d].dtype), mesh))
                continue
            n_d = xs[d].shape[0]
            f = fanouts[d]
            x_neigh = xs[d + 1].reshape(n_d, f, xs[d + 1].shape[-1])
            m_neigh = masks[d + 1].reshape(n_d, f)
            new_xs.append(_conv_tree(spec, p, xs[d], x_neigh, m_neigh, mesh))
        xs = new_xs
        if i != L - 1:
            xs = [_relu_bn(spec, params, x, mesh) for x in xs]
            h = xs[0]
            xs = [dropout(gen, x, spec.dropout, train, mesh) for x in xs]
    return _heads(spec, params, xs[0], h, mesh)


# ------------------------------------------------------------------- GAT


def _gat_init(gen: torch.Generator, spec: NetSpec, device=None) -> dict:
    """Dense-adjacency GAT (reference attention.py:22-88): per layer a
    Glorot linear ``w`` [F, F'] and attention vector ``a`` [2F', 1]."""
    return {"layers": [{"w": glorot(gen, (fin, fout), device),
                        "a": glorot(gen, (2 * fout, 1), device)}
                       for fin, fout in spec.layer_sizes()]}


def _gat_forward(spec, params, x, edge_index, num_nodes, edge_mask, mesh=None):
    """Masked dense attention over the [n, n] adjacency of the edge list
    (messages src -> dst): per layer, e = LeakyReLU_0.2(a_dst . Wh_i +
    a_src . Wh_j) on the edges and -1e9 off them, a row softmax re-masked to
    0, x = alpha @ Wh, and ELU between layers; a node without in-edges gets
    0. Only the genuine edges of ``edge_mask`` enter the adjacency. (The JAX
    package routes masked edges to (0, 0) and scatters the mask there,
    duplicates and all; its result is defined, and equal to this, only where
    node 0 has no genuine self-loop: ROADMAP queue 3.) A column-sharded
    ``w`` runs column-parallel (``layers.tp_matmul``; ``a`` is whole)."""
    n = num_nodes
    src, dst = edge_index[0].long(), edge_index[1].long()
    if edge_mask is not None:
        # masked edges land in a dead column n, sliced off: no host sync
        src = torch.where(edge_mask, src, torch.full_like(src, n))
    adj = torch.zeros((n, n + 1), dtype=torch.bool, device=x.device)
    adj[dst, src] = True
    adj = adj[:, :n]
    x = x[:n]
    for i, p in enumerate(params["layers"]):
        wh = tp_matmul([(x, p["w"])], p["a"].shape[0] // 2, mesh)
        f = wh.shape[-1]
        a = p["a"][:, 0].to(x.dtype)
        e = F.leaky_relu((wh @ a[f:])[:, None] + (wh @ a[:f])[None, :], 0.2)
        e = torch.where(adj, e, e.new_tensor(-1e9))
        alpha = torch.where(adj, torch.softmax(e, dim=1), e.new_tensor(0.0))
        x = alpha @ wh
        if i != spec.num_layers - 1:
            x = F.elu(x)
    return x
