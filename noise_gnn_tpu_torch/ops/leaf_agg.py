"""Exact precomputed leaf aggregation for tree-mode training.

Port of ``noise_gnn_tpu/ops/leaf_agg.py``. In a sampled k-hop tree the
deepest hop only estimates ``agg_{j in N(v)} x_j`` for each depth-(L-1) node
v, and ``x`` never changes during training. So the aggregate
``M[v] = agg_{j in N(v)} x_j`` is computed ONCE per pipeline with the
full-graph SpMM and one ``[x | M]`` row is gathered per depth-(L-1) tree
node: exact where the sampled hop is a fanout-limited estimate.

Backends: mean and sum always take the CSR SpMM (``ops/spmm.py``: the CUDA
kernel on a card, its plain version on the CPU), whatever the graph's size;
``aggr: max`` stays on ``scatter_reduce`` as the JAX package leaves it on
XLA.
"""

from __future__ import annotations

import torch

from .scatter import gather_scatter_max
from .spmm import Spmm


def precompute_leaf_agg(x: torch.Tensor, csr, aggr: str = "mean") -> torch.Tensor:
    """``M[v] = aggr_{j in N(v)} x[j]`` for every node, on x's device, in
    x's dtype (fp32 accumulation). ``csr`` is the reversed CSR the sampler
    uses, so N(v) is exactly the set the sampled leaf hop draws from."""
    if aggr in ("mean", "sum"):
        return Spmm.from_csr(csr)(x.contiguous(), mean=(aggr == "mean"),
                                  out_dtype=x.dtype)
    if aggr != "max":
        raise ValueError(f"unknown aggregation {aggr!r}")
    return gather_scatter_max(x, csr.edge_index(), csr.num_nodes)


def fused_leaf_table(x: torch.Tensor, csr, aggr: str = "mean") -> torch.Tensor:
    """``concat([x, M], 1)`` — the fused [N, 2F] exact-leaf table, so a
    leaf-depth node's own features and its aggregate arrive in one gather."""
    m = precompute_leaf_agg(x, csr, aggr=aggr)
    return torch.cat([x, m.to(x.dtype)], dim=1)


def leaf_agg_eligible(spec, fanouts) -> bool:
    """True when the exact-leaf path preserves the model's semantics."""
    return (
        spec.module in ("sage", "gcn", "sageH", "sageFC")
        and not spec.use_bn
        and len(fanouts) == spec.num_layers
        and spec.num_layers >= 1
    )
