"""Full-graph layer-wise inference over a pre-packed CSR SpMM.

Port of ``noise_gnn_tpu/eval/inference.py``: every layer aggregates over ALL
edges on the device. Mean and sum aggregation run the CSR SpMM
(``ops/spmm.py``: the CUDA kernel on a card, the plain version on the CPU);
``aggr: max`` runs ``scatter_reduce``. Only the conv stack runs at eval (no
dropout, and no sagePL input noise: a sagePL net evaluates as its SAGE
stack), as in the reference's ``inference`` methods.

``pair`` evaluates both co-teaching nets in one pass: their activations are
concatenated to [N, 2H] so one SpMM per layer serves both. ``x_agg`` (the
first layer's aggregate of the run-constant raw features, from the
exact-leaf table) makes layer 1 matmul-only.

Under ``use_bn`` the stack normalizes as its training forward does, by the
statistics of all N rows: ``bn1`` on the input (so layer 1 aggregates
``bn1(x)``, which changes with the params, and no ``x_agg`` applies) and
``bn2`` after each inter-layer ReLU; the pair normalizes each net with its
own ``bn1``/``bn2`` and still shares one [N, 2H] SpMM per layer. ``gat``
is dense attention over the full edge list, with no SpMM; its pair is two
single passes.
"""

from __future__ import annotations

import torch

from ..models.layers import batch_norm
from ..models.nets import NetSpec, _gat_forward
from ..ops.scatter import gather_scatter_max
from ..ops.spmm import Spmm


class FullGraphInference:
    """Callable (params, x) -> f32 logits [N, C] for a fixed graph."""

    def __init__(self, spec: NetSpec, csr, x_agg: torch.Tensor | None = None):
        if spec.use_bn and x_agg is not None:
            raise ValueError("x_agg aggregates the raw features; under use_bn layer 1 "
                             "aggregates bn1(x)")
        self.spec = spec
        self.num_nodes = int(csr.num_nodes)
        self._csr = csr
        self._x_agg = x_agg
        self._spmm = None if spec.module == "gat" else Spmm.from_csr(csr)
        self._edge_index = None  # built on first use by aggr='max' and gat

    def _edges(self) -> torch.Tensor:
        if self._edge_index is None:
            self._edge_index = self._csr.edge_index()
        return self._edge_index

    def _max_agg(self, x: torch.Tensor) -> torch.Tensor:
        return gather_scatter_max(x, self._edges(), self.num_nodes)

    def _bn(self, params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(params[name], x) if self.spec.use_bn else x

    def _agg(self, x: torch.Tensor, mean: bool) -> torch.Tensor:
        if mean and self.spec.aggr == "max":
            return self._max_agg(x)
        # fp32 accumulation, output in the activation dtype
        return self._spmm(x.contiguous(), mean=mean, out_dtype=x.dtype)

    def _conv(self, p: dict, x: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.spec.module == "gcn":
            return (agg + x) @ p["w"].to(dt) + p["b"].to(dt)
        return agg @ p["w_neigh"].to(dt) + x @ p["w_root"].to(dt) + p["b"].to(dt)

    @torch.no_grad()
    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        is_gcn = spec.module == "gcn"
        x = x.to(spec.dtype)
        if spec.module == "gat":
            return _gat_forward(spec, params, x, self._edges(), self.num_nodes, None).float()
        x = self._bn(params, "bn1", x)
        for i, p in enumerate(params["convs"]):
            if i == 0 and self._x_agg is not None:
                agg = self._x_agg.to(x.dtype)
            else:
                agg = self._agg(x, mean=not is_gcn)
            x = self._conv(p, x, agg)
            if i != spec.num_layers - 1:
                x = self._bn(params, "bn2", torch.relu(x))
        return x.float()

    @torch.no_grad()
    def pair(self, params1: dict, params2: dict, x: torch.Tensor):
        """Both nets in one pass -> (logits1, logits2): each layer's SpMM
        runs once over the [N, 2H] concatenation of their activations."""
        spec = self.spec
        if spec.module == "gat":
            return self(params1, x), self(params2, x)
        is_gcn = spec.module == "gcn"
        x = x.to(spec.dtype)
        x1, x2 = self._bn(params1, "bn1", x), self._bn(params2, "bn1", x)
        for i, (l1, l2) in enumerate(zip(params1["convs"], params2["convs"])):
            f = x1.shape[-1]
            if i == 0 and self._x_agg is not None:
                agg1 = agg2 = self._x_agg.to(x1.dtype)
            else:
                agg = self._agg(torch.cat([x1, x2], dim=1), mean=not is_gcn)
                agg1, agg2 = agg[:, :f], agg[:, f:]
            x1, x2 = self._conv(l1, x1, agg1), self._conv(l2, x2, agg2)
            if i != spec.num_layers - 1:
                x1 = self._bn(params1, "bn2", torch.relu(x1))
                x2 = self._bn(params2, "bn2", torch.relu(x2))
        return x1.float(), x2.float()


def split_accuracy_fn(split_idx: dict, y: torch.Tensor, num_nodes: int):
    """Device-side split accuracy (JAX package pipelines.py:403-427): masked
    correct-counts for every split in one reduction, one small fetch per
    evaluation. Returns ``accs(logits) -> {split: accuracy}``."""
    parts = list(split_idx)
    masks = torch.zeros((len(parts), num_nodes), dtype=torch.bool, device=y.device)
    for i, p in enumerate(parts):
        masks[i, torch.as_tensor(split_idx[p], dtype=torch.long, device=y.device)] = True
    sizes = [max(int(split_idx[p].shape[0]), 1) for p in parts]

    def accs(logits: torch.Tensor) -> dict:
        ok = logits.argmax(dim=-1) == y
        vals = (ok[None, :] & masks).sum(dim=1).cpu().tolist()
        return {p: float(v) / c for p, v, c in zip(parts, vals, sizes)}

    return accs
