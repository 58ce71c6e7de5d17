"""Entry ``gat_eval_pair``: the paired full-graph eval of two multi-head
GATs (module ``gat_ns``), the function ``make_eval_pair(spec)`` returns:
both nets' logits over every node, one CSR attention call a layer over
both nets' heads, and their split accuracies; driven and checked as entry
``eval_pair`` does, with the GAT's weights made from the seed and the
reference's blocked full-graph forward (``reference/gat.py``). One call is
one pass; its units are the graph's nodes."""

from __future__ import annotations

import torch

from gnnbench import bind, core, counts_gat, gat_bind
from gnnbench.reference import gat as rgat
from gnnbench.reference.precision import Precision

eval_pair = core.entry("eval_pair")


class Driver(eval_pair.Driver):
    def start(self, seed: int) -> None:
        self.seed = int(seed)
        self.init = [gat_bind.make_params(seed, t, self.spec, self.ctx.device) for t in (1, 2)]
        self.prog = [bind.clone_params(p) for p in self.init]
        self.accs = []

    def pass_flops(self) -> float:
        return counts_gat.gat_eval_pair_flops(self.nodes, self.spec)

    def attn_edges(self) -> int:
        """In-edges the attention takes: the graph's, self-loops removed,
        and one self-loop a node."""
        if not hasattr(self, "_attn_edges"):
            csr = self.pipe.data.csr
            row = torch.repeat_interleave(torch.arange(self.nodes, device=csr.indptr.device),
                                          csr.indptr[1:] - csr.indptr[:-1])
            self._attn_edges = int((csr.indices.long() != row).sum()) + self.nodes
        return self._attn_edges

    def gat_attn_bound_s(self) -> float:
        """The least time of one pass's attention calls: one a layer over
        both nets' heads."""
        s = self.spec
        elem = torch.finfo(s.dtype).bits // 8
        return sum(counts_gat.gat_attn_bound_s(self.nodes, self.attn_edges(), 2 * s.heads * c,
                                               2 * s.heads, elem)
                   for _, c, _ in gat_bind.layer_dims(s))

    def ref_logits(self, prec: Precision):
        rc = self.ctx.ref_graph(self.pipe.graph)
        with prec.matmul_mode():
            xq = prec.q(rc["x"])
            return [rgat.full_graph_logits(prec, p["convs"], xq, rc["indptr"], rc["indices"])
                    for p in self.init]


def build(ctx, pipe=None):
    return Driver(ctx, pipe)
