"""Entry ``eval_pair``: the paired full-graph eval that every co-teaching
epoch ends with, the function ``make_eval_pair(spec)`` returns: both nets'
logits over every node through one [N, 2H] SpMM a layer, and their split
accuracies. One call is one pass; its units are the graph's nodes.

The check takes both nets' logits from the pipeline's own full-graph
inference (``_logits_fns``, the function that ``make_eval_pair`` wraps, at
the same sizes) and compares them with the reference's; and it compares
the split accuracies that every call of the window returned with those
that these logits give."""

from __future__ import annotations

import numpy as np
import torch

from gnnbench import bind, counts
from gnnbench.reference import compare, graph as rgraph, sage
from gnnbench.reference.precision import Precision


class Driver:
    unit = "eval_nodes"
    span = "gnnbench.eval_pair"

    def __init__(self, ctx: bind.Ctx, pipe=None):
        self.ctx = ctx
        self.pipe = pipe if pipe is not None else bind.make_pipeline(ctx, ctx.mix["pipeline"])
        self.spec = self.pipe.spec_for()
        self.nodes = int(self.pipe.graph.num_nodes)
        self.evaluate = self.pipe.make_eval_pair(self.spec)
        self.flops_done = 0.0
        self.start(ctx.seed)

    def start(self, seed: int) -> None:
        self.seed = int(seed)
        dims = bind.layer_dims(self.spec)
        self.init = [bind.make_params(seed, t, dims, self.ctx.device) for t in (1, 2)]
        self.prog = [bind.clone_params(p) for p in self.init]
        self.accs = []

    def check(self, steps: int) -> None:
        """Nothing to capture ahead: every call's answers are judged."""

    def call(self):
        with torch.profiler.record_function(self.span):
            self.accs.append(self.evaluate(*self.prog))
        self.flops_done += self.pass_flops()
        return self.nodes, True

    def pass_flops(self) -> float:
        s = self.spec
        return counts.eval_pair_flops(self.nodes, s.in_size, s.hidden_size, s.out_size,
                                      s.num_layers)

    def peak_key(self) -> str:
        return self.spec.compute_dtype

    def spmm_bound_s(self) -> float:
        """The least time of one pass's SpMMs: every layer but the first
        (whose aggregate of the features is the leaf table's) aggregates
        the pair's [N, 2H] activations."""
        s = self.spec
        elem = torch.finfo(s.dtype).bits // 8
        e = int(self.pipe.data.csr.num_edges)
        return sum(counts.spmm_bound_s(self.nodes, e, 2 * fin, elem)
                   for fin, _ in bind.layer_dims(s)[1:])

    def program_logits(self):
        """Both nets' logits from the pipeline's full-graph inference."""
        _, pair = self.pipe._logits_fns(self.spec)
        return pair(*self.prog)

    def finish(self) -> None:
        """The pipeline's logits of both nets, then the program's eval
        state freed."""
        self.prog_logits = self.program_logits()
        self.evaluate = None

    def ref_logits(self, prec: Precision):
        rc = self.ctx.ref_graph(self.pipe.graph)
        x, ip, ix = rc["x"], rc["indptr"], rc["indices"]
        with prec.matmul_mode():
            xq = prec.q(x)
            x_agg = prec.q(rgraph.neighbor_mean(xq, ip, ix))
            return [sage.full_graph_logits(prec, p["convs"], xq, ip, ix, x_agg)
                    for p in self.init]

    def split_accs(self, logits) -> list[dict]:
        """Each net's accuracy on each split, of ``logits`` against the true
        labels."""
        y = torch.from_numpy(np.asarray(self.pipe.graph.y)).to(self.ctx.device).long()
        out = []
        for lg in logits:
            ok = lg.argmax(dim=-1) == y
            out.append({k: int(ok[torch.from_numpy(v).to(y.device).long()].sum()) / max(len(v), 1)
                        for k, v in self.pipe.split_idx.items()})
        return out

    def readings(self, logits, accs_seq, ref) -> dict:
        """``top1_gap`` and ``logits`` judge the nets' logits against the
        reference's; ``acc`` judges the split accuracies of every call
        against those that the judged logits give (an exact comparison)."""
        own = self.split_accs(logits)
        return {
            "top1_gap": max(compare.top1_gap(p, r) for p, r in zip(logits, ref)),
            "logits": max(compare.table_gap(p, r) for p, r in zip(logits, ref)),
            "acc": max(abs(a[k] - o[k]) for accs in accs_seq for a, o in zip(accs, own)
                       for k in o),
        }

    def verify(self) -> dict:
        return self.readings(self.prog_logits, self.accs, self.ref_logits(Precision()))


def build(ctx, pipe=None):
    return Driver(ctx, pipe)
