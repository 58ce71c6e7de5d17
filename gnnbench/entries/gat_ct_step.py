"""Entry ``gat_ct_step``: the co-teaching step, ``train.steps.ct_step``, of
two multi-head GATs (module ``gat_ns``) on fully sampled trees, batch by
batch over the pipeline's own epoch feed, as entry ``ct_step`` drives it for
SAGE; the nets' weights are the GAT's, made from the seed
(``gat_bind.make_params``), and the reference follows the first steps with
``reference/gat.py``. One call is one step; its units are the batch's
labelled seed nodes.

Besides the training cells' readings, the check judges net 1's logits of
the first step (``logits``, ``top1_gap``) and their gradient under a plain
cross-entropy over the batch's valid seeds (``ce_grad``, the worst leaf's
``|g - g_ref| / max(|g_ref|, median leaf's |g_ref|)``; ``ce_grad_median``):
the program's sampler, tree forward and autograd backward run again from
the step's generator state and weights, against the reference's on the
same draws. Co-teaching's selection makes every loss and gradient reading
jump where rounding swaps a sample across the small-loss threshold; these
have no selection, so their gaps follow the precision alone."""

from __future__ import annotations

import torch

import torch.nn.functional as F

from gnnbench import bind, core, counts_gat, gat_bind
from gnnbench.reference import compare
from gnnbench.reference import gat as rgat
from gnnbench.reference.precision import Precision

ct_step = core.entry("ct_step")


class Driver(ct_step.Driver):
    def start(self, seed: int) -> None:
        self.seed = int(seed)
        bind.reseed(self.pipe, seed)
        self.data = self.pipe.data_for(self.spec)
        dev = self.ctx.device
        self.init = [gat_bind.make_params(seed, t, self.spec, dev) for t in (1, 2)]
        self.prog = [bind.clone_params(p) for p in self.init]
        self.states = [self.S.state_from_params(p, self.pipe.make_optimizer) for p in self.prog]
        self.fr_t = torch.tensor(self.fr, dtype=torch.float32, device=dev)
        self._epoch()

    def check(self, steps: int) -> None:
        from noise_gnn_tpu_torch.models import nets

        super().check(steps)
        gen = torch.Generator(device=self.ctx.device)
        gen.set_state(self.gen_state)
        seeds, mask = self.batches[0]
        with torch.no_grad():
            tb, xs, _ = self.S._sample_tree(gen, self.data, seeds, mask, self.fanouts, False)
        p = bind.clone_params(self.init[0])
        leaves = bind.named_leaves(p, "1")
        for t in leaves.values():
            t.requires_grad_(True)
        logits = nets.apply_tree(self.spec, p, xs, list(tb.masks), tb.fanouts, train=True,
                                 gen=gen)["logits"]
        ce = F.cross_entropy(logits[mask], self.data.yhn[seeds][mask])
        grads = torch.autograd.grad(ce, list(leaves.values()))
        self.prog_logits = logits.detach()
        self.prog_ce_grad = {k: g.detach() for k, g in zip(leaves, grads)}

    def program_out(self) -> dict:
        return {**super().program_out(), "logits": self.prog_logits,
                "ce_grad": self.prog_ce_grad}

    def readings(self, out: dict, ref: dict) -> dict:
        r = super().readings(out, ref)
        r["logits"] = compare.table_gap(out["logits"], ref["logits"])
        r["top1_gap"] = compare.top1_gap(out["logits"], ref["logits"])
        gaps = diff_gaps(out["ce_grad"], ref["ce_grad"])
        r["ce_grad"], r["ce_grad_median"] = max(gaps.values()), compare.median(gaps.values())
        return r

    def step_flops(self) -> float:
        return counts_gat.gat_tree_step_flops(self.bs, self.fanouts, self.spec)

    def ref_steps(self, prec: Precision, fault: str | None = None) -> dict:
        g = dict(self._ref_graph())
        g["yhn"] = self.ref_labels()
        return rgat.co_steps(prec, g, self.init[0], self.init[1], self.batches, self.gen_state,
                             fanouts=self.fanouts, rate=float(self.cfg["dropout"]),
                             forget_rate=self.fr, lr=float(self.cfg["learning_rate"]),
                             fault=fault)


def diff_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf: the norm of the difference from the reference's leaf, over
    the larger of that leaf's norm and the median leaf's."""
    rn = {k: float(torch.linalg.vector_norm(v.float())) for k, v in ref.items()}
    med = compare.median(rn.values())
    return {k: float(torch.linalg.vector_norm(prog[k].float() - ref[k].float()))
            / max(rn[k], med, 1e-30) for k in rn}


def build(ctx, pipe=None):
    return Driver(ctx, pipe)
