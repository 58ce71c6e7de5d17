"""Entry ``ct_step``: the co-teaching step, ``train.steps.ct_step``, batch
by batch over the pipeline's own epoch feed (``epoch_seed_matrix``),
crossing epoch boundaries as the pipeline's loop does, at the forget rate
of the mix's schedule epoch. One call is one step; its units are the
batch's labelled seed nodes."""

from __future__ import annotations

import torch

from gnnbench import counts, trainer
from gnnbench.reference import train as rtrain
from gnnbench.reference.precision import Precision


class Driver(trainer.TrainDriver):
    span = "gnnbench.ct_step"

    def _step(self, k: int):
        c = self.cfg
        return self.S.ct_step(self.spec, *self.states, self.data, self.seeds[k], self.masks[k],
                              self.pipe.gen, self.fr_t, self.fanouts,
                              algo="codi" if c["algo_type"] == "codi" else "coteaching",
                              co_lambda=float(c["co_lambda"]),
                              exact_leaf=self.pipe.exact_leaf_on(self.spec))

    def run_batch(self, k: int) -> dict:
        met = self._step(k)
        return {"loss": met[0] + met[1]}

    def call(self):
        if self.i == len(self.counts):
            self._epoch()
        with torch.profiler.record_function(self.span):
            self._step(self.i)
        self.i += 1
        self.flops_done += self.step_flops()
        return self.counts[self.i - 1], True

    def step_flops(self) -> float:
        s = self.spec
        fan = self.fanouts[:-1] if self.pipe.exact_leaf_on(s) else self.fanouts
        return counts.sage_tree_step_flops(self.bs, fan, s.in_size, s.hidden_size, s.out_size,
                                           s.num_layers)

    def peak_key(self) -> str:
        return self.spec.compute_dtype

    def ref_steps(self, prec: Precision, fault: str | None = None) -> dict:
        g = dict(self._ref_graph())
        exact = self.pipe.exact_leaf_on(self.spec)
        if exact:
            g["leaf"] = trainer.leaf_table(prec, g["x"], g["indptr"], g["indices"])[:, g["x"].shape[1]:]
        g["yhn"] = self.ref_labels()
        return rtrain.co_steps(prec, g, self.init[0], self.init[1], self.batches, self.gen_state,
                               fanouts=self.fanouts, exact_leaf=exact,
                               rate=float(self.cfg["dropout"]), forget_rate=self.fr,
                               lr=float(self.cfg["learning_rate"]), fault=fault)


def build(ctx, pipe=None):
    return Driver(ctx, pipe)
