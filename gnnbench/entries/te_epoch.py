"""Entry ``te_epoch``: the TE pipeline's epoch, ``train.steps.te_epoch``,
over the pipeline's own epoch feed at the forget rate of the mix's
schedule epoch, with the rewired contrast on or off as the mix says
(``contrast``). With ``per_call: batch`` one call is one batch (a contrast
step is long); with ``per_call: epoch`` one call is the rest of the current
epoch, so a window closes at an epoch boundary. Units are labelled seed
nodes trained."""

from __future__ import annotations

import torch

from gnnbench import counts, trainer
from gnnbench.reference import train as rtrain
from gnnbench.reference.precision import Precision


class Driver(trainer.TrainDriver):
    span = "gnnbench.te_epoch"

    def _epoch_call(self, lo: int, hi: int) -> dict:
        c = self.cfg
        return self.S.te_epoch(
            self.spec, *self.states, self.data, self.seeds[lo:hi], self.masks[lo:hi],
            self.pipe.gen, self.fr, self.fanouts,
            use_contrast=bool(self.ctx.mix["contrast"]),
            algo="codi" if c["algo_type"] == "codi" else "coteaching",
            co_lambda=float(c["co_lambda"]), spl_cont_beta=float(c["spl_cont_beta"]),
            spl_rewire_rate=float(c["spl_rewire_rate"]),
            spl_noise_rate_pos=float(c["spl_noise_rate_pos"]),
            spl_noise_rate_neg=float(c["spl_noise_rate_neg"]))

    def run_batch(self, k: int) -> dict:
        m = self._epoch_call(k, k + 1)
        return {"loss": m["loss_1"] + m["loss_2"], "contrast": m["loss_cont_1"] + m["loss_cont_2"]}

    def call(self):
        if self.i == len(self.counts):
            self._epoch()
        lo = self.i
        hi = lo + 1 if self.ctx.mix["per_call"] == "batch" else len(self.counts)
        with torch.profiler.record_function(self.span):
            self._epoch_call(lo, hi)
        self.i = hi
        self.flops_done += (hi - lo) * self.step_flops()
        return sum(self.counts[lo:hi]), True

    def step_flops(self) -> float:
        s = self.spec
        return counts.te_step_flops(self.bs, self.fanouts, s.in_size, s.hidden_size, s.out_size,
                                    s.num_layers, bool(self.ctx.mix["contrast"]))

    def peak_key(self) -> str:
        return self.spec.compute_dtype

    def ref_steps(self, prec: Precision, fault: str | None = None) -> dict:
        g = dict(self._ref_graph())
        g["yhn"] = self.ref_labels()
        c = self.cfg
        return rtrain.te_steps(prec, g, self.init[0], self.init[1], self.batches, self.gen_state,
                               fanouts=self.fanouts, rate=float(c["dropout"]),
                               forget_rate=self.fr, lr=float(c["learning_rate"]),
                               contrast=bool(self.ctx.mix["contrast"]),
                               beta=float(c["spl_cont_beta"]),
                               rewire_rate=float(c["spl_rewire_rate"]),
                               noise_neg=float(c["spl_noise_rate_neg"]), fault=fault)


def build(ctx, pipe=None):
    return Driver(ctx, pipe)
