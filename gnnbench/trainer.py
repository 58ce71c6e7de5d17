"""What the training entries share: a pipeline re-seeded for the run, the
harness's weights loaded into the program's states, the epoch feed, the
first steps captured for the check, and the check itself.

The check (``readings``) follows the program's first steps with the
reference from the same start and reads: the noisy labels, the exact
leaf table where the configuration has one, each step's loss (and the
contrast loss where the mix has one), every leaf's first gradient as the
optimizer got it (Adam's first moment after one step over 1 - beta1), and
every moved leaf's change over the steps, each leaf judged by its norm;
by the worst leaf, and, steadier in float32, where later steps and single
leaves swing by round-off, by the first step and the median leaf.
"""

from __future__ import annotations

import torch

from gnnbench import bind
from gnnbench.reference import compare, graph as rgraph, noise as rnoise
from gnnbench.reference.precision import Precision


class TrainDriver:
    unit = "train_nodes"

    def __init__(self, ctx: bind.Ctx, pipe=None):
        from noise_gnn_tpu_torch.train import steps

        self.S = steps
        self.ctx = ctx
        self.cfg = ctx.cfg["config"]
        self.pipe = pipe if pipe is not None else bind.make_pipeline(ctx, ctx.mix["pipeline"])
        self.spec = self.pipe.spec_for()
        self.bs = int(self.pipe.config["batch_size"])
        self.fanouts = tuple(self.pipe.fanouts)
        self.fr = bind.forget_rate(ctx.cfg, int(ctx.mix["schedule_epoch"]))
        self.train_idx = self.pipe.split_idx["train"]
        self.flops_done = 0.0
        self.start(ctx.seed)

    # ------------------------------------------------------------ program

    def start(self, seed: int) -> None:
        """Labels, streams, weights and states of run ``seed``, and the
        first epoch's batches."""
        self.seed = int(seed)
        bind.reseed(self.pipe, seed)
        self.data = self.pipe.data_for(self.spec)
        dev = self.ctx.device
        noise = ((self.spec.nbr_nodes, self.spec.in_size) if self.spec.module == "sagePL"
                 else None)
        dims = bind.layer_dims(self.spec)
        self.init = [bind.make_params(seed, t, dims, dev, noise) for t in (1, 2)]
        self.prog = [bind.clone_params(p) for p in self.init]
        self.states = [self.S.state_from_params(p, self.pipe.make_optimizer) for p in self.prog]
        self.fr_t = torch.tensor(self.fr, dtype=torch.float32, device=dev)
        self._epoch()

    def _epoch(self) -> None:
        self.seeds, self.masks = self.pipe.epoch_seed_matrix(self.train_idx, self.bs)
        n = int(self.train_idx.shape[0])
        self.counts = [min(self.bs, n - i * self.bs) for i in range(self.seeds.shape[0])]
        self.i = 0

    def _named(self) -> dict:
        return {**bind.named_leaves(self.prog[0], "1"), **bind.named_leaves(self.prog[1], "2")}

    def run_batch(self, k: int) -> dict:
        """One step through the window's own call on batch k: device
        scalars ``loss`` (and ``contrast``)."""
        raise NotImplementedError

    def check(self, steps: int) -> None:
        """The program's first ``steps`` steps, captured for the check."""
        if self.seeds.shape[0] < steps:
            raise RuntimeError("an epoch holds fewer batches than the check's steps")
        self.gen_state = self.pipe.gen.get_state().clone()
        self.batches = [(self.seeds[k], self.masks[k]) for k in range(steps)]
        named = self._named()
        outs = []
        for k in range(steps):
            outs.append(self.run_batch(k))
            if k == 0:
                opt = {id(p): s.opt for s in self.states for p in s.opt.param_groups[0]["params"]}
                grad = {}
                for name, p in named.items():
                    o = opt[id(p)]
                    b1 = o.param_groups[0]["betas"][0]
                    st = o.state.get(p)  # none where the step never reached the optimizer
                    grad[name] = (st["exp_avg"] / (1 - b1)).detach().clone() if st else \
                        torch.zeros_like(p)
                self.prog_grad = grad
        self.i = steps
        self.prog_after = {k: v.detach().clone() for k, v in named.items()}
        self.prog_out = {key: [float(o[key]) for o in outs] for key in outs[0]}

    def finish(self) -> None:
        """Free the program's training state; what the check judges stays."""
        self.states = self.prog = None
        self.seeds = self.masks = None

    def program_readings(self, ref: dict) -> dict:
        """The check's readings of the program against the reference's
        steps ``ref``."""
        r = {"labels": self.label_reading()}
        t = self.table_reading()
        if t is not None:
            r["leaf_table"] = t
        r.update(self.readings(self.program_out(), ref))
        return r

    def verify(self) -> dict:
        return self.program_readings(self.ref_steps(Precision()))

    def table_reading(self, prec: Precision | None = None) -> float | None:
        """The exact-leaf table where the configuration has one: the
        program's (or, given ``prec``, a control's) against the
        reference's."""
        if not self.pipe.exact_leaf_on(self.spec):
            return None
        g = self._ref_graph()
        ref = leaf_table(Precision(), g["x"], g["indptr"], g["indices"])
        got = (self.data.leaf_agg if prec is None
               else leaf_table(prec, g["x"], g["indptr"], g["indices"]))
        return compare.table_gap(got, ref)

    # ------------------------------------------------------------- check

    def _ref_graph(self) -> dict:
        return self.ctx.ref_graph(self.pipe.graph)

    def ref_labels(self) -> torch.Tensor:
        g = self.pipe.graph
        c = self.cfg
        y = rnoise.flip_labels(g.y, g.num_classes, c["noise_type"], float(c["noise_rate"]),
                               bind.label_rng(self.ctx.cfg, self.seed))
        return torch.from_numpy(y).to(self.ctx.device)

    def ref_steps(self, prec: Precision, fault: str | None = None) -> dict:
        raise NotImplementedError

    def program_out(self) -> dict:
        return {**self.prog_out, "grad": self.prog_grad, "params": self.prog_after}

    def _leaf_gaps(self, out: dict, ref: dict):
        """Per leaf: the first gradient's gap, and the moved leaves' change's."""
        init = {**bind.named_leaves(self.init[0], "1"), **bind.named_leaves(self.init[1], "2")}
        moved = compare.moved_leaves(ref["grad"])
        return (compare.norm_gaps(out["grad"], ref["grad"]),
                compare.norm_gaps({k: out["params"][k] - init[k] for k in moved},
                                  {k: ref["params"][k] - init[k] for k in moved}))

    def readings(self, out: dict, ref: dict) -> dict:
        """The numbers a cell may compare, of ``out`` (the program's, or a
        control's) against the float32 reference ``ref``: over every step
        and by the worst leaf (``loss``, ``contrast``, ``grad``,
        ``update``), and the steady forms, the first step's losses and the
        median leaf's gaps (``*_step1``, ``*_median``). A cell's limits
        file says which it compares."""
        r = {"loss": max(compare.rel_gap(a, b) for a, b in zip(out["loss"], ref["loss"])),
             "loss_step1": compare.rel_gap(out["loss"][0], ref["loss"][0])}
        if "contrast" in ref and any(ref["contrast"]):
            r["contrast"] = max(compare.rel_gap(a, b)
                                for a, b in zip(out["contrast"], ref["contrast"]))
            r["contrast_step1"] = compare.rel_gap(out["contrast"][0], ref["contrast"][0])
        g, u = self._leaf_gaps(out, ref)
        r["grad"], r["update"] = max(g.values()), max(u.values())
        r["grad_median"] = compare.median(g.values())
        r["update_median"] = compare.median(u.values())
        return r

    def worst_leaves(self, out: dict, ref: dict) -> dict:
        """The leaf that sets the ``grad`` and the ``update`` reading: where
        a number stands out, this says which leaf."""
        g, u = self._leaf_gaps(out, ref)
        return {"grad": max(g.items(), key=lambda kv: kv[1]),
                "update": max(u.items(), key=lambda kv: kv[1])}

    def label_reading(self) -> float:
        """Nodes whose noisy label differs from the reference's draw."""
        return float((self.data.yhn != self.ref_labels()).sum())


def leaf_table(prec: Precision, x: torch.Tensor, indptr, indices) -> torch.Tensor:
    """The exact-leaf table [N, 2F]: x and the neighbour mean of x, side by
    side, in ``prec`` (the reference's in float32)."""
    xq = prec.q(x)
    return torch.cat([xq, prec.q(rgraph.neighbor_mean(xq, indptr, indices))], dim=1)
