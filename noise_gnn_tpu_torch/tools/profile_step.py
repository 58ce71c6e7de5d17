"""Stage decomposition of the exact-leaf co-teaching train step.

    python -m noise_gnn_tpu_torch.tools.profile_step [--steps 50] [--nodes 1200000] ...
        [--cpu]

Port of ``tools/profile_step.py``: the step is cut at successive points,
and each cut runs for ``--steps`` steps of the products shape (the graph of
``tools/bench_trainstep.py``, drawn on the device; its exact-leaf table
built by the SpMM), a checksum of each step added into one device scalar
so that nothing is skipped. The stages keep the JAX tool's names
(``tools/profile_step.py:236-246``):

* ``rng_only``: the sampler's uniform draws alone (``[B, f1]`` and
  ``[B f1, f2]``);
* ``gathers_only(fixed idx)``: the step's three gathers at its shapes with
  fixed random ids: ``x`` rows, ``[x | M]`` table rows, CSR entries;
* ``sample_only``: the tree sampling (``ops/sampler.py``);
* ``sample+gather``: sampling and the tree's feature and table gathers
  (``train/steps.py::_sample_tree``);
* ``+forward x1 (no dropout)``, ``+forward x1``: one net's tree forward,
  without and with dropout;
* ``+forward x2 + ct_loss``: both nets and the co-teaching loss;
* ``+fwd x2 with autograd (as ct_step) + ct_loss``: the same, recording
  the autograd graph as ``ct_step`` runs both nets before its backward.
  The JAX tool's eighth stage vmaps the two forwards over stacked params;
  the port's step runs them one after the other, so this stage prices
  what the backward needs of the forwards instead;
* ``full step (grad+update x2)``: ``train/steps.py::ct_epoch``.

The first seven run under ``torch.no_grad`` (JAX computes no gradient
there). Each stage runs once to warm up, then ``--reps`` times; the JSON
line gives, per stage, the fastest run's CUDA-event ms a step and host wall
ms a step (``ms_per_step`` is null on the CPU). Spans inside the step and
the device's idle share are not measured here.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..losses.coteaching import ct_loss
from ..models import nets
from ..ops.leaf_agg import fused_leaf_table
from ..ops.sampler import sample_khop_tree
from ..ops.scatter import fast_take
from ..train import steps as S
from ..utils.profiling import call_times
from .bench_trainstep import FORGET_RATE, fresh_states, make_data, sage_spec
from .common import card_info, log, tool_device

STAGES = ("rng_only", "gathers_only(fixed idx)", "sample_only", "sample+gather",
          "+forward x1 (no dropout)", "+forward x1", "+forward x2 + ct_loss",
          "+fwd x2 with autograd (as ct_step) + ct_loss", "full step (grad+update x2)")


def _stages(data, seeds, masks, spec, fanouts, s1, s2, dev) -> dict:
    """Each stage as a function of a generator that runs every step and
    returns the checksum."""
    steps, batch = seeds.shape
    d1 = batch * fanouts[0]
    d2 = d1 * fanouts[1]
    fan_s = fanouts[:-1]
    n, e = data.csr.num_nodes, data.csr.num_edges
    gk = torch.Generator(device=dev).manual_seed(7)
    idx_d1 = torch.randint(0, n, (steps, d1), generator=gk, device=dev)
    idx_d2 = torch.randint(0, n, (steps, d2), generator=gk, device=dev)
    idx_csr = torch.randint(0, e, (steps, d2), generator=gk, device=dev)
    fr = torch.tensor(FORGET_RATE, dtype=torch.float32, device=dev)

    def over_steps(body):
        def stage(gen):
            c = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(steps):
                c = c + body(gen, i)
            return c
        return stage

    def rng_only(gen, i):
        u1 = torch.rand((batch, fanouts[0]), generator=gen, device=dev)
        u2 = torch.rand((d1, fanouts[1]), generator=gen, device=dev)
        return u1.sum() + u2.sum()

    def gathers_only(gen, i):
        a = fast_take(data.x, idx_d1[i])
        b = fast_take(data.leaf_agg, idx_d2[i])
        c = fast_take(data.csr.indices, idx_csr[i])
        return a.float().sum() + b.float().sum() + c.sum().float()

    def sample_only(gen, i):
        tb = sample_khop_tree(gen, data.csr, seeds[i], fan_s, masks[i])
        return tb.n_ids[-1].sum().float()

    def sample_gather(gen, i):
        _, xs, la = S._sample_tree(gen, data, seeds[i], masks[i], fanouts, True)
        return sum(v.float().sum() for v in xs) + la.float().sum()

    def forward(params, gen, i, train, tree=None):
        tb, xs, la = tree or S._sample_tree(gen, data, seeds[i], masks[i], fanouts, True)
        return nets.apply_tree(spec, params, xs, list(tb.masks), tb.fanouts, train=train,
                               gen=gen if train else None, leaf_agg=la)["logits"]

    def fwd1_nodrop(gen, i):
        return forward(s1.params, gen, i, False).float().sum()

    def fwd1(gen, i):
        return forward(s1.params, gen, i, True).float().sum()

    def fwd2_loss(gen, i):
        tree = S._sample_tree(gen, data, seeds[i], masks[i], fanouts, True)
        o1 = forward(s1.params, gen, i, True, tree)
        o2 = forward(s2.params, gen, i, True, tree)
        out = ct_loss(o1, o2, data.yhn[seeds[i]], fr, data.clean[seeds[i]], masks[i])
        return out.loss_1.detach() + out.loss_2.detach()

    def no_grad(fn):
        def go(gen):
            with torch.no_grad():
                return fn(gen)
        return go

    def full(gen):
        m = S.ct_epoch(spec, s1, s2, data, seeds, masks, gen, FORGET_RATE, fanouts,
                       exact_leaf=True)
        return m["loss_1"]

    fns = [no_grad(over_steps(b)) for b in (rng_only, gathers_only, sample_only, sample_gather,
                                            fwd1_nodrop, fwd1, fwd2_loss)]
    fns += [over_steps(fwd2_loss), full]
    return dict(zip(STAGES, fns))


def run(cpu: bool = False, nodes: int = 1_200_000, deg: int = 26, feat: int = 100,
        classes: int = 47, hidden: int = 256, batch: int = 512,
        fanouts: tuple[int, ...] = (15, 10, 5), steps: int = 50, dtype: str = "bfloat16",
        reps: int = 3) -> dict:
    dev = tool_device(cpu)
    if len(fanouts) < 2:
        raise ValueError("the exact-leaf step needs at least two fanouts")
    log(f"device: {dev}; N={nodes} deg={deg} F={feat} C={classes} hidden={hidden} "
        f"batch={batch} fanouts={fanouts} {dtype}, {steps} steps a run")
    data, seeds, masks = make_data(dev, nodes, deg, feat, classes, getattr(torch, dtype),
                                   steps, batch)
    data.leaf_agg = fused_leaf_table(data.x, data.csr, "mean")
    spec = sage_spec(feat, hidden, classes, len(fanouts), dtype)
    s1, s2 = fresh_states(spec, dev)
    fns = _stages(data, seeds, masks, spec, fanouts, s1, s2, dev)
    rows = []
    for name, fn in fns.items():
        t = call_times(lambda: float(fn(torch.Generator(device=dev).manual_seed(9))), dev, reps)
        ms = min(t["ms"]) / steps if dev.type == "cuda" else None
        wall = min(t["wall_ms"]) / steps
        rows.append({"stage": name, "ms_per_step": ms, "wall_ms_per_step": wall})
        log(f"{name:46s} {wall if ms is None else ms:8.3f} ms/step (wall {wall:.3f})")
    return {"metric": "step_stage_ms", "stages": rows, "nodes": nodes, "deg": deg,
            "feat": feat, "classes": classes, "hidden": hidden, "batch": batch,
            "fanouts": list(fanouts), "steps": steps, "dtype": dtype, "reps": reps,
            **card_info(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nodes", type=int, default=1_200_000)
    ap.add_argument("--deg", type=int, default=26)
    ap.add_argument("--feat", type=int, default=100)
    ap.add_argument("--classes", type=int, default=47)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--fanouts", default="15,10,5")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    res = run(a.cpu, a.nodes, a.deg, a.feat, a.classes, a.hidden, a.batch,
              tuple(int(f) for f in a.fanouts.split(",")), a.steps, a.dtype, a.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
