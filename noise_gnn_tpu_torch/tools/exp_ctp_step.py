"""The CTP train step split into stages at cora's shape.

    python -m noise_gnn_tpu_torch.tools.exp_ctp_step [--old] [--scale 1] [--batch 512]
        [--hidden 256] [--iters 3] [--cpu]

Port of ``tools/exp_ctp_step.py``: the CTP step (two sagePL nets, 2 x 256,
dropout 0.5, ``noise_rate`` 0.1, on the sampled tree's flat subgraph;
co-teaching with ``forget_rate`` 0.3 plus the uncertainty-weighted
consistency term) on cora at scale 1 (19,793 nodes, F = 8710 f32), batch
512, fanouts (10, 5), clean labels. Each leg is timed three ways: the
forward alone (its loss, under ``torch.no_grad``), the forward and the
backward (``torch.autograd.grad`` over both nets' params), and the full
step, the backward and two Adam updates (``train/steps.py::_step``).

* ``tree``: the main path's own loss, ``train/steps.py::ctp_step_loss(...,
  use_cr=True)``, whose flat subgraph goes through the scatter-free
  ``TreeTopo`` aggregation;
* ``edge_list`` (``--old``): the same loss built as the JAX tool builds its
  round-1 leg, the convs and ``get_uncertainty`` on the tree's structural
  edge list (``flat_edge_index``) with ``edge_mask = topo.edge_mask``.

Both legs draw the tree, the dropout masks and the sagePL noise from one
``torch.Generator`` in the same order: started from the same state, they
see the same draws (:func:`leg_loss`). Times are CUDA events around each
call (``utils/profiling.py::call_times``), medians; the JAX tool timed
host wall around a call and a sum of its output. The line states
``torch.get_float32_matmul_precision()``: with TF32 the step's f32
products run on the tensor cores and take another time. ``--cpu`` runs at
``--scale`` 10 (or more) with batch 16 unless they are given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from ..graph.datasets import load_network
from ..losses.consistency import fix_cr, get_uncertainty
from ..losses.coteaching import ct_loss
from ..models import nets
from ..ops.sampler import flat_edge_index, sample_khop_tree
from ..train import steps as S
from ..utils.profiling import call_times
from .bench_trainstep import adam
from .common import card_info, log, tool_device

FANOUTS = (10, 5)
FORGET_RATE = 0.3
SPL_NOISE = 0.1
CPU_SCALE, CPU_BATCH = 10, 16


def make_data(dev, scale: int) -> tuple[S.GraphData, int, int]:
    """(data, num_features, num_classes) of cora at ``scale`` (clean labels)."""
    g = load_network({"dataset_name": "cora", "seed": 0, "synthetic_scale": scale})
    n = g.num_nodes
    data = S.GraphData(x=torch.from_numpy(g.x).to(dev), y=torch.from_numpy(g.y).to(dev).long(),
                       yhn=torch.from_numpy(g.y).to(dev).long(),
                       clean=torch.ones(n, dtype=torch.bool, device=dev), csr=g.csr(dev))
    return data, g.num_features, g.num_classes


def edge_list_loss(spec: nets.NetSpec, p1: dict, p2: dict, data: S.GraphData, seeds, mask,
                   gen: torch.Generator, forget_rate, fanouts: tuple[int, ...]):
    """The CTP step's loss with the convs on the structural edge list: the
    JAX tool's round-1 leg, ``ctp_step_loss(..., use_cr=True)`` otherwise."""
    tb = sample_khop_tree(gen, data.csr, seeds, fanouts, mask)
    x_sub, n_id, _, topo = S._flat_subgraph(data, tb)
    n_sub, bsz = x_sub.shape[0], tb.batch_size
    ei = torch.from_numpy(flat_edge_index(bsz, fanouts)).to(x_sub.device)
    em = topo.edge_mask
    yb, cb = data.yhn[seeds], data.clean[seeds]

    def one_out(p):
        return nets.apply(spec, p, x_sub, ei, num_nodes=n_sub, edge_mask=em, train=True,
                          gen=gen, n_id=n_id, noise_rate=SPL_NOISE)

    out1, out2 = one_out(p1), one_out(p2)
    ct = ct_loss(out1["z_pure"][:bsz], out2["z_pure"][:bsz], yb, forget_rate, cb, mask)
    w1 = get_uncertainty(ei, out1["y_pure"], spec.out_size, em).detach()
    w2 = get_uncertainty(ei, out2["y_pure"], spec.out_size, em).detach()
    loss1 = ct.loss_1 + fix_cr(out1["y_pure"], out1["y_noisy"], bsz, w=w1, sample_mask=mask)
    loss2 = ct.loss_2 + fix_cr(out2["y_pure"], out2["y_noisy"], bsz, w=w2, sample_mask=mask)
    return loss1 + loss2


def leg_loss(leg: str, spec, p1, p2, data, seeds, mask, gen, forget_rate,
             fanouts=FANOUTS) -> torch.Tensor:
    """The summed loss of both nets on the ``tree`` or ``edge_list`` leg."""
    if leg == "tree":
        return S.ctp_step_loss(spec, p1, p2, data, seeds, mask, gen, forget_rate, fanouts,
                               use_cr=True, spl_noise=SPL_NOISE)[0]
    return edge_list_loss(spec, p1, p2, data, seeds, mask, gen, forget_rate, fanouts)


def run(cpu: bool = False, old: bool = False, scale: int | None = None,
        batch: int | None = None, hidden: int = 256, fanouts: tuple[int, ...] = FANOUTS,
        iters: int = 3) -> dict:
    dev = tool_device(cpu)
    scale = (CPU_SCALE if cpu else 1) if scale is None else scale
    batch = (CPU_BATCH if cpu else 512) if batch is None else batch
    data, feat, classes = make_data(dev, scale)
    n = data.x.shape[0]
    spec = nets.NetSpec(module="sagePL", in_size=feat, hidden_size=hidden, out_size=classes,
                        num_layers=2, dropout=0.5, nbr_nodes=n)
    seeds = torch.from_numpy(np.random.default_rng(0).integers(0, n, batch)).to(dev)
    mask = torch.ones(batch, dtype=torch.bool, device=dev)
    fr = torch.tensor(FORGET_RATE, dtype=torch.float32, device=dev)
    precision = torch.get_float32_matmul_precision()
    log(f"device: {dev}; cora scale {scale}: N={n} F={feat} C={classes}, sagePL 2 x {hidden}, "
        f"batch {batch}, fanouts {fanouts}; float32 matmul precision {precision!r}")
    stat = "ms" if dev.type == "cuda" else "wall_ms"
    legs = {}
    for leg in ["tree"] + (["edge_list"] if old else []):
        s1, s2 = (S.init_state(torch.Generator(device=dev).manual_seed(seed), spec, adam, dev)
                  for seed in (1, 2))
        gen = torch.Generator(device=dev).manual_seed(0)
        leaves = nets.parameters(s1.params) + nets.parameters(s2.params)

        def loss(leg=leg, s1=s1, s2=s2, gen=gen):
            return leg_loss(leg, spec, s1.params, s2.params, data, seeds, mask, gen, fr,
                            fanouts)

        def forward(loss=loss):
            with torch.no_grad():
                return loss()

        def forward_backward(loss=loss, leaves=leaves):
            return torch.autograd.grad(loss(), leaves)

        def full_step(loss=loss, s1=s1, s2=s2):
            S._step((s1, s2), loss())

        row = {"forward_loss": float(forward())}
        for name, fn in (("forward", forward), ("forward_backward", forward_backward),
                         ("full_step", full_step)):
            t = call_times(fn, dev, iters)
            row[f"{name}_{stat}"] = statistics.median(t[stat])
            row[f"{name}_times_{stat}"] = t[stat]
            log(f"{leg}: {name} {row[f'{name}_{stat}']:.2f} {stat}")
        legs[leg] = row
    return {"metric": "ctp_step_stage_ms", "stat": f"median of {iters} {stat}", "legs": legs,
            "float32_matmul_precision": precision, "dataset": "cora", "scale": scale,
            "nodes": n, "feat": feat, "classes": classes, "module": "sagePL",
            "hidden": hidden, "layers": 2, "batch": batch, "fanouts": list(fanouts),
            "forget_rate": FORGET_RATE, "noise_rate": SPL_NOISE, "iters": iters,
            **card_info(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--old", action="store_true", help="add the edge-list leg")
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    a = ap.parse_args(argv)
    res = run(a.cpu, a.old, a.scale, a.batch, a.hidden, iters=a.iters)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
