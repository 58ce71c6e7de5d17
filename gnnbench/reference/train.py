"""The reference's training steps: co-teaching on dense sampled trees (the
flagship step) and the TE step on flat subgraphs (co-teaching on sagePL's
pure passes, and after ``ct_tk`` epochs the rewired contrast).

Each follows the program's first steps from the same start: the harness's
weights, the same seed batches and forget rate, and the generator state the
first step started from, whose draws it replays (the sampler's uniforms,
then each dropout mask, in the order the step's algorithm draws them). It
returns each step's loss, the first gradient of every leaf, and every
leaf's value after the last step.
"""

from __future__ import annotations

import torch

from . import losses, rewire, sage
from .adam import Adam
from .graph import sample_tree
from .precision import Precision


def _leaves(params: dict, prefix: str) -> dict:
    out = {}
    for i, c in enumerate(params["convs"]):
        for k, t in c.items():
            out[f"{prefix}.conv{i}.{k}"] = t
    if "noise" in params:
        out[f"{prefix}.noise"] = params["noise"]
    return out


def _trainable(params: dict) -> dict:
    return {k: ([{n: t.detach().clone().float().requires_grad_(True) for n, t in c.items()}
                 for c in v] if k == "convs" else v.detach().clone().float().requires_grad_(True))
            for k, v in params.items()}


def _half(mask: torch.Tensor) -> torch.Tensor:
    """The fault 'half of the batch left out': only the first half of the
    rows count."""
    keep = torch.arange(mask.shape[0], device=mask.device) < mask.shape[0] // 2
    return mask & keep


def co_steps(prec: Precision, g: dict, p1: dict, p2: dict, batches, gen_state, *,
             fanouts, exact_leaf: bool, rate: float, forget_rate: float, lr: float,
             fault: str | None = None) -> dict:
    """Co-teaching steps on dense k-hop trees (reference src/pipeline.py:
    110-133): sample each batch's tree (one hop shallower with the exact
    leaf table), both nets' logits, the small-loss exchange, one Adam step
    of both nets on loss_1 + loss_2. ``g`` holds the graph arithmetic:
    ``x`` [N, F] float32, ``indptr``/``indices``, ``yhn``, and with the
    exact leaf ``leaf`` (the neighbour mean of x)."""
    gen = torch.Generator(device=g["x"].device)
    gen.set_state(gen_state)
    p1, p2 = _trainable(p1), _trainable(p2)
    named = {**_leaves(p1, "1"), **_leaves(p2, "2")}
    opt = Adam(list(named.values()), lr=lr)
    fan_s = tuple(fanouts[:-1]) if exact_leaf else tuple(fanouts)
    out = {"loss": [], "grad": None}
    with prec.matmul_mode():
        for seeds, mask in batches:
            ids, masks = sample_tree(gen, g["indptr"], g["indices"], seeds, mask, fan_s)
            xs = [prec.q(g["x"][i]) for i in ids]
            la = None
            if exact_leaf:
                la = torch.where(masks[-1][:, None], g["leaf"][ids[-1]],
                                 torch.zeros((), device=seeds.device))
            o1 = sage.tree_logits(prec, p1["convs"], xs, masks, fan_s, la, gen, rate)
            o2 = sage.tree_logits(prec, p2["convs"], xs, masks, fan_s, la, gen, rate)
            m = _half(mask) if fault == "half_batch" else mask
            l1, l2, _, _ = losses.ct_loss(o1, o2, g["yhn"][seeds], forget_rate, m)
            loss = l1 + l2
            grads = torch.autograd.grad(loss, list(named.values()))
            if out["grad"] is None:
                out["grad"] = {k: v.detach().clone() for k, v in zip(named, grads)}
            opt.step(grads)
            out["loss"].append(float(loss.detach()))
    out["params"] = {k: v.detach() for k, v in named.items()}
    return out


def te_steps(prec: Precision, g: dict, p1: dict, p2: dict, batches, gen_state, *,
             fanouts, rate: float, forget_rate: float, lr: float, contrast: bool,
             beta: float, rewire_rate: float, noise_neg: float,
             fault: str | None = None) -> dict:
    """TE steps (reference src/pipeline_test.py): sample each batch's tree,
    run both sagePL nets' pure passes over its flat subgraph (seeds first,
    then each depth), co-teaching on the seeds' logits; with the contrast,
    rewire the subgraph from net 1's hidden (``rewire.py``), and add beta x
    each net's expert BCE of its pure hidden against its pure pass over the
    positive graph and its noisy pass, on feature-shuffled rows, over the
    negative graph, over the seeds its selection rejected."""
    gen = torch.Generator(device=g["x"].device)
    gen.set_state(gen_state)
    p1, p2 = _trainable(p1), _trainable(p2)
    named = {**_leaves(p1, "1"), **_leaves(p2, "2")}
    opt = Adam(list(named.values()), lr=lr)
    out = {"loss": [], "contrast": [], "grad": None}
    with prec.matmul_mode():
        for seeds, mask in batches:
            bsz = seeds.shape[0]
            ids, masks = sample_tree(gen, g["indptr"], g["indices"], seeds, mask, fanouts)
            sizes = [t.shape[0] for t in ids]
            n_id, node_mask = torch.cat(ids), torch.cat(masks)
            x_sub = torch.where(node_mask[:, None], g["x"][n_id], torch.zeros((), device=n_id.device))
            tree = sage.tree_flat_graph(sizes, fanouts, node_mask[bsz:])
            z1, h1 = sage.stack(prec, p1["convs"], x_sub, tree, gen, rate)
            z2, h2 = sage.stack(prec, p2["convs"], x_sub, tree, gen, rate)
            m = _half(mask) if fault == "half_batch" else mask
            l1, l2, k1, k2 = losses.ct_loss(z1[:bsz], z2[:bsz], g["yhn"][seeds], forget_rate, m)
            loss = l1 + l2
            lc = torch.zeros((), device=seeds.device)
            if contrast:
                pos, neg = rewire.rewire_tree(h1.detach(), sizes, fanouts, node_mask[bsz:],
                                              rewire_rate)
                hp1 = sage.stack(prec, p1["convs"], x_sub, pos, gen, rate)[1]
                hp2 = sage.stack(prec, p2["convs"], x_sub, pos, gen, rate)[1]
                new_x = rewire.shuffle_cols(gen, x_sub, noise_neg)
                hn1 = sage.stack(prec, p1["convs"],
                                 sage.noisy_input(new_x, p1["noise"], n_id, noise_neg),
                                 neg, gen, rate)[1]
                hn2 = sage.stack(prec, p2["convs"],
                                 sage.noisy_input(new_x, p2["noise"], n_id, noise_neg),
                                 neg, gen, rate)[1]
                rej1, rej2 = ~k1 & m, ~k2 & m
                lc = (losses.expert_bce(h1[:bsz], hp1[:bsz], hn1[:bsz], rej1)
                      + losses.expert_bce(h2[:bsz], hp2[:bsz], hn2[:bsz], rej2))
                loss = loss + beta * lc
            grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
            grads = [torch.zeros_like(p) if gr is None else gr
                     for p, gr in zip(named.values(), grads)]
            if out["grad"] is None:
                out["grad"] = {k: v.detach().clone() for k, v in zip(named, grads)}
            opt.step(grads)
            out["loss"].append(float((l1 + l2).detach()))
            out["contrast"].append(float(lc.detach()))
    out["params"] = {k: v.detach() for k, v in named.items()}
    return out
