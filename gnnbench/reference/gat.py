"""Multi-head GAT with skip connections (PyG ``examples/ogbn_products_gat.py``,
the OGB leaderboard's "GAT w/NS" on ogbn-products), in float32 with TF32 off
unless a precision says otherwise; and its co-teaching steps.

A layer of H heads of width C, ``{"w" [F, H C], "att_src" [H, C],
"att_dst" [H, C], "b", "skip_w", "skip_b"}``, as PyG's ``GATConv`` (one
shared projection, no attention dropout) plus the example's skip ``Linear``:

    h = x W;  e_ij = LeakyReLU_0.2(att_src[h] . h_j[h] + att_dst[h] . h_i[h])
    out_i = sum_{j in N(i) + i} softmax_j(e_ij) h_j  (heads concatenated, or
            averaged in the last layer) + b + x_i W_skip + b_skip

with the existing self-loops removed and one added per target; ELU and
inverted dropout between layers; the logits last (the example's
log-softmax is the loss's).

Departures from PyG, which the program shares:
  * the tree form: a parent attends over the f child slots of a dense
    sampled tree and itself. Where the in-degree exceeds the fanout the
    slots are i.i.d. picks with replacement (``NeighborSampler`` draws
    without), a node picked twice counts twice, and no node is shared
    between parents or depths (each slot is a row of its own, where PyG
    deduplicates a hop's nodes);
  * the program computes in bfloat16 activations (float32 softmax and
    sums); this reference in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import losses
from .adam import Adam
from .graph import sample_tree
from .precision import Precision
from .sage import dropout
from .train import _half, _leaves, _trainable

SLOPE = 0.2
EDGE_CHUNK = 1 << 20  # in-edges of a block of destination rows, about


def _q(prec: Precision, t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to ``prec`` in the forward pass, its gradient passed
    through whole (a cast to float8 carries none); ``t`` itself in
    float32."""
    if prec.kind == "float32":
        return t
    return t + (prec.q(t) - t).detach()


def scores(prec: Precision, h: torch.Tensor, p: dict):
    """(s_src, s_dst) [n, H]: each head's features against its attention
    vectors, the products' inputs and outputs in ``prec``."""
    heads, c = p["att_src"].shape
    hv = _q(prec, h).view(h.shape[0], heads, c)
    return (_q(prec, (hv * _q(prec, p["att_src"])).sum(-1)),
            _q(prec, (hv * _q(prec, p["att_dst"])).sum(-1)))


def layer_out(prec: Precision, p: dict, agg: torch.Tensor, x: torch.Tensor,
              last: bool) -> torch.Tensor:
    """Heads concatenated (or averaged where ``last``), the bias and the skip."""
    if last:
        agg = agg.view(agg.shape[0], p["att_src"].shape[0], -1).mean(1)
    return agg + p["b"] + prec.mm(x, p["skip_w"]) + p["skip_b"]


def _attend(prec: Precision, a: torch.Tensor, hv: torch.Tensor) -> torch.Tensor:
    """sum over axis 1 of a [n, k, H] x hv [n, k, H, C]."""
    return (_q(prec, a)[..., None] * _q(prec, hv)).sum(1)


def tree_logits(prec: Precision, convs: list, xs: list, masks: list, fanouts, gen,
                rate: float) -> torch.Tensor:
    """Logits of the seeds (depth 0) of a dense tree of ``len(convs)`` hops:
    layer i projects depths 0 .. L - i and each parent depth d < L - i
    attends over its f child slots of depth d + 1 (where valid) and
    itself. Dropout draws one mask per depth array after each hidden
    layer's ELU, shallowest first."""
    n_layers = len(convs)
    for i, p in enumerate(convs):
        heads, c = p["att_src"].shape
        hs = [prec.mm(x, p["w"]) for x in xs[:n_layers - i + 1]]
        ss = [scores(prec, h, p) for h in hs]
        new = []
        for d in range(n_layers - i):
            n, f = xs[d].shape[0], int(fanouts[d])
            s_dst = ss[d][1][:, None, :]
            e = F.leaky_relu(torch.cat([ss[d][0][:, None, :] + s_dst,
                                        ss[d + 1][0].view(n, f, heads) + s_dst], dim=1), SLOPE)
            valid = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=e.device),
                               masks[d + 1].view(n, f)], dim=1)
            a = torch.softmax(e.masked_fill(~valid[..., None], float("-inf")), dim=1)
            hv = torch.cat([hs[d].view(n, 1, heads, c), hs[d + 1].view(n, f, heads, c)], dim=1)
            new.append(layer_out(prec, p, _attend(prec, a, hv).view(n, heads * c), xs[d],
                                 i == n_layers - 1))
        xs = new
        if i != n_layers - 1:
            xs = [dropout(gen, F.elu(x), rate) for x in xs]
    return xs[0]


def full_graph_logits(prec: Precision, convs: list, x: torch.Tensor, indptr: torch.Tensor,
                      indices: torch.Tensor, chunk: int = EDGE_CHUNK) -> torch.Tensor:
    """Eval over the whole graph (no dropout): every layer attends over each
    node's in-edges (self-loops removed) and its own self-loop, computed in
    blocks of destination rows of about ``chunk`` in-edges each, so that
    ogbn-products fits on the card."""
    n = indptr.shape[0] - 1
    deg = indptr[1:] - indptr[:-1]
    cuts = [0]
    while cuts[-1] < n:  # block ends: about ``chunk`` edges each
        nxt = int(torch.searchsorted(indptr, indptr[cuts[-1]] + chunk, right=True)) - 1
        cuts.append(min(max(nxt, cuts[-1] + 1), n))
    for i, p in enumerate(convs):
        heads, c = p["att_src"].shape
        h = prec.mm(x, p["w"])
        s_src, s_dst = scores(prec, h, p)
        hq = prec.q(h)
        agg = torch.empty_like(h)
        for lo, hi in zip(cuts, cuts[1:]):
            src = indices[indptr[lo]:indptr[hi]].long()
            dst = torch.repeat_interleave(torch.arange(lo, hi, device=x.device), deg[lo:hi])
            keep = src != dst
            own = torch.arange(lo, hi, device=x.device)
            src, dst = torch.cat([own, src[keep]]), torch.cat([own, dst[keep]])
            e = F.leaky_relu(s_src[src] + s_dst[dst], SLOPE)
            m = torch.full((hi - lo, heads), float("-inf"), device=x.device)
            m = m.scatter_reduce(0, (dst - lo)[:, None].expand(-1, heads), e, "amax")
            w = torch.exp(e - m[dst - lo])
            den = torch.zeros((hi - lo, heads), device=x.device).index_add_(0, dst - lo, w)
            num = torch.zeros((hi - lo, heads, c), device=x.device).index_add_(
                0, dst - lo, prec.q(w)[..., None] * hq[src].view(-1, heads, c))
            agg[lo:hi] = (num / den[..., None]).view(hi - lo, heads * c)
        x = layer_out(prec, p, agg, x, i == len(convs) - 1)
        if i != len(convs) - 1:
            x = F.elu(x)
    return x


def co_steps(prec: Precision, g: dict, p1: dict, p2: dict, batches, gen_state, *,
             fanouts, rate: float, forget_rate: float, lr: float,
             fault: str | None = None) -> dict:
    """Co-teaching steps of two GATs on dense k-hop trees, as ``train.py::
    co_steps`` runs them for SAGE (every hop sampled, no leaf table):
    sample each batch's tree, both nets' logits, the small-loss exchange,
    one Adam step of both nets on loss_1 + loss_2. ``g`` holds ``x`` [N, F]
    float32, ``indptr``/``indices`` and ``yhn``; the result also holds net
    1's logits of the first step (``logits``) and the gradient of their
    plain cross-entropy over the batch's valid seeds, no selection
    (``ce_grad``, by leaf)."""
    gen = torch.Generator(device=g["x"].device)
    gen.set_state(gen_state)
    p1, p2 = _trainable(p1), _trainable(p2)
    named = {**_leaves(p1, "1"), **_leaves(p2, "2")}
    opt = Adam(list(named.values()), lr=lr)
    fan = tuple(fanouts)
    out = {"loss": [], "grad": None}
    with prec.matmul_mode():
        for seeds, mask in batches:
            ids, masks = sample_tree(gen, g["indptr"], g["indices"], seeds, mask, fan)
            xs = [prec.q(g["x"][i]) for i in ids]
            o1 = tree_logits(prec, p1["convs"], xs, masks, fan, gen, rate)
            o2 = tree_logits(prec, p2["convs"], xs, masks, fan, gen, rate)
            if "logits" not in out:
                out["logits"] = o1.detach()
                net1 = {k: v for k, v in named.items() if k.startswith("1.")}
                ce = F.cross_entropy(o1[mask], g["yhn"][seeds][mask])
                ce_grads = torch.autograd.grad(ce, list(net1.values()), retain_graph=True)
                out["ce_grad"] = {k: v.detach().clone() for k, v in zip(net1, ce_grads)}
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
