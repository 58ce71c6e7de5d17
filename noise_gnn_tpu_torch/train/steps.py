"""Whole-epoch training loops for co-teaching, the baseline and CTP.

Port of these parts of ``noise_gnn_tpu/train/steps.py``: ``GraphData``,
``_sample_tree``, ``TrainState``/``init_state``, ``ct_epoch_fn``,
``make_baseline_epoch``, ``_flat_subgraph``, ``_ctp_step_math``,
``make_ctp_epoch``, ``_te_step_math``, ``make_te_epoch``,
``_h_step_math``, ``make_h_epoch``, ``_contrast_step_math``,
``make_contrast_train_epoch`` and ``make_eval_fn``. Where JAX scans a jitted step
over the epoch's seed batches, the port runs a Python loop of steps:
sample the tree on the device, gather its features, forward, loss,
backward, optimizer step. Per-step metrics are added into one device
tensor, so an epoch syncs with the host once, when the caller reads them.
The co-teaching step on a CUDA device in one process (no ``mesh``) is a
CUDA graph (``train/step_graph.py``): its shapes are static, it never
waits for the host, and it draws from its one generator, so after two
eager steps one capture replays it, with the same kernels in the same
order and the same draws, and the host issues one launch a step instead
of some hundreds; a state pair keeps its graph while it lives, and a call
of other shapes captures anew. Every other step (the CPU, a mesh's
collectives, the TE, CTP, H, contrast and baseline steps) runs eagerly.
The co-teaching and TE steps and their phases (sample, forward, rewire,
backward, optimizer) are spans of ``utils/profiling.py::trace`` named
``ngt.*``, which record only while a profiler session runs (a gat_ns
net's tree attention is one more, ``ngt.attn``, inside the forward); a
replayed step records them as events inside its graph, and the counter
``ct_graphed`` says which co-teaching steps were replays.

Every epoch also runs data-parallel, given a ``mesh`` (``parallel/mesh.py``;
the JAX package's ``epoch_jit(mesh=...)``): each rank samples and forwards
its own block of every step's seeds, with the draws the one-process run
would make (``Mesh.rand``, and ``Mesh.rand_flat`` over a flat subgraph);
whatever the loss reads is gathered to the whole batch, so every rank
computes the one-process loss (``ct_loss`` ranks every seed's loss); and
``_step`` sums the ranks' gradients, each of which came from its own rows
only, in one all-reduce. Batch norm takes its statistics over every rank's
rows (``layers.batch_norm``).

The flat-subgraph steps (CTP, TE, H) keep three more things so. A rank's
flat subgraph is its block of each depth, and its ``TreeTopo`` is
self-contained (each node's children are in its own subtree), so the nets'
plain passes run rank-local; flat rows are gathered into the one-process
order (``gather_flat``). The passes over a rewired graph (TE's contrast,
H's pseudo net), whose extra edges join any two rows, run whole on every
rank over the rebuilt whole subgraph (:func:`_whole_subgraph`), with the
one-process draws; so that their parameter gradient enters the sum once,
the ranks other than 0 run them on detached params (:func:`_counted_once`),
while the gradients that flow through gathered rows still come back
through each rank's own slice. And the rewire sweeps only this rank's
contiguous range of row blocks, the carries merged in rank order
(``augment/rewire.py``). On one rank each step is the one-process step.

Under tensor parallelism (the mesh's model axis, M > 1) every state is
built whole, from the one-process draws, and sharded in one place,
:func:`state_from_params`: each rank keeps its column block of every leaf
the JAX package's rule picks (``models/convert.py::shard_params``), and
Adam's moments are built on those blocks. The forwards run those products
column-parallel (``models/layers.py::tp_matmul``), the ranks of one data
index drawing alike; ``_step``'s all-reduce runs over the data axis only,
and the passes run whole on every rank run over the model axis
(:func:`_whole_pass`). :func:`state_tree` gathers a state whole and
:func:`state_from_tree` shards a whole tree, so a checkpoint is the same
at any M.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..augment.features import shuffle_pos
from ..augment.rewire import topk_rewire_tree
from ..losses.consistency import fix_cr, get_uncertainty, neighbor_align
from ..losses.contrastive import (bce_expert_loss, bce_expert_loss2, discriminator_innerprod,
                                  discriminator_innerprod2)
from ..losses.coteaching import backward_correction, codi_loss, cross_entropy, ct_loss
from ..models import nets
from ..models.convert import gather_leaves, gather_params, shard_leaf, shard_params, whole_widths
from ..ops.sampler import sample_khop_tree
from ..ops.scatter import fast_take
from ..ops.tree_agg import TreeTopo
from ..parallel.mesh import all_reduce_sum_, batch_sharding, gather_flat, gather_rows
from ..utils.profiling import count, counting, trace
from .step_graph import GraphCache


@dataclass
class GraphData:
    """Device-resident training data."""

    x: torch.Tensor  # [N, F] features (compute dtype)
    y: torch.Tensor  # [N] true labels, int64
    yhn: torch.Tensor  # [N] noisy labels, int64
    clean: torch.Tensor  # [N] bool, True = label clean (noise_or_not)
    csr: object  # graph.containers.CSRGraph, reversed CSR for in-neighbors
    # [N, 2F] fused exact-leaf table concat([x, M], 1) (ops/leaf_agg.py)
    # when `exact_leaf` is on; None otherwise
    leaf_agg: torch.Tensor | None = None


def _sample_tree(gen, data: GraphData, seeds, mask, fanouts, exact_leaf: bool, mesh=None):
    """Sample the (possibly one-hop-shallower) tree and fetch its features.

    Returns (tb, xs, leaf_agg_rows). With ``exact_leaf`` the deepest hop is
    not sampled: the deepest depth's own features and exact neighbor
    aggregate come from one gather into the fused [N, 2F] table."""
    fan_s = fanouts[:-1] if exact_leaf else fanouts
    tb = sample_khop_tree(gen, data.csr, seeds, fan_s, mask, mesh)
    if not exact_leaf:
        return tb, tb.gather_features(data.x), None
    f = data.x.shape[-1]
    xs = [data.x[ids] for ids in tb.n_ids[:-1]]
    fused = data.leaf_agg[tb.n_ids[-1]]
    xs.append(fused[:, :f])
    la = torch.where(tb.masks[-1][:, None], fused[:, f:], torch.zeros_like(fused[:, f:]))
    return tb, xs, la


class TrainState(NamedTuple):
    params: dict
    opt: torch.optim.Optimizer


def init_state(gen: torch.Generator, spec: nets.NetSpec,
               make_optimizer: Callable, device=None, mesh=None) -> TrainState:
    """Fresh Glorot params and their optimizer (this rank's blocks under
    tensor parallelism: the whole params are drawn, then sharded)."""
    params = nets.init_params(gen, spec, device)
    return state_from_params(params, make_optimizer, mesh)


def state_from_params(params: dict, make_optimizer: Callable, mesh=None) -> TrainState:
    """A state of whole ``params`` and a fresh optimizer; with a ``mesh``
    whose model axis has M > 1 ranks, of this rank's column blocks of the
    leaves the TP rule picks (``models/convert.py::shard_params``): every
    pipeline's states pass here, so one rule covers them all."""
    params = shard_params(mesh, params)
    leaves = nets.parameters(params)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(params, make_optimizer(leaves))


def state_tree(s: TrainState, mesh=None) -> dict:
    """The state as a nest of tensors for ``utils/checkpoint.py``: the
    params and, for each leaf of ``nets.parameters``, Adam's step and
    moments. Every leaf has them once the state has stepped (``_step``
    steps them all); a state that never stepped writes step 0 and zero
    moments, which is what Adam starts from. Under tensor parallelism the
    params and the moments are gathered whole (two all-gathers over the
    model axis: every rank calls it)."""
    params = gather_params(mesh, s.params)
    if not s.opt.state:
        return fresh_state_tree(params)
    leaves = nets.parameters(s.params)
    sts = [s.opt.state[p] for p in leaves]
    widths = nets.parameters(whole_widths(s.params))
    moments = gather_leaves(mesh, [st["exp_avg"] for st in sts] + [st["exp_avg_sq"] for st in sts],
                            widths * 2)
    n = len(leaves)
    opt = [{"step": st["step"].detach().cpu().float().reshape(()),
            "exp_avg": moments[i], "exp_avg_sq": moments[n + i]} for i, st in enumerate(sts)]
    return {"params": params, "opt": opt}


def fresh_state_tree(params: dict) -> dict:
    """The tree of a state that has not stepped: step 0, zero moments."""
    return {"params": params,
            "opt": [{"step": torch.zeros((), dtype=torch.float32),
                     "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
                    for p in nets.parameters(params)]}


def state_from_tree(tree: dict, make_optimizer: Callable, mesh=None) -> TrainState:
    """The inverse of :func:`state_tree`: a state holding the tree's params
    and optimizer moments (this rank's blocks of both under tensor
    parallelism, whatever layout wrote the tree)."""
    widths = nets.parameters(whole_widths(tree["params"]))
    s = state_from_params(tree["params"], make_optimizer, mesh)
    sd = s.opt.state_dict()
    sd["state"] = {i: {**o, "exp_avg": shard_leaf(mesh, o["exp_avg"], w),
                       "exp_avg_sq": shard_leaf(mesh, o["exp_avg_sq"], w)}
                   for i, (o, w) in enumerate(zip(tree["opt"], widths))}
    s.opt.load_state_dict(sd)
    return s


def _acc_count(logits, y_true, mask) -> torch.Tensor:
    return ((logits.argmax(dim=-1) == y_true) & mask).sum()


def _step(states, loss, mesh=None) -> None:
    """One optimizer step of every state on ``loss``. A leaf the loss does
    not reach steps on a zero gradient, as optax steps every leaf of its
    tree: torch's Adam would skip it (``.grad is None``), and its own step
    count, and so its bias correction, would fall behind optax's global
    count (and AdamW would not decay it). With a ``mesh`` the ranks'
    gradients, the idle leaves' zeros included, are summed in one
    all-reduce of one flat buffer before the steps, so that every rank
    steps on the one-process gradient and the replicas stay equal. The sum
    runs over the data axis alone: under tensor parallelism a sharded
    leaf's gradient is its block's whole gradient already, and a
    replicated leaf's is the same on every model rank."""
    with trace("ngt.backward"):
        for s in states:
            s.opt.zero_grad(set_to_none=True)
        loss.backward()
        leaves = [p for s in states for p in nets.parameters(s.params)]
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is not None and mesh.group is not None:
            flat = all_reduce_sum_(mesh, torch.cat([p.grad.reshape(-1) for p in leaves]))
            for p, g in zip(leaves, torch.split(flat, [p.numel() for p in leaves])):
                p.grad.copy_(g.view_as(p.grad))
    with trace("ngt.optimizer"):
        for s in states:
            s.opt.step()


CT_METRICS = ("loss_1", "loss_2", "pure_ratio_1", "pure_ratio_2", "correct_1",
              "correct_2", "agree_1", "agree_2", "noisyfit_1", "noisyfit_2",
              "corrupt_n")
BASELINE_METRICS = ("loss", "correct", "agree", "noisyfit", "corrupt_n")


def _local(mesh, b_seeds, b_mask):
    """This rank's block of a step's seeds (all of them without a mesh)."""
    if mesh is None:
        return b_seeds, b_mask
    return batch_sharding(mesh, b_seeds), batch_sharding(mesh, b_mask)


def ct_metrics(out, o1, o2, yb, yt, cb, b_mask) -> torch.Tensor:
    """A co-teaching step's :data:`CT_METRICS` from its loss output and
    whole-batch logits: the memorization probes count the fit to the NOISY
    targets overall (agree_*) and on the corrupted samples (noisyfit_*);
    counts, the host divides."""
    o1, o2 = o1.detach(), o2.detach()
    corrupt = ~cb & b_mask
    return torch.stack([
        out.loss_1.detach(), out.loss_2.detach(),
        out.pure_ratio_1, out.pure_ratio_2,
        _acc_count(o1, yt, b_mask).float(), _acc_count(o2, yt, b_mask).float(),
        _acc_count(o1, yb, b_mask).float(), _acc_count(o2, yb, b_mask).float(),
        _acc_count(o1, yb, corrupt).float(), _acc_count(o2, yb, corrupt).float(),
        corrupt.sum().float(),
    ])


_CT_GRAPHS = GraphCache()


def _hyper(opt: torch.optim.Optimizer) -> tuple:
    """The optimizer's settings that a capture bakes in."""
    return tuple(tuple((k, v) for k, v in sorted(g.items()) if k not in ("params", "capturable"))
                 for g in opt.param_groups)


def ct_graph(spec: nets.NetSpec, s1: TrainState, s2: TrainState, data: GraphData, b_seeds,
             b_mask, gen, fanouts, algo, co_lambda, exact_leaf, mesh):
    """The graph that runs this co-teaching step: one per live state pair,
    for a step on a CUDA device with no ``mesh``, keyed by what its
    capture bakes in (the shapes, the data, the generator, the settings);
    None where the step runs eagerly."""
    if mesh is not None or not data.x.is_cuda:
        return None
    sig = (spec, id(data), id(gen), tuple(fanouts), algo, co_lambda, exact_leaf,
           tuple(b_seeds.shape), b_seeds.dtype, tuple(b_mask.shape), _hyper(s1.opt),
           _hyper(s2.opt))
    return _CT_GRAPHS.get((s1.opt, s2.opt), sig, keep=(data, gen))


def ct_step(spec: nets.NetSpec, s1: TrainState, s2: TrainState, data: GraphData,
            b_seeds: torch.Tensor, b_mask: torch.Tensor, gen: torch.Generator, fr,
            fanouts: tuple[int, ...], algo: str = "coteaching", co_lambda: float = 0.1,
            exact_leaf: bool = False, mesh=None) -> torch.Tensor:
    """One co-teaching step on the batch ``b_seeds``/``b_mask`` [B]: updates
    both states in place and returns its :data:`CT_METRICS` (device). With
    a ``mesh``, this rank samples and forwards its block of the seeds and
    the loss sees the gathered whole batch. On a CUDA device without one,
    a replay of the state pair's graph (:func:`ct_graph`) after its first
    two steps."""
    graph = ct_graph(spec, s1, s2, data, b_seeds, b_mask, gen, fanouts, algo, co_lambda,
                     exact_leaf, mesh)
    if graph is None:
        met = _ct_step(spec, s1, s2, data, b_seeds, b_mask, gen, fr, fanouts, algo, co_lambda,
                       exact_leaf, mesh)
    else:
        fr = torch.as_tensor(fr, dtype=torch.float32, device=b_seeds.device)
        met = graph(lambda seeds, mask, f: _ct_step(spec, s1, s2, data, seeds, mask, gen, f,
                                                    fanouts, algo, co_lambda, exact_leaf),
                    (b_seeds, b_mask, fr), gen, (s1.opt, s2.opt))
    if counting():
        count("ct_graphed", torch.tensor(graph is not None and graph.graph is not None))
    return met


def _ct_step(spec, s1, s2, data, b_seeds, b_mask, gen, fr, fanouts, algo, co_lambda,
             exact_leaf, mesh=None) -> torch.Tensor:
    with trace("ngt.ct_step"):
        ls, lm = _local(mesh, b_seeds, b_mask)
        with trace("ngt.sample"):
            tb, xs, la = _sample_tree(gen, data, ls, lm, fanouts, exact_leaf, mesh)
        yb = data.yhn[b_seeds]
        yt = data.y[b_seeds]
        cb = data.clean[b_seeds]
        with trace("ngt.forward"):
            o1 = nets.apply_tree(spec, s1.params, xs, list(tb.masks), tb.fanouts,
                                 train=True, gen=gen, leaf_agg=la, mesh=mesh)["logits"]
            o2 = nets.apply_tree(spec, s2.params, xs, list(tb.masks), tb.fanouts,
                                 train=True, gen=gen, leaf_agg=la, mesh=mesh)["logits"]
            o1, o2 = gather_rows(mesh, o1), gather_rows(mesh, o2)
            if algo == "codi":
                out = codi_loss(o1, o2, yb, fr, cb, co_lambda, b_mask)
            else:
                out = ct_loss(o1, o2, yb, fr, cb, b_mask)
        _step((s1, s2), out.loss_1 + out.loss_2, mesh)
        return ct_metrics(out, o1, o2, yb, yt, cb, b_mask)


def ct_epoch(spec: nets.NetSpec, s1: TrainState, s2: TrainState, data: GraphData,
             seeds: torch.Tensor, masks: torch.Tensor, gen: torch.Generator,
             forget_rate: float, fanouts: tuple[int, ...], algo: str = "coteaching",
             co_lambda: float = 0.1, exact_leaf: bool = False, mesh=None) -> dict:
    """One co-teaching epoch over seed batches ``seeds``/``masks`` [nsteps, B]
    (reference hot loop src/pipeline.py:110-133), data-parallel over
    ``mesh`` when one is given. Updates both states in place; returns the
    per-step metrics SUMMED over the epoch (device scalars, the caller
    divides; the same on every rank)."""
    fr = torch.tensor(forget_rate, dtype=torch.float32, device=seeds.device)
    tot = torch.zeros(len(CT_METRICS), dtype=torch.float32, device=seeds.device)
    for b_seeds, b_mask in zip(seeds, masks):
        tot += ct_step(spec, s1, s2, data, b_seeds, b_mask, gen, fr, fanouts, algo,
                       co_lambda, exact_leaf, mesh)
    return dict(zip(CT_METRICS, tot))


def baseline_epoch(spec: nets.NetSpec, s: TrainState, data: GraphData,
                   seeds: torch.Tensor, masks: torch.Tensor, gen: torch.Generator,
                   noise_mat: torch.Tensor, fanouts: tuple[int, ...],
                   compare_loss: str = "normal", exact_leaf: bool = False, mesh=None) -> dict:
    """One plain-CE ('normal') or backward-correction ('back') epoch
    (reference train(), src/pipeline.py:144-173), data-parallel over
    ``mesh`` as :func:`ct_epoch`; metrics summed. ``gat`` (dense attention
    wants an edge list, not a tree) runs the edge-list forward on the flat
    seed-first subgraph of the sampled tree, with its edge mask, and keeps
    the seeds' rows (JAX package steps.py:351-370); under a mesh on this
    rank's own subgraph, whose edges run child -> parent only, so that its
    attention is row-local (the dense [n, n] masks at this rank's n)."""
    tot = torch.zeros(len(BASELINE_METRICS), dtype=torch.float32, device=seeds.device)
    for b_seeds, b_mask in zip(seeds, masks):
        ls, lm = _local(mesh, b_seeds, b_mask)
        if spec.module == "gat":
            tb = sample_khop_tree(gen, data.csr, ls, fanouts, lm, mesh)
            x_sub = _flat_subgraph(data, tb)[0]
            ei, e_mask = tb.flat_edges()
            o = nets.apply(spec, s.params, x_sub, ei, num_nodes=x_sub.shape[0],
                           edge_mask=e_mask, train=True, gen=gen,
                           mesh=mesh)["logits"][:tb.batch_size]
        else:
            tb, xs, la = _sample_tree(gen, data, ls, lm, fanouts, exact_leaf, mesh)
            o = nets.apply_tree(spec, s.params, xs, list(tb.masks), tb.fanouts, train=True,
                                gen=gen, leaf_agg=la, mesh=mesh)["logits"]
        o = gather_rows(mesh, o)
        yb = data.yhn[b_seeds]
        yt = data.y[b_seeds]
        cb = data.clean[b_seeds]
        if compare_loss == "back":
            loss = backward_correction(o, yb, noise_mat, b_mask)
        else:
            w = b_mask.float()
            loss = (cross_entropy(o, yb) * w).sum() / w.sum().clamp(min=1.0)
        _step((s,), loss, mesh)
        tot += baseline_metrics(loss, o, yb, yt, cb, b_mask)
    return dict(zip(BASELINE_METRICS, tot))


def baseline_metrics(loss, o, yb, yt, cb, b_mask) -> torch.Tensor:
    """A baseline step's :data:`BASELINE_METRICS` from its whole-batch logits."""
    o = o.detach()
    corrupt = ~cb & b_mask
    return torch.stack([
        loss.detach(),
        _acc_count(o, yt, b_mask).float(),
        _acc_count(o, yb, b_mask).float(),
        _acc_count(o, yb, corrupt).float(),
        corrupt.sum().float(),
    ])


# ------------------------------------------------- co-teaching + consistency


def _flat_subgraph(data: GraphData, tb):
    """The flat seed-first subgraph view of a sampled tree: (x_sub, n_id,
    node_mask, topo), with the topology as a :class:`TreeTopo` so the conv
    layers take the scatter-free structured aggregation."""
    return _subgraph(data, tb.batch_size, tb.fanouts, tb.flat_n_id(), tb.flat_node_mask())


def _subgraph(data: GraphData, bsz: int, fanouts, n_id, node_mask):
    topo = TreeTopo(bsz, fanouts, node_mask[bsz:])
    x_sub = fast_take(data.x, n_id)
    x_sub = torch.where(node_mask[:, None], x_sub, torch.zeros_like(x_sub))
    return x_sub, n_id, node_mask, topo


def _whole_subgraph(mesh, data: GraphData, sub):
    """The whole step's flat subgraph (x_sub, n_id, node_mask, topo), in
    the one-process order, from this rank's ``sub``: the ids and the mask
    are gathered (one all-gather; a masked row's id is 0) and the features
    taken from ``data.x``, which every rank holds. ``sub`` itself without a
    mesh."""
    if mesh is None or mesh.group is None:
        return sub
    _, n_id, node_mask, topo = sub
    ids = gather_flat(mesh, torch.where(node_mask, n_id, -1), topo.sizes)
    return _subgraph(data, topo.batch_size * mesh.size, topo.fanouts, ids.clamp(min=0), ids >= 0)


def _whole_pass(mesh):
    """The mesh of a pass that every rank runs whole: its model axis alone
    (None without one)."""
    if mesh is None or mesh.model_size == 1:
        return None
    return mesh.model_only()


def _counted_once(mesh, params):
    """``params`` on rank 0 (and without a mesh); detached elsewhere. A pass
    that every rank runs whole then adds its parameter gradient to the
    ranks' sum once."""
    if mesh is None or mesh.rank == 0:
        return params
    if isinstance(params, dict):
        return {k: _counted_once(mesh, v) for k, v in params.items()}
    if isinstance(params, list):
        return [_counted_once(mesh, v) for v in params]
    return params.detach()


def ctp_step_loss(spec: nets.NetSpec, p1: dict, p2: dict, data: GraphData, seeds, mask,
                  gen: torch.Generator, forget_rate, fanouts: tuple[int, ...],
                  use_cr: bool = False, beta: float = 1.0, spl_noise: float = 0.1,
                  use_ncr: bool = False, ncr_temp: float = 0.1, mesh=None):
    """Loss of one CTP step (JAX ``_ctp_step_math``): sample the tree, run
    both sagePL nets on its flat subgraph, co-teaching on the pure logits,
    plus beta x the neighbourhood-consistency term (``use_ncr``) and the
    uncertainty-weighted FixMatch term (``use_cr``), both over the whole
    subgraph's gathered rows under a ``mesh``. Returns
    (loss_1 + loss_2, (ct, o1, o2, cr1, cr2))."""
    ls, lm = _local(mesh, seeds, mask)
    tb = sample_khop_tree(gen, data.csr, ls, fanouts, lm, mesh)
    sub = _flat_subgraph(data, tb)
    x_sub, n_id, _, topo = sub
    n_sub, bsz = x_sub.shape[0], tb.batch_size
    yb, cb = data.yhn[seeds], data.clean[seeds]

    def one_out(p):
        return nets.apply(spec, p, x_sub, topo, num_nodes=n_sub, train=True, gen=gen,
                          n_id=n_id, noise_rate=spl_noise, mesh=mesh)

    out1, out2 = one_out(p1), one_out(p2)
    o1, o2 = (gather_rows(mesh, o["z_pure"][:bsz]) for o in (out1, out2))
    ct = ct_loss(o1, o2, yb, forget_rate, cb, mask)
    loss1, loss2 = ct.loss_1, ct.loss_2
    zero = torch.zeros((), dtype=torch.float32, device=x_sub.device)
    cr1 = cr2 = zero
    if use_ncr or use_cr:
        wtopo = _whole_subgraph(mesh, data, sub)[3]
        n_all, b_all = wtopo.num_nodes, wtopo.batch_size
        y1, y2 = (gather_flat(mesh, o["y_pure"], topo.sizes) for o in (out1, out2))
    if use_ncr:
        # the reference's commented NCR path (src/pipeline_ctp.py:119-126)
        pad = torch.zeros(n_all - b_all, dtype=torch.bool, device=x_sub.device)
        loss1 = loss1 + beta * neighbor_align(wtopo, y1, torch.cat([ct.noisy_1, pad]),
                                              temp=ncr_temp)
        loss2 = loss2 + beta * neighbor_align(wtopo, y2, torch.cat([ct.noisy_2, pad]),
                                              temp=ncr_temp)
    if use_cr:
        w1 = get_uncertainty(wtopo, y1, spec.out_size).detach()
        w2 = get_uncertainty(wtopo, y2, spec.out_size).detach()
        n1, n2 = (gather_rows(mesh, o["y_noisy"][:bsz]) for o in (out1, out2))
        cr1 = fix_cr(y1, n1, b_all, w=w1, sample_mask=mask)
        cr2 = fix_cr(y2, n2, b_all, w=w2, sample_mask=mask)
        loss1 = loss1 + beta * cr1
        loss2 = loss2 + beta * cr2
    return loss1 + loss2, (ct, o1, o2, cr1, cr2)


CTP_METRICS = ("loss_1", "loss_2", "loss_cr_1", "loss_cr_2", "pure_ratio_1",
               "pure_ratio_2", "correct_1", "correct_2")


def ctp_epoch(spec: nets.NetSpec, s1: TrainState, s2: TrainState, data: GraphData,
              seeds: torch.Tensor, masks: torch.Tensor, gen: torch.Generator,
              forget_rate: float, fanouts: tuple[int, ...], use_cr: bool = False,
              beta: float = 1.0, spl_noise: float = 0.1, use_ncr: bool = False,
              ncr_temp: float = 0.1, mesh=None) -> dict:
    """One co-teaching + consistency epoch over seed batches [nsteps, B]
    (JAX ``make_ctp_epoch``), data-parallel over ``mesh`` when one is given.
    Updates both states in place; returns the per-step metrics SUMMED over
    the epoch (device scalars)."""
    fr = torch.tensor(forget_rate, dtype=torch.float32, device=seeds.device)
    tot = torch.zeros(len(CTP_METRICS), dtype=torch.float32, device=seeds.device)
    for b_seeds, b_mask in zip(seeds, masks):
        loss, (ct, o1, o2, cr1, cr2) = ctp_step_loss(
            spec, s1.params, s2.params, data, b_seeds, b_mask, gen, fr, fanouts,
            use_cr=use_cr, beta=beta, spl_noise=spl_noise, use_ncr=use_ncr,
            ncr_temp=ncr_temp, mesh=mesh)
        _step((s1, s2), loss, mesh)
        yt = data.y[b_seeds]
        tot += torch.stack([
            (ct.loss_1 + beta * cr1).detach(), (ct.loss_2 + beta * cr2).detach(),
            cr1.detach(), cr2.detach(), ct.pure_ratio_1, ct.pure_ratio_2,
            _acc_count(o1.detach(), yt, b_mask).float(),
            _acc_count(o2.detach(), yt, b_mask).float(),
        ])
    return dict(zip(CTP_METRICS, tot))


# ----------------------------------- sagePL co-teaching + rewired contrast (TE)


def te_contrast_loss(spec: nets.NetSpec, p1: dict, p2: dict, x_sub, n_id, h1, h2, noisy_1,
                     noisy_2, pos_topo: TreeTopo, neg_topo: TreeTopo, gen: torch.Generator,
                     bsz: int, spl_noise_rate_pos: float = 0.1,
                     spl_noise_rate_neg: float = 0.1, mesh=None):
    """The contrastive terms (lc1, lc2) of a TE step given its rewired
    topologies (the ``use_contrast`` branch of JAX ``_te_step_math``): each
    net's pure pass over the positive graph and noisy pass over the
    negative graph, on row-shuffled features (``shuffle_pos``), scored
    against its own pure hidden ``h1``/``h2`` by inner products, with the
    BCE means over the seeds that net's selection rejected. The passes run
    over the whole subgraph ``x_sub`` (``mesh``: the model axis alone, or
    None)."""
    n_sub = x_sub.shape[0]

    def hidden(p, x, topo, rate, branch):
        return nets.apply(spec, p, x, topo, num_nodes=n_sub, train=True, gen=gen, n_id=n_id,
                          noise_rate=rate, branch=branch, mesh=mesh)[f"h_{branch}"]

    hedge1 = hidden(p1, x_sub, pos_topo, spl_noise_rate_pos, "pure")
    hedge2 = hidden(p2, x_sub, pos_topo, spl_noise_rate_pos, "pure")
    new_x = shuffle_pos(gen, x_sub, spl_noise_rate_neg)
    hneg1 = hidden(p1, new_x, neg_topo, spl_noise_rate_neg, "noisy")
    hneg2 = hidden(p2, new_x, neg_topo, spl_noise_rate_neg, "noisy")
    lp1, ln1 = discriminator_innerprod(h1[:bsz], hedge1[:bsz], hneg1[:bsz])
    lp2, ln2 = discriminator_innerprod(h2[:bsz], hedge2[:bsz], hneg2[:bsz])
    return (bce_expert_loss(lp1, ln1, noisy_1, noisy_1),
            bce_expert_loss(lp2, ln2, noisy_2, noisy_2))


def te_step_loss(spec: nets.NetSpec, p1: dict, p2: dict, data: GraphData, seeds, mask,
                 gen: torch.Generator, forget_rate, fanouts: tuple[int, ...],
                 algo: str = "coteaching", co_lambda: float = 0.1,
                 use_contrast: bool = False, spl_cont_beta: float = 1.0,
                 spl_rewire_rate: float = 0.1, spl_noise_rate_pos: float = 0.1,
                 spl_noise_rate_neg: float = 0.1, mesh=None):
    """Loss of one TE step (JAX ``_te_step_math``): sample the tree, run
    both sagePL nets' pure passes on its flat subgraph, co-teaching (or
    CoDis) on the pure logits; with ``use_contrast``, rewire the subgraph
    from net 1's hidden (``topk_rewire_tree``) and add spl_cont_beta x
    :func:`te_contrast_loss`. Under a ``mesh`` the pure passes run on this
    rank's own subgraph, net 1's hidden is gathered whole for the rewire
    (whose row blocks the ranks share), and the contrast passes run whole
    on every rank, counted once. Returns (loss, (ct, o1, o2, lc1, lc2))."""
    ls, lm = _local(mesh, seeds, mask)
    with trace("ngt.sample"):
        tb = sample_khop_tree(gen, data.csr, ls, fanouts, lm, mesh)
        sub = _flat_subgraph(data, tb)
    x_sub, n_id, _, topo = sub
    n_sub, bsz = x_sub.shape[0], tb.batch_size
    yb, cb = data.yhn[seeds], data.clean[seeds]

    def pure(p):
        return nets.apply(spec, p, x_sub, topo, num_nodes=n_sub, train=True, gen=gen,
                          n_id=n_id, noise_rate=spl_noise_rate_pos, branch="pure", mesh=mesh)

    with trace("ngt.forward"):
        out1, out2 = pure(p1), pure(p2)
        o1, o2 = (gather_rows(mesh, o["z_pure"][:bsz]) for o in (out1, out2))
        if algo == "codi":
            ct = codi_loss(o1, o2, yb, forget_rate, cb, co_lambda, mask)
        else:
            ct = ct_loss(o1, o2, yb, forget_rate, cb, mask)
        loss = ct.loss_1 + ct.loss_2
    lc1 = lc2 = torch.zeros((), dtype=torch.float32, device=x_sub.device)
    if use_contrast:
        with trace("ngt.rewire"):
            wx, wn_id, _, wtopo = _whole_subgraph(mesh, data, sub)
            h1 = gather_flat(mesh, out1["h_pure"], topo.sizes)
            h2 = gather_rows(mesh, out2["h_pure"][:bsz])  # the seeds' rows are all it reads
            pos_topo, neg_topo = topk_rewire_tree(h1, wtopo, spl_rewire_rate, mesh=mesh)
        with trace("ngt.forward"):
            lc1, lc2 = te_contrast_loss(spec, _counted_once(mesh, p1), _counted_once(mesh, p2),
                                        wx, wn_id, h1, h2, ct.noisy_1, ct.noisy_2, pos_topo,
                                        neg_topo, gen, wtopo.batch_size, spl_noise_rate_pos,
                                        spl_noise_rate_neg, _whole_pass(mesh))
            loss = loss + spl_cont_beta * (lc1 + lc2)
    return loss, (ct, o1, o2, lc1, lc2)


TE_METRICS = ("loss_1", "loss_2", "pure_ratio_1", "pure_ratio_2", "loss_cont_1",
              "loss_cont_2", "correct_1", "correct_2")


def te_epoch(spec: nets.NetSpec, s1: TrainState, s2: TrainState, data: GraphData,
             seeds: torch.Tensor, masks: torch.Tensor, gen: torch.Generator,
             forget_rate: float, fanouts: tuple[int, ...], mesh=None, **kw) -> dict:
    """One TE epoch over seed batches [nsteps, B] (JAX ``make_te_epoch``;
    ``kw`` as :func:`te_step_loss`), data-parallel over ``mesh`` when one
    is given. The JAX package trains both nets under one Adam over the
    pair; Adam is per leaf, so the two states here take the same steps.
    Returns the per-step metrics SUMMED (device scalars)."""
    fr = torch.tensor(forget_rate, dtype=torch.float32, device=seeds.device)
    tot = torch.zeros(len(TE_METRICS), dtype=torch.float32, device=seeds.device)
    for b_seeds, b_mask in zip(seeds, masks):
        with trace("ngt.te_step"):
            loss, (ct, o1, o2, lc1, lc2) = te_step_loss(spec, s1.params, s2.params, data,
                                                        b_seeds, b_mask, gen, fr, fanouts,
                                                        mesh=mesh, **kw)
            _step((s1, s2), loss, mesh)
            yt = data.y[b_seeds]
            tot += torch.stack([
                ct.loss_1.detach(), ct.loss_2.detach(), ct.pure_ratio_1, ct.pure_ratio_2,
                lc1.detach(), lc2.detach(),
                _acc_count(o1.detach(), yt, b_mask).float(),
                _acc_count(o2.detach(), yt, b_mask).float(),
            ])
    return dict(zip(TE_METRICS, tot))


# ----------------------------------------------- pseudo-label co-teaching (H)


def h_step_loss(spec: nets.NetSpec, pseudo_spec: nets.NetSpec, p1: dict, p2: dict, pp: dict,
                data: GraphData, seeds, mask, gen: torch.Generator, forget_rate,
                fanouts: tuple[int, ...], use_pseudo: bool = False, beta: float = 1.0,
                rewire_rate: float = 0.2, mesh=None):
    """Loss of one PipelineH step (JAX ``_h_step_math``): sample the tree,
    run both nets on its flat subgraph, co-teaching on their logits; with
    ``use_pseudo``, the pseudo net ``pp`` runs on the positive graph of a
    top-k rewire of the RAW features and its detached softmax is a soft
    target for each net's rejected seeds (``loss_add``), while the pseudo
    net itself learns the noisy labels (``loss_pred``, twice the CE, as the
    reference sums it for two identical clones). Under a ``mesh`` the two
    nets run on this rank's own subgraph, and the rewire (its row blocks
    shared by the ranks) and the pseudo net run over the whole subgraph on
    every rank, the pseudo net counted once. Returns
    (loss, (ct, o1, o2, loss_pred, loss_add))."""
    ls, lm = _local(mesh, seeds, mask)
    tb = sample_khop_tree(gen, data.csr, ls, fanouts, lm, mesh)
    sub = _flat_subgraph(data, tb)
    x_sub, _, _, topo = sub
    n_sub, bsz = x_sub.shape[0], tb.batch_size
    yb, cb = data.yhn[seeds], data.clean[seeds]
    o1, o2 = (gather_rows(mesh, nets.apply(spec, p, x_sub, topo, num_nodes=n_sub, train=True,
                                           gen=gen, mesh=mesh)["logits"][:bsz])
              for p in (p1, p2))
    ct = ct_loss(o1, o2, yb, forget_rate, cb, mask)
    loss = ct.loss_1 + ct.loss_2
    loss_pred = loss_add = torch.zeros((), dtype=torch.float32, device=x_sub.device)
    if use_pseudo:
        wx, _, _, wtopo = _whole_subgraph(mesh, data, sub)
        pos_topo, _ = topk_rewire_tree(wx, wtopo, rewire_rate, neg=False, mesh=mesh)
        pl = nets.apply(pseudo_spec, _counted_once(mesh, pp), wx, pos_topo,
                        num_nodes=wx.shape[0], train=True, gen=gen,
                        mesh=_whole_pass(mesh))["logits"][:wtopo.batch_size]
        pred_soft = torch.softmax(pl, dim=-1).detach()

        def soft_ce(o, noisy):
            w = noisy.float()
            per = -(pred_soft * torch.log_softmax(o, dim=-1)).sum(dim=-1)
            return (per * w).sum() / w.sum().clamp(min=1.0)

        loss_add = soft_ce(o1, ct.noisy_1) + soft_ce(o2, ct.noisy_2)
        wm = mask.float()
        loss_pred = 2.0 * (cross_entropy(pl, yb) * wm).sum() / wm.sum().clamp(min=1.0)
        loss = loss + loss_pred + beta * loss_add
    return loss, (ct, o1, o2, loss_pred, loss_add)


H_METRICS = ("loss_1", "loss_2", "loss_pred", "loss_add", "pure_ratio_1", "pure_ratio_2",
             "correct_1", "correct_2")


def h_epoch(spec: nets.NetSpec, pseudo_spec: nets.NetSpec, s1: TrainState, s2: TrainState,
            sp: TrainState, data: GraphData, seeds: torch.Tensor, masks: torch.Tensor,
            gen: torch.Generator, forget_rate: float, fanouts: tuple[int, ...],
            use_pseudo: bool = False, beta: float = 1.0, rewire_rate: float = 0.2,
            mesh=None) -> dict:
    """One PipelineH epoch over seed batches [nsteps, B] (JAX
    ``make_h_epoch``), data-parallel over ``mesh`` when one is given. The
    JAX package steps the three nets under one joint Adam; Adam is
    elementwise and ``_step`` steps every leaf every step (the pseudo net's
    on zeros while ``use_pseudo`` is off), so the three states here take
    exactly the joint optimizer's steps. Returns the per-step metrics
    SUMMED (device scalars)."""
    fr = torch.tensor(forget_rate, dtype=torch.float32, device=seeds.device)
    tot = torch.zeros(len(H_METRICS), dtype=torch.float32, device=seeds.device)
    for b_seeds, b_mask in zip(seeds, masks):
        loss, (ct, o1, o2, lp, la) = h_step_loss(
            spec, pseudo_spec, s1.params, s2.params, sp.params, data, b_seeds, b_mask, gen,
            fr, fanouts, use_pseudo=use_pseudo, beta=beta, rewire_rate=rewire_rate, mesh=mesh)
        _step((s1, s2, sp), loss, mesh)
        yt = data.y[b_seeds]
        tot += torch.stack([
            ct.loss_1.detach(), ct.loss_2.detach(), lp.detach(), la.detach(),
            ct.pure_ratio_1, ct.pure_ratio_2,
            _acc_count(o1.detach(), yt, b_mask).float(),
            _acc_count(o2.detach(), yt, b_mask).float(),
        ])
    return dict(zip(H_METRICS, tot))


# ---------------------------------------- contrastive finetune (PipelineCT)


def contrast_step_loss(spec: nets.NetSpec, p: dict, data: GraphData, views: dict,
                       clean_seeds, clean_mask, noisy_seeds, noisy_mask, gen: torch.Generator,
                       fanouts: tuple[int, ...], lam: float = 1.0, mesh=None):
    """Loss of one PipelineCT finetune step (JAX ``_contrast_step_math``):
    CE on the noisy labels of a batch of the clean ids (one tree on the
    graph), plus ``lam`` x the two-positive contrastive BCE of a batch of
    the noisy ids embedded in four views, each its own (x, csr) in
    ``views``: "orig" (the anchor), "edge_s" and "feat_s" (the positives)
    and "large" (the negative). Under a ``mesh`` each rank embeds its block
    of both batches, and the logits and the four views' embeddings are
    gathered. Returns (loss, (loss_semi, loss_cont, o_semi))."""

    def embed(x, csr, seeds, mask, key):
        ls, lm = _local(mesh, seeds, mask)
        tb = sample_khop_tree(gen, csr, ls, fanouts, lm, mesh)
        return gather_rows(mesh, nets.apply_tree(spec, p, tb.gather_features(x), list(tb.masks),
                                                 fanouts, train=True, gen=gen, mesh=mesh)[key])

    o_semi = embed(data.x, data.csr, clean_seeds, clean_mask, "logits")
    w = clean_mask.float()
    loss_semi = (cross_entropy(o_semi, data.yhn[clean_seeds]) * w).sum() / w.sum().clamp(min=1.0)
    h, h_s1, h_s2, h_l = (embed(*views[name], noisy_seeds, noisy_mask, "h")
                          for name in ("orig", "edge_s", "feat_s", "large"))
    lp1, lp2, ln = discriminator_innerprod2(h, h_s1, h_s2, h_l)
    loss_cont = bce_expert_loss2(lp1, lp2, ln, noisy_mask, noisy_mask)
    return loss_semi + lam * loss_cont, (loss_semi, loss_cont, o_semi)


CONTRAST_METRICS = ("loss_semi", "loss_cont", "loss", "correct")


def contrast_epoch(spec: nets.NetSpec, s: TrainState, data: GraphData, views: dict,
                   clean_seeds: torch.Tensor, clean_masks: torch.Tensor,
                   noisy_seeds: torch.Tensor, noisy_masks: torch.Tensor, gen: torch.Generator,
                   fanouts: tuple[int, ...], lam: float = 1.0, mesh=None) -> dict:
    """One finetune epoch over zipped (clean, noisy) seed batches, each
    [nsteps, B] (JAX ``make_contrast_train_epoch``), data-parallel over
    ``mesh`` when one is given. Returns the per-step metrics SUMMED
    (device scalars)."""
    tot = torch.zeros(len(CONTRAST_METRICS), dtype=torch.float32, device=clean_seeds.device)
    for cs, cm, ns, nm in zip(clean_seeds, clean_masks, noisy_seeds, noisy_masks):
        loss, (ls, lc, o) = contrast_step_loss(spec, s.params, data, views, cs, cm, ns, nm,
                                               gen, fanouts, lam, mesh)
        _step((s,), loss, mesh)
        tot += torch.stack([ls.detach(), lc.detach(), loss.detach(),
                            _acc_count(o.detach(), data.y[cs], cm).float()])
    return dict(zip(CONTRAST_METRICS, tot))


# ------------------------------------------------------------------- eval


def make_eval_fn(spec: nets.NetSpec):
    """Full-graph forward on an edge list -> logits (JAX ``make_eval_fn``);
    for sagePL the plain conv stack's ``z_pure``."""

    @torch.no_grad()
    def logits_fn(params: dict, x: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
        if spec.module == "sagePL":
            return nets.apply(spec, params, x, edge_index, branch="pure")["z_pure"]
        return nets.apply(spec, params, x, edge_index)["logits"]

    return logits_fn
