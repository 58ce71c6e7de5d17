"""The port's multi-head GAT with skip connections (module ``gat_ns``)
against the benchmark's plain reference (``gnnbench/reference/gat.py``,
float32, nothing of the port), on small seeded graphs on the CPU in
float32: the parameter count at ogbn-products widths, the tree forward
(with the dropout draws replayed), the full-graph attention over CSRs
built from edge lists, the tree form against the flat subgraph, the paired
eval, one co-teaching step, three planted faults, and the refusal under a
mesh. Imports no JAX."""

from pathlib import Path

import numpy as np
import pytest
import torch

from gnnbench.reference import compare
from gnnbench.reference import gat as rgat
from gnnbench.reference.graph import in_csr
from gnnbench.reference.precision import Precision
from noise_gnn_tpu_torch.eval import inference
from noise_gnn_tpu_torch.eval.inference import FullGraphInference
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.models import nets
from noise_gnn_tpu_torch.ops import gat_attn
from noise_gnn_tpu_torch.ops.sampler import sample_khop_tree
from noise_gnn_tpu_torch.train import pipelines, steps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# float32 sums and exponentials in another order than the reference's
TOL = 1e-5
FANOUTS = (3, 2, 2)


def _spec(**kw) -> nets.NetSpec:
    return nets.NetSpec(module="gat_ns", in_size=12, hidden_size=8, out_size=5, num_layers=3,
                        heads=3, **kw)


def _graph(n: int = 60, seed: int = 0):
    """Random edges, a hub (node 3, 40 in-edges), existing self-loops on
    nodes 0-4 and an isolated node (n - 1); (edge_index [2, E] int32, x)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n - 1, 200), rng.integers(0, n - 1, 40), np.arange(5)])
    dst = np.concatenate([rng.integers(0, n - 1, 200), np.full(40, 3), np.arange(5)])
    x = torch.from_numpy(rng.standard_normal((n, 12)).astype(np.float32))
    return np.stack([src, dst]).astype(np.int32), x


def _params(spec, seed: int) -> dict:
    return nets.init_params(torch.Generator().manual_seed(seed), spec)


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _ref_full(spec, p, ei, x):
    ip, ix = in_csr(ei, x.shape[0], "cpu")
    return rgat.full_graph_logits(Precision(), p["convs"], x, ip, ix)


def test_products_width_param_count():
    """PyG's ogbn_products_gat.py at 3 layers of 4 heads x 128: the
    leaderboard's 751,574 parameters, layer by layer (conv, skip)."""
    spec = nets.NetSpec(module="gat_ns", in_size=100, hidden_size=128, out_size=47,
                        num_layers=3, heads=4)
    p = _params(spec, 0)
    per = [(sum(c[k].numel() for k in ("w", "att_src", "att_dst", "b")),
            c["skip_w"].numel() + c["skip_b"].numel()) for c in p["convs"]]
    assert per == [(52_736, 51_712), (263_680, 262_656), (96_679, 24_111)]
    assert sum(t.numel() for t in nets.parameters(p)) == 751_574


@pytest.mark.parametrize("train", [False, True], ids=["dropout_off", "dropout_replayed"])
def test_tree_forward_matches_reference(train):
    """The dense tree forward against ``tree_logits``; with dropout on, the
    reference replays the forward's draws from the generator's state."""
    spec = _spec()
    ei, x = _graph()
    csr = CSRGraph.from_coo(ei, x.shape[0])
    gen = torch.Generator().manual_seed(3)
    seeds = torch.tensor([3, 0, 7, 11, 58, 59])
    tb = sample_khop_tree(gen, csr, seeds, FANOUTS)
    xs, masks = tb.gather_features(x), list(tb.masks)
    p = _params(spec, 1)
    state = gen.get_state()
    got = nets.apply_tree(spec, p, xs, masks, FANOUTS, train=train, gen=gen)["logits"]
    ref_gen = torch.Generator()
    ref_gen.set_state(state)
    want = rgat.tree_logits(Precision(), p["convs"], xs, masks, FANOUTS,
                            ref_gen if train else None, spec.dropout)
    assert _gap(got, want) < TOL


@pytest.mark.parametrize("form", ["csr_attention", "edge_list"])
def test_full_graph_matches_reference(form):
    """The full-graph eval (the CSR attention's plain version over the
    self-looped CSR) against ``full_graph_logits`` on a graph with a hub,
    existing self-loops and an isolated node; ``edge_list`` builds the CSR
    from the edge list in another order."""
    spec = _spec()
    ei, x = _graph()
    p = _params(spec, 2)
    if form == "edge_list":
        ei_in = ei[:, np.random.default_rng(2).permutation(ei.shape[1])]
    else:
        ei_in = ei
    got = FullGraphInference(spec, CSRGraph.from_coo(ei_in, x.shape[0]))(p, x)
    assert _gap(got, _ref_full(spec, p, ei, x)) < TOL


def test_tree_form_equals_edge_list_form():
    """Where every slot is valid and nothing is picked at random (each
    in-degree equal to its fanout), the tree forward's seeds equal the
    full-graph forward over a CSR of the tree's flat subgraph (its masked
    child -> parent edges; each row its own self-loop)."""
    spec = _spec()
    n = 40
    dst = np.repeat(np.arange(n), 3)
    src = (dst + np.tile([1, 7, 12], n)) % n
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((n, 12)).astype(np.float32))
    csr = CSRGraph.from_coo(np.stack([src, dst]).astype(np.int32), n)
    tb = sample_khop_tree(torch.Generator().manual_seed(0), csr, torch.arange(5), FANOUTS)
    assert all(bool(m.all()) for m in tb.masks)
    p = _params(spec, 5)
    tree = nets.apply_tree(spec, p, tb.gather_features(x), list(tb.masks), FANOUTS)["logits"]
    ei, mask = tb.flat_edges()
    sub = CSRGraph.from_coo(ei[:, mask].numpy().astype(np.int32), tb.num_sub_nodes)
    flat = FullGraphInference(spec, sub)(p, x[tb.flat_n_id()])[:5]
    assert _gap(tree, flat) < TOL


def test_pair_equals_two_single_passes():
    spec = _spec()
    ei, x = _graph()
    infer = FullGraphInference(spec, CSRGraph.from_coo(ei, x.shape[0]))
    p1, p2 = _params(spec, 6), _params(spec, 7)
    l1, l2 = infer.pair(p1, p2, x)
    torch.testing.assert_close(l1, infer(p1, x), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l2, infer(p2, x), rtol=1e-6, atol=1e-6)


def test_ct_step_matches_reference():
    """One co-teaching step of two GATs (``steps.ct_step``) against the
    reference's ``co_steps`` replaying its draws: the loss, every leaf's
    gradient (Adam's first moment over 1 - beta1) and every moved leaf's
    update, each as a gap of norms."""
    spec = _spec()
    ei, x = _graph()
    n = x.shape[0]
    csr = CSRGraph.from_coo(ei, n)
    rng = np.random.default_rng(8)
    y = torch.from_numpy(rng.integers(0, 5, n)).long()
    yhn = torch.from_numpy(rng.integers(0, 5, n)).long()
    data = steps.GraphData(x=x, y=y, yhn=yhn, clean=y == yhn, csr=csr)
    init = [_params(spec, 9), _params(spec, 10)]
    make_opt = pipelines.make_optimizer({"learning_rate": 0.001})
    states = [steps.state_from_params({"convs": [{k: t.clone() for k, t in c.items()}
                                                 for c in p["convs"]]}, make_opt)
              for p in init]
    seeds, mask = torch.arange(8) * 7 % n, torch.arange(8) < 7
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    met = steps.ct_step(spec, *states, data, seeds, mask, gen, torch.tensor(0.2), FANOUTS)
    named = {f"{i}.conv{j}.{k}": t for i, s in ((1, states[0]), (2, states[1]))
             for j, c in enumerate(s.params["convs"]) for k, t in c.items()}
    grad = {k: s.opt.state[t]["exp_avg"] / 0.1 for k, t in named.items()
            for s in states if t in s.opt.state}
    ip, ix = in_csr(ei, n, "cpu")
    ref = rgat.co_steps(Precision(), {"x": x, "indptr": ip, "indices": ix, "yhn": yhn},
                        init[0], init[1], [(seeds, mask)], state, fanouts=FANOUTS,
                        rate=spec.dropout, forget_rate=0.2, lr=0.001)
    assert compare.rel_gap(float(met[0] + met[1]), ref["loss"][0]) < TOL
    assert max(compare.norm_gaps(grad, ref["grad"]).values()) < TOL
    flat = {f"{i}.conv{j}.{k}": t for i, p in ((1, init[0]), (2, init[1]))
            for j, c in enumerate(p["convs"]) for k, t in c.items()}
    moved = compare.moved_leaves(ref["grad"])
    gaps = compare.norm_gaps({k: named[k].detach() - flat[k] for k in moved},
                             {k: ref["params"][k] - flat[k] for k in moved})
    assert max(gaps.values()) < 1e-4  # Adam's first step: round-off near g = 0 flips signs


def _no_self_loops(indptr, indices):
    return indptr, indices


def _uniform(h, att_src, att_dst):
    z = torch.zeros((h.shape[0], att_src.shape[0]))
    return z, z


def _one_head(h, att_src, att_dst):
    s_src, s_dst = gat_scores(h, att_src, att_dst)
    return s_src[:, :1].expand_as(s_src), s_dst[:, :1].expand_as(s_dst)


gat_scores = inference.gat_scores


@pytest.mark.parametrize("fault", ["self_loop_left_out", "uniform_weights", "one_head"])
def test_planted_faults_read_beyond_tolerance(fault, monkeypatch):
    """Each fault, planted in the full-graph eval, reads far beyond the
    tolerance the forms above are held to."""
    if fault == "self_loop_left_out":
        monkeypatch.setattr(gat_attn, "self_loop_csr", _no_self_loops)
    else:
        monkeypatch.setattr(inference, "gat_scores",
                            _uniform if fault == "uniform_weights" else _one_head)
    spec = _spec()
    ei, x = _graph()
    p = _params(spec, 12)
    got = FullGraphInference(spec, CSRGraph.from_coo(ei, x.shape[0]))(p, x)
    assert _gap(got, _ref_full(spec, p, ei, x)) > 1000 * TOL


@pytest.mark.parametrize("where", ["apply_tree", "apply", "pipeline"])
def test_gat_ns_under_a_mesh_raises(where, monkeypatch):
    """Sharding gat_ns (data or tensor parallelism) is not supported: its
    tree forward and the pipeline refuse a mesh, naming the module; the
    edge-list entry refuses the module outright."""
    spec = _spec()
    ei, x = _graph()
    p = _params(spec, 13)
    mesh = object()
    with pytest.raises(ValueError, match="gat_ns"):
        if where == "apply_tree":
            csr = CSRGraph.from_coo(ei, x.shape[0])
            tb = sample_khop_tree(torch.Generator(), csr, torch.arange(4), FANOUTS)
            nets.apply_tree(spec, p, tb.gather_features(x), list(tb.masks), FANOUTS, mesh=mesh)
        elif where == "apply":
            nets.apply(spec, p, x, torch.from_numpy(ei).long(), mesh=mesh)
        else:
            from noise_gnn_tpu_torch.utils.config import load_config

            monkeypatch.setattr(pipelines.multihost, "world_size", lambda: 2)
            monkeypatch.setattr(pipelines, "make_mesh", lambda model_parallel: mesh)
            c = load_config(str(ROOT / "noise_gnn_tpu_torch" / "configs" /
                                "config_products_gat.yml"))
            c["device"] = "cpu"
            pipelines.PipelineCO(c)
