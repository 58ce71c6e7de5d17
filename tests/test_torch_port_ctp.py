"""The CTP slice against the JAX package on the CPU: the flat-tree
aggregations, the consistency losses, the sagePL forward, the CTP epoch
(step for step) and the sagePL pair inference (a tiny ``PipelineCTP`` run
is in tests/test_torch_port_checkpoint.py, with the other pipeline runs).

The CTP epoch runs on a graph whose in-degrees are all <= the fanouts, so
every sampled tree is deterministic; dropout is 0 and both packages start
from the same params (``params_from_jax``), sagePL's noise included. After
3 steps the summed metrics and the params agree at atol 1e-4 (Adam's
m/sqrt(v) turns last-bit gradient differences into ~lr-sized steps)."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noise_gnn_tpu.eval.inference import FullGraphInference as JInfer
from noise_gnn_tpu.graph.containers import CSRGraph as JCSR
from noise_gnn_tpu.losses import consistency as jcons
from noise_gnn_tpu.models import nets as jnets
from noise_gnn_tpu.ops import tree_agg as jtree
from noise_gnn_tpu.ops.sampler import flat_edge_index as j_flat_edge_index
from noise_gnn_tpu.train import steps as JS
from noise_gnn_tpu_torch.eval.inference import FullGraphInference as TInfer
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.losses import consistency as tcons
from noise_gnn_tpu_torch.models import nets as tnets
from noise_gnn_tpu_torch.models.convert import params_from_jax
from noise_gnn_tpu_torch.ops import tree_agg as ttree
from noise_gnn_tpu_torch.ops.sampler import flat_edge_index as t_flat_edge_index
from noise_gnn_tpu_torch.train import steps as TS

torch.set_num_threads(1)

LR = 1e-3
FANOUTS = (3, 3)
N, F, C, B, STEPS = 90, 10, 4, 16, 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _topos(bsz, fanouts, seed):
    """A JAX and a port TreeTopo over the same random edge mask."""
    sizes = [bsz]
    for f in fanouts:
        sizes.append(sizes[-1] * f)
    mask = np.random.default_rng(seed).random(sum(sizes[1:])) < 0.7
    return (jtree.TreeTopo(bsz, fanouts, jnp.asarray(mask)),
            ttree.TreeTopo(bsz, fanouts, torch.from_numpy(mask)), sum(sizes), mask)


# ------------------------------------------------------ tree aggregation


@pytest.mark.parametrize("aggr", ["mean", "sum", "max"])
def test_tree_gather_scatter_matches(aggr):
    jt, tt, n, _ = _topos(5, (3, 2), 0)
    x = np.random.default_rng(1).standard_normal((n, 7)).astype(np.float32)
    want = jtree.tree_gather_scatter(jnp.asarray(x), jt, aggr=aggr)
    got = ttree.tree_gather_scatter(torch.from_numpy(x), tt, aggr=aggr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_tree_parent_gather_and_flat_edges_match():
    jt, tt, n, mask = _topos(4, (3, 3), 2)
    p = np.random.default_rng(3).random((n, 5)).astype(np.float32)
    (jtot, jdeg), (ttot, tdeg) = (jtree.tree_parent_gather(jnp.asarray(p), jt),
                                  ttree.tree_parent_gather(torch.from_numpy(p), tt))
    np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    np.testing.assert_array_equal(t_flat_edge_index(4, (3, 3)), j_flat_edge_index(4, (3, 3)))
    # extra edges that are all masked out change nothing
    zeros = torch.zeros(3, dtype=torch.long)
    masked = ttree.TreeTopo(4, (3, 3), torch.from_numpy(mask), zeros, zeros,
                            torch.zeros(3, dtype=torch.bool))
    mtot, mdeg = ttree.tree_parent_gather(torch.from_numpy(p), masked)
    assert torch.equal(mtot, ttot) and torch.equal(mdeg, tdeg)


@pytest.mark.parametrize("fanouts", [(3, 2), ()])
def test_flat_subgraph_topo_matches_flat_edges(fanouts):
    """The flat view of a sampled tree: ``TreeBatch.flat_edges()`` equals the
    JAX package's on the same tree, and the ``TreeTopo`` that
    ``_flat_subgraph`` builds aggregates as the edge-list path on those
    edges (atol 1e-6: f32 sums in another order)."""
    from noise_gnn_tpu.ops.sampler import TreeBatch as JTreeBatch
    from noise_gnn_tpu_torch.ops.sampler import sample_khop_tree
    from noise_gnn_tpu_torch.ops.scatter import gather_scatter_mean

    rng = np.random.default_rng(7)
    n = 40
    ei = rng.integers(0, n, (2, 150)).astype(np.int32)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    data = TS.GraphData(x=torch.from_numpy(x), y=None, yhn=None, clean=None,
                        csr=CSRGraph.from_coo(ei, n, torch.device("cpu")))
    seed_mask = torch.from_numpy(np.arange(6) < 5)
    tb = sample_khop_tree(torch.Generator().manual_seed(0), data.csr,
                          torch.arange(6), fanouts, seed_mask)
    t_ei, t_mask = tb.flat_edges()
    j_ei, j_mask = JTreeBatch(tuple(jnp.asarray(v.numpy()) for v in tb.n_ids),
                              tuple(jnp.asarray(m.numpy()) for m in tb.masks),
                              fanouts, 6).flat_edges()
    np.testing.assert_array_equal(t_ei.numpy(), np.asarray(j_ei))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    x_sub, _, _, topo = TS._flat_subgraph(data, tb)
    np.testing.assert_array_equal(topo.edge_mask.numpy(), t_mask.numpy())
    np.testing.assert_allclose(
        ttree.tree_gather_scatter(x_sub, topo).numpy(),
        gather_scatter_mean(x_sub, t_ei, x_sub.shape[0], t_mask).numpy(), atol=1e-6)


# ------------------------------------------------------ consistency losses


def _log_probs(rng, n, c):
    z = rng.standard_normal((n, c)).astype(np.float32)
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


@pytest.mark.parametrize("as_tree", [True, False])
def test_consistency_losses_match(as_tree):
    """entropy, get_uncertainty, ce_loss, fix_cr and neighbor_align at atol
    1e-6 (f32 sums in another order), on a TreeTopo and on its edge list."""
    bsz, c = 6, 5
    jt, tt, n, mask = _topos(bsz, (3, 2), 4)
    rng = np.random.default_rng(5)
    yp, yn = _log_probs(rng, n, c), _log_probs(rng, n, c)
    noisy = rng.random(n) < 0.5
    smask = np.arange(bsz) < bsz - 1
    if as_tree:
        jg, tg, jm, tm = jt, tt, None, None
    else:
        ei = j_flat_edge_index(bsz, (3, 2))
        jg, tg = jnp.asarray(ei), torch.from_numpy(ei)
        jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    J = [jnp.asarray(v) for v in (yp, yn, noisy, smask)]
    T = [torch.from_numpy(v) for v in (yp, yn, noisy, smask)]

    def close(a, b):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-6)

    close(jcons.entropy(jnp.exp(J[0])), tcons.entropy(torch.exp(T[0])))
    jw = jcons.get_uncertainty(jg, J[0], c, edge_mask=jm)
    tw = tcons.get_uncertainty(tg, T[0], c, edge_mask=tm)
    close(jw, tw)
    close(jcons.ce_loss(J[1], jnp.asarray(yp.argmax(-1))),
          tcons.ce_loss(T[1], torch.from_numpy(yp.argmax(-1))))
    close(jcons.ce_loss(J[1], jnp.exp(J[0]), False), tcons.ce_loss(T[1], torch.exp(T[0]), False))
    for kw in (dict(), dict(name="l2"), dict(use_hard_labels=False, p_cutoff=0.3)):
        close(jcons.fix_cr(J[0], J[1], bsz, w=jw, sample_mask=J[3], **kw),
              tcons.fix_cr(T[0], T[1], bsz, w=tw, sample_mask=T[3], **kw))
    close(jcons.fix_cr(J[0], J[1], bsz), tcons.fix_cr(T[0], T[1], bsz))
    for conf in (0.0, 0.2):
        close(jcons.neighbor_align(jg, J[0], J[2], ncr_conf=conf, edge_mask=jm),
              tcons.neighbor_align(tg, T[0], T[2], ncr_conf=conf, edge_mask=tm))


# --------------------------------------------------------------- sagePL


def _pl_specs(n_nodes, hidden=16, layers=2):
    kw = dict(module="sagePL", in_size=F, hidden_size=hidden, out_size=C,
              num_layers=layers, dropout=0.0, nbr_nodes=n_nodes)
    return jnets.NetSpec(**kw), tnets.NetSpec(**kw)


@pytest.mark.parametrize("as_tree", [True, False])
def test_sagepl_apply_matches(as_tree):
    """The six outputs of the pure and noisy passes at atol 1e-5."""
    bsz = 4
    jt, tt, n, mask = _topos(bsz, (3, 3), 6)
    js, ts = _pl_specs(200, layers=3)
    p = jnets.init_params(jax.random.key(7), js)
    q = params_from_jax(_np(p))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, F)).astype(np.float32)
    n_id = rng.integers(0, 200, n).astype(np.int32)
    if as_tree:
        jg, tg, jm, tm = jt, tt, None, None
    else:
        ei = j_flat_edge_index(bsz, (3, 3))
        jg, tg = jnp.asarray(ei), torch.from_numpy(ei)
        jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    want = jnets.apply(js, p, jnp.asarray(x), jg, num_nodes=n, edge_mask=jm,
                       n_id=jnp.asarray(n_id), noise_rate=0.3)
    got = tnets.apply(ts, q, torch.from_numpy(x), tg, num_nodes=n, edge_mask=tm,
                      n_id=torch.from_numpy(n_id), noise_rate=0.3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


# ------------------------------------------------------------ CTP epoch


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    src, dst = [], []
    for v in range(N):
        k = int(rng.integers(0, min(FANOUTS) + 1))
        nb = rng.choice(np.delete(np.arange(N), v), size=k, replace=False)
        src.extend(nb.tolist())
        dst.extend([v] * k)
    ei = np.stack([np.asarray(src, np.int32), np.asarray(dst, np.int32)])
    x = rng.standard_normal((N, F)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    yhn = np.where(rng.random(N) < 0.3, (y + 1) % C, y).astype(np.int32)
    seeds = rng.permutation(N)[:STEPS * B - 5]
    seeds = np.concatenate([seeds, np.zeros(5, np.int64)]).reshape(STEPS, B).astype(np.int32)
    masks = (np.arange(STEPS * B) < STEPS * B - 5).reshape(STEPS, B)
    clean = y == yhn
    jcsr, tcsr = JCSR.from_coo(ei, N), CSRGraph.from_coo(ei, N)
    jd = JS.GraphData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yhn), jnp.asarray(clean),
                      jcsr)
    td = TS.GraphData(torch.from_numpy(x), torch.from_numpy(y).long(),
                      torch.from_numpy(yhn).long(), torch.from_numpy(clean), tcsr)
    return dict(seeds=seeds, masks=masks, jd=jd, td=td)


def _assert_params(jparams, tparams, atol=1e-4):
    np.testing.assert_allclose(tparams["noise"].detach().numpy(), np.asarray(jparams["noise"]),
                               atol=atol, err_msg="noise")
    for jc, tc in zip(jparams["convs"], tparams["convs"]):
        for k in jc:
            np.testing.assert_allclose(tc[k].detach().numpy(), np.asarray(jc[k]),
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("use_cr,use_ncr", [(False, False), (True, False), (True, True)])
def test_ctp_epoch_matches(world, use_cr, use_ncr):
    js, ts = _pl_specs(N)
    opt = optax.adam(LR)
    p1 = jnets.init_params(jax.random.key(1), js)
    p2 = jnets.init_params(jax.random.key(2), js)

    def adam(params):
        return torch.optim.Adam(params, lr=LR)

    s1 = TS.state_from_params(params_from_jax(_np(p1)), adam)
    s2 = TS.state_from_params(params_from_jax(_np(p2)), adam)
    kw = dict(use_cr=use_cr, beta=0.7, spl_noise=0.2, use_ncr=use_ncr)
    epoch = JS.make_ctp_epoch(js, opt, FANOUTS, **kw)
    j1, j2, jm = epoch(JS.TrainState(p1, opt.init(p1)), JS.TrainState(p2, opt.init(p2)),
                       world["jd"], jnp.asarray(world["seeds"]), jnp.asarray(world["masks"]),
                       jax.random.key(3), jnp.float32(0.25))
    tm = TS.ctp_epoch(ts, s1, s2, world["td"], torch.from_numpy(world["seeds"]).long(),
                      torch.from_numpy(world["masks"]), torch.Generator().manual_seed(3),
                      0.25, FANOUTS, **kw)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4, err_msg=k)
    if use_cr:
        assert float(tm["loss_cr_1"]) > 0
    _assert_params(j1.params, s1.params)
    _assert_params(j2.params, s2.params)


def test_sagepl_pair_inference_matches(world):
    """Full-graph single and pair eval of two sagePL nets (the conv stack
    only, no input noise) at atol 2e-5, with and without the x_agg table."""
    js, ts = _pl_specs(N)
    jd, td = world["jd"], world["td"]
    p1 = jnets.init_params(jax.random.key(4), js)
    p2 = jnets.init_params(jax.random.key(5), js)
    q1, q2 = params_from_jax(_np(p1)), params_from_jax(_np(p2))
    from noise_gnn_tpu.ops.leaf_agg import fused_leaf_table as j_fused
    from noise_gnn_tpu_torch.ops.leaf_agg import fused_leaf_table as t_fused

    for use_table in (False, True):
        xa_j = j_fused(jd.x, jd.csr, aggr="mean", backend="xla")[:, F:] if use_table else None
        xa_t = t_fused(td.x, td.csr, aggr="mean")[:, F:] if use_table else None
        jinf = JInfer(js, None, N, backend="xla", csr=jd.csr,
                      indptr_np=np.asarray(jd.csr.indptr), x_agg=xa_j)
        tinf = TInfer(ts, td.csr, x_agg=xa_t)
        np.testing.assert_allclose(tinf(q1, td.x).numpy(), np.asarray(jinf(p1, jd.x)),
                                   atol=2e-5)
        for a, b in zip(tinf.pair(q1, q2, td.x), jinf.pair(p1, p2, jd.x)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
