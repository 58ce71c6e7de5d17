"""The TE slice against the JAX package on the CPU: the sorted segment sum
and the gather backward built on it, ``TreeTopo``'s extra edges in both
aggregations, the contrastive losses, the feature shuffles, the TE step's
contrast term given the same rewired topologies, the TE epoch (step for
step, plain and with the rewired contrast), ``make_eval_fn`` and
``confusion_matrix``.

As in tests/test_torch_port_ctp.py, the epochs run on a graph whose
in-degrees are all <= the fanouts, so every sampled tree is deterministic;
dropout is 0, both packages start from the same params, and F = 10 with a
negative-view rate of 0.1 leaves ``shuffle_pos`` the identity (it shuffles
int(F * rate) > 1 columns only). The rewire inside the contrast epoch picks
edges from the nets' hidden rows, which differ between the packages in the
last bits. So the graph is a well-conditioned input (see ``world``): no
node repeats within a tree, so no two hidden rows are equal. The picks
themselves are held exactly, ties included, in
tests/test_torch_port_rewire.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noise_gnn_tpu.augment import features as jfeat
from noise_gnn_tpu.augment import rewire as jrw
from noise_gnn_tpu.eval import metrics as jmetrics
from noise_gnn_tpu.graph.containers import CSRGraph as JCSR
from noise_gnn_tpu.losses import contrastive as jcon
from noise_gnn_tpu.models import nets as jnets
from noise_gnn_tpu.ops import tree_agg as jtree
from noise_gnn_tpu.train import steps as JS
from noise_gnn_tpu_torch.augment import features as tfeat
from noise_gnn_tpu_torch.eval import metrics as tmetrics
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.losses import contrastive as tcon
from noise_gnn_tpu_torch.models import nets as tnets
from noise_gnn_tpu_torch.models.convert import params_from_jax
from noise_gnn_tpu_torch.ops import scatter as tsc
from noise_gnn_tpu_torch.ops import tree_agg as ttree
from noise_gnn_tpu_torch.train import steps as TS

torch.set_num_threads(1)

LR = 1e-3
FANOUTS = (3, 3)
F, C, B, STEPS = 10, 4, 16, 3
RATES = dict(spl_rewire_rate=0.1, spl_noise_rate_pos=0.2, spl_noise_rate_neg=0.1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------ sorted segment sum


def test_sorted_segment_sum_matches_index_add():
    """The sorted segment sum: integer-valued rows with repeated ids give
    exactly ``index_add_``. Random floats: also bit for bit, since both add a segment's rows in index
    order on the CPU. Empty segments are 0."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 40, 500))
    for data in (torch.from_numpy(rng.integers(-9, 10, (500, 6)).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal((500, 6)).astype(np.float32))):
        want = torch.zeros(50, 6).index_add_(0, ids, data)
        assert torch.equal(tsc.segment_sum(data, ids, 50), want)
    bf = torch.from_numpy(rng.integers(-9, 10, 500).astype(np.float32)).bfloat16()
    got = tsc.segment_sum(bf, ids, 50)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), torch.zeros(50).index_add_(0, ids, bf.float()))


def test_fast_take_backward_matches_index_select():
    """The gradient of ``fast_take`` from a source that requires grad is the
    gradient of ``index_select``, exactly, on integer-valued inputs with
    repeated ids; without grad it is a plain gather."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-5, 6, (30, 4)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 30, (7, 11)))
    g = torch.from_numpy(rng.integers(-3, 4, (7, 11, 4)).astype(np.float32))
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    out = tsc.fast_take(a, idx)
    assert torch.equal(out, x[idx])
    (out * g).sum().backward()
    (torch.index_select(b, 0, idx.reshape(-1)).reshape(7, 11, 4) * g).sum().backward()
    assert torch.equal(a.grad, b.grad)
    assert torch.equal(tsc.fast_take(x, idx), x[idx])


# ---------------------------------------------------------- tree extras


def _extra_topos(seed):
    """A JAX and a port TreeTopo with 30 extra edges (a fifth masked)."""
    bsz, fan = 5, (3, 2)
    n = bsz * (1 + 3 + 6)
    rng = np.random.default_rng(seed)
    mask = rng.random(n - bsz) < 0.7
    es, ed = rng.integers(0, n, 30), rng.integers(0, n, 30)
    em = rng.random(30) < 0.8
    jt = jtree.TreeTopo(bsz, fan, jnp.asarray(mask), jnp.asarray(es, jnp.int32),
                        jnp.asarray(ed, jnp.int32), jnp.asarray(em))
    tt = ttree.TreeTopo(bsz, fan, torch.from_numpy(mask), torch.from_numpy(es),
                        torch.from_numpy(ed), torch.from_numpy(em))
    return jt, tt, n


@pytest.mark.parametrize("aggr", [pytest.param("mean", marks=pytest.mark.slow), "sum", "max"])
def test_tree_gather_scatter_extras_match(aggr):
    """Integer-valued rows: the outputs, and for sum the gradient through
    the extras' gather, exactly the JAX package's."""
    jt, tt, n = _extra_topos(2)
    x = np.random.default_rng(3).integers(-6, 7, (n, 5)).astype(np.float32)
    w = np.random.default_rng(4).integers(-2, 3, (n, 5)).astype(np.float32)

    # eager: under jit XLA may round the mean's division differently
    want = jtree.tree_gather_scatter(jnp.asarray(x), jt, aggr=aggr)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ttree.tree_gather_scatter(xt, tt, aggr=aggr)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    if aggr == "sum":
        jg = jax.jit(jax.grad(lambda u: (jtree.tree_gather_scatter(u, jt, "sum") * w).sum()))(
            jnp.asarray(x))
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


def test_tree_parent_gather_extras_and_parent_of_match():
    jt, tt, n = _extra_topos(5)
    p = np.random.default_rng(6).integers(0, 9, (n, 3)).astype(np.float32)
    ids = np.arange(n + 3)
    jtot, jdeg, jpar = jax.jit(lambda p, ids: (*jtree.tree_parent_gather(p, jt),
                                               jt.parent_of(ids)))(jnp.asarray(p),
                                                                   jnp.asarray(ids))
    ttot, tdeg = ttree.tree_parent_gather(torch.from_numpy(p), tt)
    np.testing.assert_array_equal(ttot.numpy(), np.asarray(jtot))
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    np.testing.assert_array_equal(tt.parent_of(torch.from_numpy(ids)).numpy(), np.asarray(jpar))


# ----------------------------------------------------- contrastive losses


def test_contrastive_losses_match():
    rng = np.random.default_rng(7)
    h, hp1, hp2, hn = (rng.standard_normal((12, 6)).astype(np.float32) for _ in range(4))
    pm, nm = rng.random(12) < 0.5, rng.random(12) < 0.6
    J = [jnp.asarray(v) for v in (h, hp1, hp2, hn, pm, nm)]
    T = [torch.from_numpy(v) for v in (h, hp1, hp2, hn, pm, nm)]

    p, q = (rng.dirichlet(np.ones(5), 8).astype(np.float32) for _ in range(2))
    logits = np.round(rng.standard_normal((20, 5)), 1).astype(np.float32)  # ties
    tgt = rng.integers(0, 5, 20)
    mask_sets = ((None, None), (4, 5), (4, None))

    @jax.jit
    def jax_side(J, p, q, logits, tgt):
        jl = jcon.discriminator_innerprod(J[0], J[1], J[3])
        j2 = jcon.discriminator_innerprod2(J[0], J[1], J[2], J[3])
        bce = []
        for masks in mask_sets:
            jm = [None if i is None else J[i] for i in masks]
            bce.append((jcon.bce_expert_loss(*jl, *jm), jcon.bce_expert_loss2(*j2, *jm)))
        return (jl, j2, bce, jcon.kl_divergence(p, q), jcon.jensen_shannon(p, q),
                jcon.topk_accuracy(logits, tgt, (1, 2, 3)))

    jl, j2, jbce, jkl, jjs, jacc = jax_side(J, jnp.asarray(p), jnp.asarray(q),
                                            jnp.asarray(logits), jnp.asarray(tgt))

    def close(a, b):
        np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                                   atol=1e-6)

    tl = tcon.discriminator_innerprod(T[0], T[1], T[3])
    for a, b in zip(jl, tl):
        close(a, b.numpy())
    t2 = tcon.discriminator_innerprod2(T[0], T[1], T[2], T[3])
    for a, b in zip(j2, t2):
        close(a, b.numpy())
    for masks, (want1, want2) in zip(mask_sets, jbce):
        tm = [None if i is None else T[i] for i in masks]
        close(want1, float(tcon.bce_expert_loss(*tl, *tm)))
        close(want2, float(tcon.bce_expert_loss2(*t2, *tm)))
    close(jkl, tcon.kl_divergence(torch.from_numpy(p), torch.from_numpy(q)).numpy())
    close(jjs, tcon.jensen_shannon(torch.from_numpy(p), torch.from_numpy(q)).numpy())
    for a, b in zip(jacc, tcon.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(tgt),
                                             (1, 2, 3))):
        close(a, float(b))


def test_shuffles_are_row_permutations():
    """``shuffle_pos`` permutes int(F * prob) entries within each row (the
    row's multiset kept, the other entries in place) and is the identity at
    int(F * prob) <= 1; ``shuffle_neg`` is a permutation of the rows."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.permutation(30 * 40).reshape(30, 40).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    out = tfeat.shuffle_pos(gen, x, prob=0.3)
    assert torch.equal(out.sort(dim=1).values, x.sort(dim=1).values)
    moved = (out != x).sum(dim=1)
    assert int(moved.max()) <= 12 and int(moved.sum()) > 0
    assert tfeat.shuffle_pos(gen, x, prob=0.02) is x
    neg = tfeat.shuffle_neg(gen, x)
    assert sorted(neg[:, 0].tolist()) == sorted(x[:, 0].tolist())
    assert torch.equal(neg, x[(neg[:, :1] == x[:, 0][None, :]).float().argmax(dim=1)])
    # the JAX package's shuffles have the same contract at the same shapes
    jx = jnp.asarray(x.numpy())
    jo = np.asarray(jax.jit(lambda k, v: jfeat.shuffle_pos(k, v, prob=0.3))(
        jax.random.key(0), jx))
    np.testing.assert_array_equal(np.sort(jo, axis=1), np.sort(x.numpy(), axis=1))
    assert jfeat.shuffle_pos(jax.random.key(0), jx, prob=0.02) is jx


# ------------------------------------------------------------- TE step


def _pl_specs(n_nodes, hidden=16, layers=2):
    kw = dict(module="sagePL", in_size=F, hidden_size=hidden, out_size=C,
              num_layers=layers, dropout=0.0, nbr_nodes=n_nodes)
    return jnets.NetSpec(**kw), tnets.NetSpec(**kw)


@pytest.mark.slow
def test_contrast_term_matches_given_topologies():
    """The contrast terms of one step from the same flat subgraph, hidden
    rows and rewired topologies (the JAX package's own rewire, handed to
    both), at 1e-5; the negative view is unshuffled (F = 10, rate 0.1)."""
    bsz, fan = 6, (3, 2)
    n_sub = bsz * 10
    rng = np.random.default_rng(9)
    js, ts = _pl_specs(200, layers=3)
    p1, p2 = (jnets.init_params(jax.random.key(k), js) for k in (1, 2))
    q1, q2 = params_from_jax(_np(p1)), params_from_jax(_np(p2))
    x = rng.standard_normal((n_sub, F)).astype(np.float32)
    n_id = rng.integers(0, 200, n_sub).astype(np.int32)
    mask = rng.random(n_sub - bsz) < 0.8
    noisy1, noisy2 = rng.random(bsz) < 0.5, rng.random(bsz) < 0.5

    @jax.jit
    def jax_side(p1, p2, jx, jn, mask, noisy1, noisy2):
        """The JAX step's rewire and contrast branch (train/steps.py:618-652)."""
        topo = jtree.TreeTopo(bsz, fan, mask)

        def japply(p, xx, t, rate):
            return jnets.apply(js, p, xx, t, num_nodes=n_sub, train=True,
                               key=jax.random.key(0), n_id=jn, noise_rate=rate)

        h1, h2 = japply(p1, jx, topo, 0.2)["h_pure"], japply(p2, jx, topo, 0.2)["h_pure"]
        pos, neg = jrw.topk_rewire_tree(h1, topo, 0.1)
        lcs = []
        for p, h, noisy in ((p1, h1, noisy1), (p2, h2, noisy2)):
            lp, ln = jcon.discriminator_innerprod(
                h[:bsz], japply(p, jx, pos, 0.2)["h_pure"][:bsz],
                japply(p, jx, neg, 0.1)["h_noisy"][:bsz])
            lcs.append(jcon.bce_expert_loss(lp, ln, noisy, noisy))
        topos = [(t.edge_mask, t.extra_src, t.extra_dst, t.extra_mask) for t in (pos, neg)]
        return lcs, h1, h2, topos

    lcs, h1, h2, (pos, neg) = jax_side(p1, p2, jnp.asarray(x), jnp.asarray(n_id),
                                       jnp.asarray(mask), jnp.asarray(noisy1),
                                       jnp.asarray(noisy2))
    want = [float(v) for v in lcs]

    def port_topo(t):
        em, es, ed, xm = (torch.from_numpy(np.array(a)) for a in t)
        return ttree.TreeTopo(bsz, fan, em, es.long(), ed.long(), xm)

    th1, th2 = (torch.from_numpy(np.array(h)) for h in (h1, h2))
    got = TS.te_contrast_loss(ts, q1, q2, torch.from_numpy(x), torch.from_numpy(n_id).long(),
                              th1, th2, torch.from_numpy(noisy1), torch.from_numpy(noisy2),
                              port_topo(pos), port_topo(neg), torch.Generator().manual_seed(0),
                              bsz, 0.2, 0.1)
    np.testing.assert_allclose([float(v) for v in got], want, rtol=1e-5)


@pytest.fixture(scope="module")
def world():
    """A forest of STEPS * B complete ternary trees of depth 2 (edges child
    -> parent) and its roots as the seeds: every sampled tree takes every
    in-neighbour, and no node id repeats within a step's tree, so no two
    rows of the hidden are equal. Equal rows would make similarities that
    are equal in exact arithmetic, whose order the last bits of each
    package's matmul decide (tests/test_torch_port_rewire.py)."""
    rng = np.random.default_rng(0)
    roots = np.arange(STEPS * B) * 13
    src, dst = [], []
    for r in roots:
        kids = r + 1 + np.arange(3)
        src += kids.tolist()
        dst += [r] * 3
        for j, kid in enumerate(kids):
            src += (r + 4 + 3 * j + np.arange(3)).tolist()
            dst += [kid] * 3
    ei = np.stack([np.asarray(src, np.int32), np.asarray(dst, np.int32)])
    n = STEPS * B * 13
    x = rng.standard_normal((n, F)).astype(np.float32)
    y = rng.integers(0, C, n).astype(np.int32)
    yhn = np.where(rng.random(n) < 0.3, (y + 1) % C, y).astype(np.int32)
    seeds = rng.permutation(roots).reshape(STEPS, B).astype(np.int32)
    masks = np.ones((STEPS, B), bool)
    clean = y == yhn
    jd = JS.GraphData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yhn), jnp.asarray(clean),
                      JCSR.from_coo(ei, n))
    td = TS.GraphData(torch.from_numpy(x), torch.from_numpy(y).long(),
                      torch.from_numpy(yhn).long(), torch.from_numpy(clean),
                      CSRGraph.from_coo(ei, n))
    return dict(seeds=seeds, masks=masks, jd=jd, td=td, ei=ei, n=n)


def _assert_params(jparams, tparams, atol=1e-4):
    np.testing.assert_allclose(tparams["noise"].detach().numpy(), np.asarray(jparams["noise"]),
                               atol=atol, err_msg="noise")
    for jc, tc in zip(jparams["convs"], tparams["convs"]):
        for k in jc:
            np.testing.assert_allclose(tc[k].detach().numpy(), np.asarray(jc[k]),
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("use_contrast,algo", [
    pytest.param(False, "coteaching", marks=pytest.mark.slow), (True, "coteaching"),
    pytest.param(True, "codi", marks=pytest.mark.slow)])
def test_te_epoch_matches(world, use_contrast, algo):
    """3 TE steps: summed metrics within 1e-5 relative (1e-6 absolute for
    the zero contrast terms of the plain epoch), params within atol 1e-4."""
    js, ts = _pl_specs(world["n"])
    opt = optax.adam(LR)
    p1, p2 = (jnets.init_params(jax.random.key(k), js) for k in (1, 2))

    def adam(params):
        return torch.optim.Adam(params, lr=LR)

    s1 = TS.state_from_params(params_from_jax(_np(p1)), adam)
    s2 = TS.state_from_params(params_from_jax(_np(p2)), adam)
    kw = dict(algo=algo, co_lambda=0.3, use_contrast=use_contrast, spl_cont_beta=0.7, **RATES)
    epoch = JS.make_te_epoch(js, opt, FANOUTS, **kw)
    js_, jm = epoch(JS.TrainState((p1, p2), opt.init((p1, p2))), world["jd"],
                    jnp.asarray(world["seeds"]), jnp.asarray(world["masks"]),
                    jax.random.key(3), jnp.float32(0.25))
    tm = TS.te_epoch(ts, s1, s2, world["td"], torch.from_numpy(world["seeds"]).long(),
                     torch.from_numpy(world["masks"]), torch.Generator().manual_seed(3),
                     0.25, FANOUTS, **kw)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert (float(tm["loss_cont_1"]) > 0) == use_contrast
    _assert_params(js_.params[0], s1.params)
    _assert_params(js_.params[1], s2.params)


def test_eval_fn_and_confusion_matrix_match(world):
    """``make_eval_fn`` on the full edge list (sagePL's conv stack and plain
    sage) at atol 2e-5, and ``confusion_matrix`` and ``evaluate_splits``
    exactly."""
    for module in ("sagePL", "sage"):
        kw = dict(module=module, in_size=F, hidden_size=16, out_size=C, dropout=0.0,
                  nbr_nodes=world["n"])
        js, ts = jnets.NetSpec(**kw), tnets.NetSpec(**kw)
        p = jnets.init_params(jax.random.key(4), js)
        want = JS.make_eval_fn(js)(p, world["jd"].x, jnp.asarray(world["ei"]))
        got = TS.make_eval_fn(ts)(params_from_jax(_np(p)), world["td"].x,
                                  torch.from_numpy(world["ei"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    rng = np.random.default_rng(10)
    yt, yp = rng.integers(0, 6, 300), rng.integers(0, 6, 300)
    np.testing.assert_array_equal(tmetrics.confusion_matrix(yt, yp, 7),
                                  jmetrics.confusion_matrix(yt, yp, 7))
    logits = rng.integers(-3, 4, (300, 6)).astype(np.float32)
    split = {"train": np.arange(100), "valid": np.arange(100, 200), "test": np.arange(200, 300)}
    assert (tmetrics.evaluate_splits(torch.from_numpy(logits), yt, split)
            == jmetrics.evaluate_splits(jnp.asarray(logits), yt, split))
