"""PipelineH's slice against the JAX package on the CPU, and the optimizer
step every port loop shares.

``_step`` steps every leaf of every state, a leaf the loss did not reach on
a zero gradient, as optax steps every leaf of its tree: a leaf idle for k
steps then moves as optax moves it, under Adam and AdamW, within 1e-7.

The H step and epoch run on a forest of complete in-trees (every sampled
tree takes every in-neighbour, and no node repeats within a step's tree),
with dropout 0 and the same initial params in both packages. The pseudo
net's rewire scores the RAW features, so the features are exact-arithmetic
rows (four entries of +-0.5: every similarity a multiple of 0.25 in any
order of summation), and the picks are decided by the tie rule, which both
packages share, not by the last bits of a matmul. The epoch test carries
the three nets' joint state from a plain epoch into a pseudo epoch, where
the pseudo net takes its first non-zero gradient: its params agree within
1e-5 only when its idle epoch advanced Adam's count as optax's does."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noise_gnn_tpu.augment import rewire as jrw
from noise_gnn_tpu.graph.containers import CSRGraph as JCSR
from noise_gnn_tpu.models import nets as jnets
from noise_gnn_tpu.ops.sampler import sample_khop_tree as j_sample
from noise_gnn_tpu.train import steps as JS
from noise_gnn_tpu_torch.augment import rewire as trw
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.models import nets as tnets
from noise_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from noise_gnn_tpu_torch.ops.sampler import sample_khop_tree as t_sample
from noise_gnn_tpu_torch.ops.tree_agg import TreeTopo
from noise_gnn_tpu_torch.train import steps as TS
from noise_gnn_tpu_torch.train.pipelines import make_optimizer

torch.set_num_threads(1)

LR = 1e-3
FANOUTS = (3, 3)
F, C, B, STEPS = 12, 4, 16, 3
RATE = 0.2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------- idle leaves


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_idle_leaf_adam_matches_optax(wd):
    """Two states, as two nets under one joint loss: for IDLE steps the loss
    reaches only state 1's ``w``, leaving its ``b`` and all of state 2 idle;
    then 2 steps reach every leaf. Every leaf ends within 1e-7 of optax's
    (``optax.adam``, or ``optax.adamw`` with weight decay ``wd``, as the
    pipelines pick them), so the idle leaves' first steps carry optax's
    bias correction (and AdamW's decay of the idle steps)."""
    idle = 3
    rng = np.random.default_rng(0)
    # |params| < 0.5, so that one rounding of the last add is under 1e-7
    init = [{"convs": [{"w": (0.1 * rng.standard_normal((3, 4))).astype(np.float32),
                        "b": (0.1 * rng.standard_normal(4)).astype(np.float32)}]}
            for _ in range(2)]
    grads = [[{"convs": [{"w": rng.standard_normal((3, 4)).astype(np.float32),
                          "b": rng.standard_normal(4).astype(np.float32)}]} for _ in range(2)]
             for _ in range(idle + 2)]
    for t in range(idle):  # idle: only state 1's w has a gradient
        grads[t][0]["convs"][0]["b"][:] = 0
        for k in ("w", "b"):
            grads[t][1]["convs"][0][k][:] = 0

    opt = optax.adamw(LR, weight_decay=wd) if wd else optax.adam(LR)

    @jax.jit
    def optax_steps(jp, grads):
        jo = opt.init(jp)
        for g in grads:
            u, jo = opt.update(g, jo, jp)
            jp = optax.apply_updates(jp, u)
        return jp

    jp = optax_steps(init, grads)

    make = make_optimizer({"learning_rate": LR, "optimizer": "adam", "weight_decay": wd})
    states = [TS.state_from_params(params_from_jax(p), make) for p in init]
    for t, g in enumerate(grads):
        reached = [(states[0].params["convs"][0]["w"], g[0]["convs"][0]["w"])]
        if t >= idle:
            reached += [(s.params["convs"][0][k], gs["convs"][0][k])
                        for s, gs in zip(states, g) for k in ("w", "b")][1:]
        loss = sum((p * torch.from_numpy(v)).sum() for p, v in reached)
        TS._step(states, loss)
    for s, want in zip(states, _np(jp)):
        got = params_to_jax(s.params)["convs"][0]
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], want["convs"][0][k], rtol=0, atol=1e-7,
                                       err_msg=k)


# ------------------------------------------------------------- H world


def exact_rows(rng, n: int, d: int, pool: int) -> np.ndarray:
    """[n, d] rows from ``pool`` distinct rows of four +-0.5 entries: every
    dot product a multiple of 0.25, exact in any order."""
    rows = np.zeros((pool, d), np.float32)
    for r in range(pool):
        rows[r, rng.choice(d, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return rows[rng.integers(0, pool, n)]


@pytest.fixture(scope="module")
def world():
    """STEPS * B complete ternary in-trees of depth 2 and their roots as
    the seeds; exact-arithmetic features."""
    rng = np.random.default_rng(0)
    size = 1 + 3 + 9
    roots = np.arange(STEPS * B) * size
    src, dst = [], []
    for r in roots:
        kids = r + 1 + np.arange(3)
        src += kids.tolist()
        dst += [r] * 3
        for j, kid in enumerate(kids):
            src += (r + 4 + 3 * j + np.arange(3)).tolist()
            dst += [kid] * 3
    ei = np.stack([np.asarray(src, np.int32), np.asarray(dst, np.int32)])
    n = STEPS * B * size
    x = exact_rows(rng, n, F, 40)
    y = rng.integers(0, C, n).astype(np.int32)
    yhn = np.where(rng.random(n) < 0.3, (y + 1) % C, y).astype(np.int32)
    seeds = rng.permutation(roots).reshape(STEPS, B).astype(np.int32)
    masks = np.ones((STEPS, B), bool)
    masks[-1, -3:] = False  # a padded last batch
    clean = y == yhn
    jd = JS.GraphData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yhn), jnp.asarray(clean),
                      JCSR.from_coo(ei, n))
    td = TS.GraphData(torch.from_numpy(x), torch.from_numpy(y).long(),
                      torch.from_numpy(yhn).long(), torch.from_numpy(clean),
                      CSRGraph.from_coo(ei, n))
    return dict(seeds=seeds, masks=masks, jd=jd, td=td, n=n)


def _h_specs(module="sageH"):
    kw = dict(in_size=F, hidden_size=16, out_size=C, num_layers=2, dropout=0.0)
    return ((jnets.NetSpec(module=module, **kw), jnets.NetSpec(module="sage", **kw)),
            (tnets.NetSpec(module=module, **kw), tnets.NetSpec(module="sage", **kw)))


def _joint_init():
    (js, jps), _ = _h_specs()
    return (jnets.init_params(jax.random.key(1), js), jnets.init_params(jax.random.key(2), js),
            jnets.init_params(jax.random.key(3), jps))


def test_pseudo_rewire_on_raw_features_matches(world):
    """The positive graph of the pseudo net's rewire of a step's raw
    features (``neg=False``): the same keep-mask and extra edges as the JAX
    package's, and as the port's own rewire with the negative graph."""
    seeds, masks = world["seeds"][0], world["masks"][0]

    @jax.jit
    def jax_side(data, seeds, masks):
        jt = j_sample(jax.random.key(0), data.csr, seeds, FANOUTS, masks)
        jx, _, _, jtopo = JS._flat_subgraph(data, jt)
        return jx, jrw.topk_rewire_tree(jx, jtopo, RATE)[0]

    jx, jpos = jax_side(world["jd"], jnp.asarray(seeds), jnp.asarray(masks))
    tt = t_sample(torch.Generator().manual_seed(0), world["td"].csr, torch.from_numpy(seeds),
                  FANOUTS, torch.from_numpy(masks))
    tx, _, _, ttopo = TS._flat_subgraph(world["td"], tt)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    pos, none = trw.topk_rewire_tree(tx, ttopo, RATE, neg=False)
    both, _ = trw.topk_rewire_tree(tx, ttopo, RATE)
    assert none is None
    for t in (pos, both):
        for a, b in ((t.edge_mask, jpos.edge_mask), (t.extra_src, jpos.extra_src),
                     (t.extra_dst, jpos.extra_dst), (t.extra_mask, jpos.extra_mask)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.slow
@pytest.mark.parametrize("use_pseudo", [False, True])
def test_h_step_loss_matches(world, use_pseudo):
    """One H step's loss and its terms from the same params and batch, at
    1e-5 relative."""
    (js, jps), (ts, tps) = _h_specs()
    joint = _joint_init()
    seeds, masks = world["seeds"][1], world["masks"][1]
    loss_of = JS._h_step_math(js, jps, FANOUTS, use_pseudo, 0.8, RATE)
    jl, (jct, _, _, jlp, jla) = jax.jit(loss_of)(
        joint, world["jd"], JS.Batch(jnp.asarray(seeds), jnp.asarray(masks)),
        jax.random.key(0), jnp.float32(0.25))
    tp = [params_from_jax(p) for p in _np(joint)]
    tl, (tct, _, _, tlp, tla) = TS.h_step_loss(
        ts, tps, *tp, world["td"], torch.from_numpy(seeds).long(), torch.from_numpy(masks),
        torch.Generator().manual_seed(0), 0.25, FANOUTS, use_pseudo=use_pseudo, beta=0.8,
        rewire_rate=RATE)
    for got, want in ((tl, jl), (tct.loss_1, jct.loss_1), (tct.loss_2, jct.loss_2),
                      (tlp, jlp), (tla, jla)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)
    assert (float(tla) > 0) == use_pseudo


def test_h_epoch_chain_matches(world):
    """A plain epoch (the pseudo net idle) then a pseudo epoch, 3 steps
    each, with the three nets' joint state carried across in both packages:
    each epoch's summed metrics within 1e-5 relative, the co-teaching nets'
    params within 1e-4 and the pseudo net's within 1e-5."""
    (js, jps), (ts, tps) = _h_specs()
    opt = optax.adam(LR)
    joint = _joint_init()
    init = _np(joint)

    def adam(params):
        return torch.optim.Adam(params, lr=LR)

    states = [TS.state_from_params(params_from_jax(p), adam) for p in init]
    js_ = JS.TrainState(joint, opt.init(joint))
    gen = torch.Generator().manual_seed(3)
    seeds, masks = world["seeds"], world["masks"]
    for use_pseudo in (False, True):
        epoch = JS.make_h_epoch(js, jps, opt, FANOUTS, use_pseudo=use_pseudo, rewire_rate=RATE)
        js_, jm = epoch(js_, world["jd"], jnp.asarray(seeds), jnp.asarray(masks),
                        jax.random.key(3), jnp.float32(0.25))
        tm = TS.h_epoch(ts, tps, *states, world["td"], torch.from_numpy(seeds).long(),
                        torch.from_numpy(masks), gen, 0.25, FANOUTS, use_pseudo=use_pseudo,
                        rewire_rate=RATE)
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} (use_pseudo {use_pseudo})")
        assert (float(tm["loss_pred"]) > 0) == use_pseudo
    for i, (s, want) in enumerate(zip(states, _np(js_.params))):
        got = params_to_jax(s.params)
        for jc, tc in zip(want["convs"], got["convs"]):
            for k in jc:
                np.testing.assert_allclose(tc[k], jc[k], rtol=0, atol=1e-5 if i == 2 else 1e-4,
                                           err_msg=f"net {i} {k}")
        if "act" in want:
            np.testing.assert_allclose(got["act"]["alpha"], want["act"]["alpha"], atol=1e-7)
    # the pseudo net trained in the pseudo epoch only
    assert not np.allclose(params_to_jax(states[2].params)["convs"][0]["w_root"],
                           init[2]["convs"][0]["w_root"])


def test_tree_topo_from_rewire_is_used_by_pseudo_apply(world):
    """The pseudo net's forward on the rewired graph is the JAX package's
    (the extras' mean aggregation included), at 2e-5."""
    (_, jps), (_, tps) = _h_specs()
    rng = np.random.default_rng(4)
    n_sub = B * 13
    x = rng.standard_normal((n_sub, F)).astype(np.float32)
    mask = rng.random(n_sub - B) < 0.8
    es, ed = rng.integers(0, n_sub, 20), rng.integers(0, n_sub, 20)
    em = rng.random(20) < 0.8
    from noise_gnn_tpu.ops import tree_agg as jtree

    jt = jtree.TreeTopo(B, FANOUTS, jnp.asarray(mask), jnp.asarray(es, jnp.int32),
                        jnp.asarray(ed, jnp.int32), jnp.asarray(em))
    tt = TreeTopo(B, FANOUTS, torch.from_numpy(mask), torch.from_numpy(es),
                  torch.from_numpy(ed), torch.from_numpy(em))
    p = jnets.init_params(jax.random.key(7), jps)
    want = jax.jit(lambda p, x: jnets.apply(jps, p, x, jt, num_nodes=n_sub)["logits"])(
        p, jnp.asarray(x))
    got = tnets.apply(tps, params_from_jax(_np(p)), torch.from_numpy(x), tt,
                      num_nodes=n_sub)["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
