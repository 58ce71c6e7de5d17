"""The slice as a whole at the math level: the port's co-teaching and
baseline epochs against the JAX package's, step for step.

The graph's in-degrees are all <= the fanouts, so every sampled tree is
deterministic; dropout is 0 and both packages start from the same params
(``params_from_jax``). After 3 steps the summed metrics and the params
agree at atol 1e-4 (Adam's m/sqrt(v) turns last-bit gradient differences
into ~lr-sized steps), and the fused pair eval of the trained nets agrees
at atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noise_gnn_tpu.eval.inference import FullGraphInference as JInfer
from noise_gnn_tpu.graph.containers import CSRGraph as JCSR
from noise_gnn_tpu.models import nets as jnets
from noise_gnn_tpu.ops.leaf_agg import fused_leaf_table as j_fused
from noise_gnn_tpu.train import steps as JS
from noise_gnn_tpu_torch.eval.inference import FullGraphInference as TInfer
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.models import nets as tnets
from noise_gnn_tpu_torch.models.convert import params_from_jax
from noise_gnn_tpu_torch.ops.leaf_agg import fused_leaf_table as t_fused
from noise_gnn_tpu_torch.train import steps as TS

torch.set_num_threads(1)

LR = 1e-3
FANOUTS = (3, 3)
N, F, C, B, STEPS = 90, 10, 4, 16, 3


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
    return dict(ei=ei, x=x, y=y, yhn=yhn, seeds=seeds, masks=masks)


def _datas(w, exact, aggr):
    jcsr, tcsr = JCSR.from_coo(w["ei"], N), CSRGraph.from_coo(w["ei"], N)
    jx, tx = jnp.asarray(w["x"]), torch.from_numpy(w["x"])
    jl = j_fused(jx, jcsr, aggr=aggr, backend="xla") if exact else None
    tl = t_fused(tx, tcsr, aggr=aggr) if exact else None
    clean = w["y"] == w["yhn"]
    jd = JS.GraphData(jx, jnp.asarray(w["y"]), jnp.asarray(w["yhn"]),
                      jnp.asarray(clean), jcsr, jl)
    td = TS.GraphData(tx, torch.from_numpy(w["y"]).long(), torch.from_numpy(w["yhn"]).long(),
                      torch.from_numpy(clean), tcsr, tl)
    return jd, td


def _specs(module):
    kw = dict(module=module, in_size=F, hidden_size=16, out_size=C, num_layers=2,
              dropout=0.0)
    return jnets.NetSpec(**kw), tnets.NetSpec(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


def _assert_params(jparams, tparams, atol=1e-4):
    for jc, tc in zip(jparams["convs"], tparams["convs"]):
        assert set(jc) == set(tc)
        for k in jc:
            np.testing.assert_allclose(tc[k].detach().numpy(), np.asarray(jc[k]),
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("module,exact,algo", [
    ("sage", True, "coteaching"), ("sage", False, "codi"), ("gcn", True, "coteaching"),
])
def test_ct_epoch_matches(world, module, exact, algo):
    js, ts = _specs(module)
    aggr = "sum" if module == "gcn" else "mean"
    jd, td = _datas(world, exact, aggr)
    opt = optax.adam(LR)
    p1 = jnets.init_params(jax.random.key(1), js)
    p2 = jnets.init_params(jax.random.key(2), js)
    s1 = TS.state_from_params(params_from_jax(_np(p1)), _adam)
    s2 = TS.state_from_params(params_from_jax(_np(p2)), _adam)
    epoch = jax.jit(JS.ct_epoch_fn(js, opt, FANOUTS, algo, 0.1, exact))
    j1, j2, jm = epoch(JS.TrainState(p1, opt.init(p1)), JS.TrainState(p2, opt.init(p2)),
                       jd, jnp.asarray(world["seeds"]), jnp.asarray(world["masks"]),
                       jax.random.key(3), jnp.float32(0.25))
    tm = TS.ct_epoch(ts, s1, s2, td, torch.from_numpy(world["seeds"]).long(),
                     torch.from_numpy(world["masks"]), torch.Generator().manual_seed(3),
                     0.25, FANOUTS, algo=algo, co_lambda=0.1, exact_leaf=exact)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4, err_msg=k)
    _assert_params(j1.params, s1.params)
    _assert_params(j2.params, s2.params)

    # fused pair eval of the trained nets (JAX params copied over)
    jcsr = jd.csr
    x_agg_j = j_fused(jd.x, jcsr, aggr=aggr, backend="xla")[:, F:]
    x_agg_t = t_fused(td.x, td.csr, aggr=aggr)[:, F:]
    for x_agg_jj, x_agg_tt in ((None, None), (x_agg_j, x_agg_t)):
        jinf = JInfer(js, None, N, backend="xla", csr=jcsr,
                      indptr_np=np.asarray(jcsr.indptr), x_agg=x_agg_jj)
        tinf = TInfer(ts, td.csr, x_agg=x_agg_tt)
        q1, q2 = params_from_jax(_np(j1.params)), params_from_jax(_np(j2.params))
        jl1, jl2 = jinf.pair(j1.params, j2.params, jd.x)
        tl1, tl2 = tinf.pair(q1, q2, td.x)
        np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=2e-5)
        np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=2e-5)
        np.testing.assert_allclose(tinf(q1, td.x).numpy(), np.asarray(jinf(j1.params, jd.x)),
                                   atol=2e-5)


@pytest.mark.parametrize("compare_loss,exact", [("normal", True), ("back", False)])
def test_baseline_epoch_matches(world, compare_loss, exact):
    js, ts = _specs("sage")
    jd, td = _datas(world, exact, "mean")
    opt = optax.adam(LR)
    p = jnets.init_params(jax.random.key(4), js)
    s = TS.state_from_params(params_from_jax(_np(p)), _adam)
    mat = np.full((C, C), 0.1) + np.eye(C) * 0.6
    epoch = JS.make_baseline_epoch(js, opt, FANOUTS, compare_loss=compare_loss,
                                   exact_leaf=exact)
    js_state = JS.TrainState(jax.tree.map(jnp.copy, p), opt.init(p))
    jn, jm = epoch(js_state, jd, jnp.asarray(world["seeds"]), jnp.asarray(world["masks"]),
                   jax.random.key(5), jnp.asarray(mat, jnp.float32))
    tm = TS.baseline_epoch(ts, s, td, torch.from_numpy(world["seeds"]).long(),
                           torch.from_numpy(world["masks"]), torch.Generator().manual_seed(5),
                           torch.from_numpy(mat).float(), FANOUTS,
                           compare_loss=compare_loss, exact_leaf=exact)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-4, err_msg=k)
    _assert_params(jn.params, s.params)


@pytest.mark.parametrize("module,aggr", [("sage", "mean"), ("sage", "max"), ("gcn", "mean")])
def test_full_graph_inference_matches(world, module, aggr):
    """Single and pair full-graph eval, with and without the x_agg table,
    for every aggregation the eval supports (max runs scatter_reduce)."""
    kw = dict(module=module, in_size=F, hidden_size=16, out_size=C, num_layers=3,
              dropout=0.0, aggr=aggr)
    js, ts = jnets.NetSpec(**kw), tnets.NetSpec(**kw)
    kind = "sum" if module == "gcn" else aggr
    jd, td = _datas(world, False, kind)
    scale = 0.2 if module == "gcn" else 1.0  # keep 3 layers of sums O(1)
    jx, tx = jd.x * scale, td.x * scale
    p1 = jnets.init_params(jax.random.key(6), js)
    p2 = jnets.init_params(jax.random.key(7), js)
    q1, q2 = params_from_jax(_np(p1)), params_from_jax(_np(p2))
    for use_table in (False, True):
        xa_j = j_fused(jx, jd.csr, aggr=kind, backend="xla")[:, F:] if use_table else None
        xa_t = t_fused(tx, td.csr, aggr=kind)[:, F:] if use_table else None
        jinf = JInfer(js, None, N, backend="xla", csr=jd.csr,
                      indptr_np=np.asarray(jd.csr.indptr), x_agg=xa_j)
        tinf = TInfer(ts, td.csr, x_agg=xa_t)
        np.testing.assert_allclose(tinf(q1, tx).numpy(), np.asarray(jinf(p1, jx)), atol=2e-5)
        for a, b in zip(tinf.pair(q1, q2, tx), jinf.pair(p1, p2, jx)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
