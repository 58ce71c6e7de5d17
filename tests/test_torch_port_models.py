"""Sampler, layers, stacks and losses of the port against the JAX package.

Inputs are made with numpy from a seed and fed to both; params are copied
with ``params_from_jax``. Layers and stacks agree at atol 2e-5 in f32.
The sampler agrees exactly where no pick is random (every in-degree <=
fanout) and statistically otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_gnn_tpu.graph.containers import CSRGraph as JCSR
from noise_gnn_tpu.losses import coteaching as jct
from noise_gnn_tpu.models import layers as jL
from noise_gnn_tpu.models import nets as jnets
from noise_gnn_tpu.ops.sampler import sample_khop_tree as j_sample
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.losses import coteaching as tct
from noise_gnn_tpu_torch.models import layers as tL
from noise_gnn_tpu_torch.models import nets as tnets
from noise_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from noise_gnn_tpu_torch.ops.sampler import sample_khop_tree as t_sample

torch.set_num_threads(1)

ATOL = 2e-5


def low_degree_graph(n, max_deg, seed):
    """Each node gets 0..max_deg distinct in-neighbors."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for v in range(n):
        k = int(rng.integers(0, max_deg + 1))
        nb = rng.choice(np.delete(np.arange(n), v), size=k, replace=False)
        src.extend(nb.tolist())
        dst.extend([v] * k)
    return np.stack([np.asarray(src, np.int32), np.asarray(dst, np.int32)])


def np_params(params):
    return jax.tree.map(np.asarray, params)


# ------------------------------------------------------------------ sampler


@pytest.mark.parametrize("fanouts", [(3, 3), (4, 3, 5)])
def test_sampler_exact_where_deterministic(fanouts):
    n = 80
    ei = low_degree_graph(n, min(fanouts), seed=1)
    seeds = np.random.default_rng(2).integers(0, n, 16).astype(np.int32)
    mask = np.arange(16) < 13  # padded tail
    jt = j_sample(jax.random.key(0), JCSR.from_coo(ei, n), jnp.asarray(seeds), fanouts,
                  jnp.asarray(mask))
    tt = t_sample(torch.Generator().manual_seed(0), CSRGraph.from_coo(ei, n),
                  torch.from_numpy(seeds), fanouts, torch.from_numpy(mask))
    assert tt.fanouts == fanouts and tt.batch_size == 16
    for a, b in zip(jt.n_ids, tt.n_ids):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jt.masks, tt.masks):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_sampler_iid_picks_valid_and_uniform():
    # node 0 has in-neighbors {1, 2, 3}, fanout 2 < deg: i.i.d. picks
    ei = np.asarray([[1, 2, 3, 0], [0, 0, 0, 1]], np.int32)
    csr = CSRGraph.from_coo(ei, 4)
    gen = torch.Generator().manual_seed(5)
    tb = t_sample(gen, csr, torch.zeros(4000, dtype=torch.long), (2,))
    kids, m = tb.n_ids[1].numpy(), tb.masks[1].numpy()
    assert m.all() and set(np.unique(kids)) <= {1, 2, 3}
    freq = np.bincount(kids, minlength=4)[1:] / kids.size
    assert np.abs(freq - 1 / 3).max() < 0.03, freq
    # child-major order and a masked parent's children masked
    tb = t_sample(gen, csr, torch.tensor([0, 1, 2]), (2,), torch.tensor([True, True, False]))
    np.testing.assert_array_equal(tb.masks[1].numpy(), [1, 1, 1, 0, 0, 0])
    assert tb.n_ids[1][2] == 0  # node 1's only in-neighbor


# ------------------------------------------------------------ layers/stacks


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(3)
    n, f = 60, 12
    ei = rng.integers(0, n, (2, 400)).astype(np.int32)
    ei = ei[:, ei[0] != ei[1]]
    x = rng.standard_normal((n, f)).astype(np.float32)
    return n, f, ei, x


@pytest.mark.parametrize("module,aggr", [("sage", "mean"), ("sage", "max"), ("gcn", "mean")])
def test_conv_forms_match(small, module, aggr):
    n, f, ei, x = small
    key = jax.random.key(1)
    if module == "gcn":
        pj = jL.gcn_conv_init(key, f, 7)
    else:
        pj = jL.sage_conv_init(key, f, 7)
    pt = params_from_jax({"convs": [np_params(pj)]})["convs"][0]
    xt, et = torch.from_numpy(x), torch.from_numpy(ei)
    if module == "gcn":
        want = jL.gcn_conv(pj, jnp.asarray(x), jnp.asarray(ei), n)
        got = tL.gcn_conv(pt, xt, et, n)
    else:
        want = jL.sage_conv(pj, jnp.asarray(x), jnp.asarray(ei), n, aggr=aggr)
        got = tL.sage_conv(pt, xt, et, n, aggr=aggr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # tree and pre-aggregated forms
    rng = np.random.default_rng(4)
    xs, xn = rng.standard_normal((9, f)).astype(np.float32), rng.standard_normal((9, 4, f)).astype(np.float32)
    mk = rng.random((9, 4)) < 0.6
    if module == "gcn":
        want_t = jL.gcn_conv_tree(pj, jnp.asarray(xs), jnp.asarray(xn), jnp.asarray(mk))
        got_t = tL.gcn_conv_tree(pt, torch.from_numpy(xs), torch.from_numpy(xn), torch.from_numpy(mk))
        want_p = jL.gcn_conv_pre(pj, jnp.asarray(xs), jnp.asarray(xn[:, 0]))
        got_p = tL.gcn_conv_pre(pt, torch.from_numpy(xs), torch.from_numpy(xn[:, 0]))
    else:
        want_t = jL.sage_conv_tree(pj, jnp.asarray(xs), jnp.asarray(xn), jnp.asarray(mk), aggr)
        got_t = tL.sage_conv_tree(pt, torch.from_numpy(xs), torch.from_numpy(xn),
                                  torch.from_numpy(mk), aggr)
        want_p = jL.sage_conv_pre(pj, jnp.asarray(xs), jnp.asarray(xn[:, 0]))
        got_p = tL.sage_conv_pre(pt, torch.from_numpy(xs), torch.from_numpy(xn[:, 0]))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL)


def _spec_pair(module, f, c, layers=2, dtype="float32"):
    kw = dict(module=module, in_size=f, hidden_size=16, out_size=c,
              num_layers=layers, dropout=0.5, compute_dtype=dtype)
    return jnets.NetSpec(**kw), tnets.NetSpec(**kw)


@pytest.mark.parametrize("module", ["sage", "gcn"])
def test_stack_edge_list_matches(small, module):
    n, f, ei, x = small
    if module == "gcn":
        x = x * 0.05  # neighbor SUMs over 3 layers: keep logits O(1) for atol
    js, ts = _spec_pair(module, f, 5, layers=3)
    pj = jnets.init_params(jax.random.key(2), js)
    pt = params_from_jax(np_params(pj))
    want = jnets.apply(js, pj, jnp.asarray(x), jnp.asarray(ei))["logits"]
    got = tnets.apply(ts, pt, torch.from_numpy(x), torch.from_numpy(ei))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    back = params_to_jax(pt)
    for a, b in zip(jax.tree.leaves(np_params(pj)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("module,exact", [("sage", False), ("sage", True), ("gcn", True)])
def test_stack_tree_matches(module, exact):
    rng = np.random.default_rng(6)
    f, c, b, fan = 10, 4, 6, (3, 2)
    js, ts = _spec_pair(module, f, c)
    pj = jnets.init_params(jax.random.key(3), js)
    pt = params_from_jax(np_params(pj))
    sizes = [b, b * fan[0], b * fan[0] * fan[1]]
    depth = 2 if exact else 3
    xs = [rng.standard_normal((s, f)).astype(np.float32) for s in sizes[:depth]]
    ms = [np.ones(b, bool)] + [rng.random(s) < 0.7 for s in sizes[1:depth]]
    la = rng.standard_normal((sizes[1], f)).astype(np.float32) if exact else None
    want = jnets.apply_tree(js, pj, [jnp.asarray(v) for v in xs],
                            [jnp.asarray(v) for v in ms], fan,
                            leaf_agg=None if la is None else jnp.asarray(la))["logits"]
    got = tnets.apply_tree(ts, pt, [torch.from_numpy(v) for v in xs],
                           [torch.from_numpy(v) for v in ms], fan,
                           leaf_agg=None if la is None else torch.from_numpy(la))["logits"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("module", ["sageH", "sageFC", "gcn_head"])
def test_slice4_modules_match(small, module):
    """sageH (logits and the last hidden), sageFC (logits and the batch
    normed projection) and gcn_head (the first conv alone), edge-list and
    tree forwards, at atol 2e-5; a random batch-norm scale and bias and a
    PReLU alpha come along through ``params_from_jax``."""
    n, f, ei, x = small
    js, ts = _spec_pair(module, f, 5, layers=3)
    pj = jnets.init_params(jax.random.key(5), js)
    if module == "sageFC":
        pj["bnl"] = {"scale": jnp.linspace(0.5, 1.5, js.proj_size),
                     "bias": jnp.linspace(-0.2, 0.2, js.proj_size)}
    pt = params_from_jax(np_params(pj))
    assert sorted(pt) == sorted(pj)
    rng = np.random.default_rng(9)
    b, fan = 6, (3, 2)
    sizes = [b, b * fan[0], b * fan[0] * fan[1], b * fan[0] * fan[1] * 2]
    xs = [rng.standard_normal((sz, f)).astype(np.float32) for sz in sizes]
    ms = [np.ones(b, bool)] + [rng.random(sz) < 0.7 for sz in sizes[1:]]
    fan3 = fan + (2,)

    @jax.jit
    def jax_side(pj, x, ei, xs, ms):
        return (jnets.apply(js, pj, x, ei), jnets.apply_tree(js, pj, xs, ms, fan3))

    want_e, want_t = jax_side(pj, jnp.asarray(x), jnp.asarray(ei), [jnp.asarray(v) for v in xs],
                              [jnp.asarray(v) for v in ms])
    got_e = tnets.apply(ts, pt, torch.from_numpy(x), torch.from_numpy(ei))
    got_t = tnets.apply_tree(ts, pt, [torch.from_numpy(v) for v in xs],
                             [torch.from_numpy(v) for v in ms], fan3)
    for want, got in ((want_e, got_e), (want_t, got_t)):
        assert set(got) == set(want) == ({"logits"} if module == "gcn_head" else {"logits", "h"})
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)


def test_batch_norm_and_prelu_match():
    """Batch statistics with the population variance (eps 1e-5), and PReLU
    at its 0.25 init and another alpha, at atol 1e-6."""
    rng = np.random.default_rng(10)
    x = (3 * rng.standard_normal((9, 5)) + 1).astype(np.float32)
    pj = {"scale": jnp.asarray(rng.random(5) + 0.5, jnp.float32),
          "bias": jnp.asarray(rng.standard_normal(5), jnp.float32)}
    init = tL.batch_norm_init(5)
    assert np.array_equal(init["scale"].numpy(), np.asarray(jL.batch_norm_init(5)["scale"]))
    assert np.array_equal(init["bias"].numpy(), np.asarray(jL.batch_norm_init(5)["bias"]))
    got = tL.batch_norm({k: torch.from_numpy(np.array(v)) for k, v in pj.items()},
                        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jL.batch_norm(pj, jnp.asarray(x))),
                               atol=1e-6)
    assert float(tL.prelu_init()["alpha"]) == float(jL.prelu_init()["alpha"]) == 0.25
    for alpha in (0.25, -1.5):
        got = tL.prelu({"alpha": torch.tensor(alpha)}, torch.from_numpy(x))
        want = jL.prelu({"alpha": jnp.float32(alpha)}, jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("module", ["sage", "gcn", "sagePL", "sageH", "sageFC", "gcn_head",
                                    "gat"])
def test_params_round_trip(module):
    """``params_from_jax`` then ``params_to_jax`` gives the JAX params back
    exactly, ``proj``, ``bnl``, ``act`` and GAT's ``layers`` included;
    ``nets.parameters`` lists every leaf once; an entry the port does not
    carry raises."""
    kw = dict(module=module, in_size=6, hidden_size=8, out_size=3, nbr_nodes=7)
    pj = np_params(jnets.init_params(jax.random.key(6), jnets.NetSpec(**kw)))
    pt = params_from_jax(pj)
    back = params_to_jax(pt)
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(pj), jax.tree.leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b)
    own = tnets.init_params(torch.Generator().manual_seed(0), tnets.NetSpec(**kw))
    assert jax.tree.structure(params_to_jax(own)) == jax.tree.structure(pj)
    assert len(tnets.parameters(pt)) == len(jax.tree.leaves(pj))
    with pytest.raises(ValueError, match="not carried"):
        params_from_jax({**pj, "head": {"scale": np.ones(6), "bias": np.zeros(6)}})
    layers = "layers" if module == "gat" else "convs"
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({**pj, layers: [{**pj[layers][0], "extra": np.ones(2)}]})


def test_bf16_compute_returns_f32_logits(small):
    n, f, ei, x = small
    js, ts = _spec_pair("sage", f, 5, dtype="bfloat16")
    pt = params_from_jax(np_params(jnets.init_params(jax.random.key(4), js)))
    out = tnets.apply(ts, pt, torch.from_numpy(x), torch.from_numpy(ei))["logits"]
    ref = tnets.apply(tnets.NetSpec(**{**ts.__dict__, "compute_dtype": "float32"}), pt,
                      torch.from_numpy(x), torch.from_numpy(ei))["logits"]
    assert out.dtype == torch.float32 and pt["convs"][0]["w_root"].dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=0.1)


def test_linear_and_make_network_match():
    rng = np.random.default_rng(8)
    pj = jL.linear_init(jax.random.key(5), 6, 3)
    pt = {k: torch.from_numpy(np.asarray(v)) for k, v in pj.items()}
    x = rng.standard_normal((4, 6)).astype(np.float32)
    np.testing.assert_allclose(tL.linear(pt, torch.from_numpy(x)).numpy(),
                               np.asarray(jL.linear(pj, jnp.asarray(x))), atol=1e-6)
    cfg = {"module": "gcn", "hidden_size": 32, "num_layers": 3, "dropout": 0.1,
           "compute_dtype": "bfloat16", "aggr": "max"}
    js, ts = jnets.make_network(cfg, 7, 5), tnets.make_network(cfg, 7, 5)
    assert ts.layer_sizes() == js.layer_sizes() == [(7, 32), (32, 32), (32, 5)]
    for field in ("module", "hidden_size", "num_layers", "dropout", "compute_dtype", "aggr"):
        assert getattr(ts, field) == getattr(js, field)
    js, ts = jnets.make_network({**cfg, "module": "gat"}, 7, 5), tnets.make_network(
        {**cfg, "module": "gat"}, 7, 5)
    assert ts.module == js.module == "gat" and ts.layer_sizes() == js.layer_sizes()
    with pytest.raises(ValueError, match="unknown module"):
        tnets.make_network({**cfg, "module": "gin"}, 7, 5)


def test_dropout_semantics():
    x = torch.ones(20000)
    out = tL.dropout(torch.Generator().manual_seed(0), x, 0.25, True)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    np.testing.assert_allclose(out[kept].numpy(), 1 / 0.75, rtol=1e-6)
    assert tL.dropout(torch.Generator(), x, 0.25, False) is x


# ------------------------------------------------------------------ losses


def _loss_inputs(b=32, c=5, seed=7, ties=True):
    rng = np.random.default_rng(seed)
    l1 = rng.standard_normal((b, c)).astype(np.float32)
    l2 = rng.standard_normal((b, c)).astype(np.float32)
    if ties:  # duplicated rows give exactly tied losses
        l1[1::4], l2[1::4] = l1[0::4], l2[0::4]
    y = rng.integers(0, c, b).astype(np.int32)
    if ties:
        y[1::4] = y[0::4]
    clean = rng.random(b) < 0.7
    mask = np.arange(b) < b - 5  # padded rows, all tied at `big`
    return l1, l2, y, clean, mask


@pytest.mark.parametrize("fn", ["ct", "codi"])
@pytest.mark.parametrize("padded", [False, True])
def test_ct_losses_match_with_ties(fn, padded):
    l1, l2, y, clean, mask = _loss_inputs()
    jm, tm = (jnp.asarray(mask), torch.from_numpy(mask)) if padded else (None, None)
    ja = [jnp.asarray(v) for v in (l1, l2, y)]
    ta = [torch.from_numpy(v) for v in (l1, l2, y)]
    for fr in (0.0, 0.3, 0.55):
        if fn == "ct":
            jo = jct.ct_loss(*ja, jnp.float32(fr), jnp.asarray(clean), jm)
            to = tct.ct_loss(*ta, fr, torch.from_numpy(clean), tm)
        else:
            jo = jct.codi_loss(*ja, jnp.float32(fr), jnp.asarray(clean), 0.1, jm)
            to = tct.codi_loss(*ta, fr, torch.from_numpy(clean), 0.1, tm)
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_rank_and_selection_stable():
    v = np.asarray([2.0, 1.0, 2.0, 1.0, 0.5, 2.0], np.float32)
    jk, jn, jr = jct.small_loss_selection(jnp.asarray(v), jnp.float32(0.5))
    tk, tn, tr = tct.small_loss_selection(torch.from_numpy(v), 0.5)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert float(tn) == float(jn)


@pytest.mark.parametrize("padded", [False, True])
def test_backward_correction_and_ce_match(padded):
    l1, _, y, _, mask = _loss_inputs(ties=False)
    mat = np.full((5, 5), 0.05) + np.eye(5) * 0.75
    jm, tm = (jnp.asarray(mask), torch.from_numpy(mask)) if padded else (None, None)
    want = jct.backward_correction(jnp.asarray(l1), jnp.asarray(y), jnp.asarray(mat), jm)
    got = tct.backward_correction(torch.from_numpy(l1), torch.from_numpy(y),
                                  torch.from_numpy(mat), tm)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        tct.cross_entropy(torch.from_numpy(l1), torch.from_numpy(y)).numpy(),
        np.asarray(jct.cross_entropy(jnp.asarray(l1), jnp.asarray(y))), atol=1e-6)


def test_ct_loss_gradient_flows_to_own_net_only():
    l1, l2, y, clean, mask = _loss_inputs()
    a = torch.from_numpy(l1).requires_grad_()
    b = torch.from_numpy(l2).requires_grad_()
    out = tct.ct_loss(a, b, torch.from_numpy(y), 0.3, torch.from_numpy(clean),
                      torch.from_numpy(mask))
    (ga,) = torch.autograd.grad(out.loss_1, a, retain_graph=True)
    assert torch.autograd.grad(out.loss_1, b, allow_unused=True)[0] is None
    gj = jax.grad(lambda v: jct.ct_loss(v, jnp.asarray(l2), jnp.asarray(y), 0.3,
                                        jnp.asarray(clean), jnp.asarray(mask)).loss_1)(
        jnp.asarray(l1))
    np.testing.assert_allclose(ga.numpy(), np.asarray(gj), atol=1e-6)
