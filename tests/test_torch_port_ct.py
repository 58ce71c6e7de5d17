"""PipelineCT's slice against the JAX package on the CPU: the edge
augmentation (bit for bit, the host rng's state after it included), the
finetune step and epoch on given views, and the warmup's small-loss split.

The finetune runs sageFC trees on four views, each its own (x, csr), whose
graphs have every in-degree <= the fanouts, so every sampled tree is
deterministic; dropout is 0 and both packages start from the same params
(``params_from_jax``). The split runs each package's ``PipelineCT`` on the
same synthetic graph and labels with the same two nets' params: the JAX
package takes their logits from the edge-list forward, the port from the
SpMM pair inference (the same function, see ``PipelineCT._split``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noise_gnn_tpu.augment import edges as jedges
from noise_gnn_tpu.graph.containers import CSRGraph as JCSR
from noise_gnn_tpu.models import nets as jnets
from noise_gnn_tpu.train import pipelines as JP
from noise_gnn_tpu.train import steps as JS
from noise_gnn_tpu.utils.config import DEFAULTS as JDEFAULTS
from noise_gnn_tpu_torch.augment import edges as tedges
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.models import nets as tnets
from noise_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from noise_gnn_tpu_torch.train import pipelines as TP
from noise_gnn_tpu_torch.train import steps as TS
from noise_gnn_tpu_torch.utils.config import DEFAULTS as TDEFAULTS

torch.set_num_threads(1)

LR = 1e-3
FANOUTS = (3, 2)
N, F, C, B, STEPS = 120, 10, 5, 16, 3
VIEWS = ("orig", "edge_s", "feat_s", "large")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def low_degree_graph(rng, n, max_deg):
    src, dst = [], []
    for v in range(n):
        k = int(rng.integers(0, max_deg + 1))
        src += rng.choice(np.delete(np.arange(n), v), size=k, replace=False).tolist()
        dst += [v] * k
    return np.stack([np.asarray(src, np.int32), np.asarray(dst, np.int32)])


@pytest.mark.parametrize("prob", [0.1, 0.3])
def test_augment_edges_match_jax(prob):
    """``augment_edges_pos`` (and ``_neg``) give the JAX copy's edge lists
    bit for bit from the same seed, and leave the rng in the same state."""
    rng = np.random.default_rng(0)
    ei = low_degree_graph(rng, 300, 4)
    ei = np.concatenate([ei, ei[::-1], ei[:, :5][[0, 0]]], axis=1)  # both ways, self-loops
    for fn in ("augment_edges_pos", "augment_edges_neg"):
        ra, rb = np.random.default_rng(7), np.random.default_rng(7)
        args = (ei, 300, prob) if fn == "augment_edges_pos" else (ei, 300)
        want = getattr(jedges, fn)(*args, rng=ra)
        got = getattr(tedges, fn)(*args, rng=rb)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert rb.bit_generator.state == ra.bit_generator.state


@pytest.fixture(scope="module")
def world():
    """A graph and three more (the views' edge sets), all of in-degree <=
    the fanouts; features, labels and the clean and noisy seed batches."""
    rng = np.random.default_rng(1)
    graphs = [low_degree_graph(rng, N, min(FANOUTS)) for _ in range(3)]
    x = rng.standard_normal((N, F)).astype(np.float32)
    feats = {"orig": x, "edge_s": x, "feat_s": x[:, rng.permutation(F)],
             "large": x[rng.permutation(N)]}
    gi = {"orig": 0, "edge_s": 1, "feat_s": 0, "large": 2}
    y = rng.integers(0, C, N).astype(np.int32)
    yhn = np.where(rng.random(N) < 0.3, (y + 1) % C, y).astype(np.int32)
    perm = rng.permutation(N)
    cs = perm[:STEPS * B].reshape(STEPS, B).astype(np.int32)
    ns = perm[-STEPS * B:].reshape(STEPS, B).astype(np.int32)
    cm = np.ones((STEPS, B), bool)
    nm = np.ones((STEPS, B), bool)
    cm[-1, -4:] = nm[-1, -6:] = False  # padded last batches
    clean = y == yhn
    jd = JS.GraphData(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yhn), jnp.asarray(clean),
                      JCSR.from_coo(graphs[0], N))
    td = TS.GraphData(torch.from_numpy(x), torch.from_numpy(y).long(),
                      torch.from_numpy(yhn).long(), torch.from_numpy(clean),
                      CSRGraph.from_coo(graphs[0], N))
    jv = {v: (jnp.asarray(feats[v]), JCSR.from_coo(graphs[gi[v]], N)) for v in VIEWS}
    tv = {v: (torch.from_numpy(feats[v]), CSRGraph.from_coo(graphs[gi[v]], N)) for v in VIEWS}
    return dict(jd=jd, td=td, jv=jv, tv=tv, cs=cs, cm=cm, ns=ns, nm=nm)


def _fc_specs():
    kw = dict(module="sageFC", in_size=F, hidden_size=16, out_size=C, num_layers=2,
              dropout=0.0)
    return jnets.NetSpec(**kw), tnets.NetSpec(**kw)


@pytest.mark.slow
def test_contrast_step_loss_matches(world):
    """One finetune step's loss, CE and contrastive terms from the same
    params and batches, at 1e-5 relative."""
    js, ts = _fc_specs()
    p = jnets.init_params(jax.random.key(1), js)
    w = world
    jl, (jls, jlc, _) = jax.jit(JS._contrast_step_math(js, FANOUTS, 0.7))(
        p, w["jd"], w["jv"], JS.Batch(jnp.asarray(w["cs"][0]), jnp.asarray(w["cm"][0])),
        JS.Batch(jnp.asarray(w["ns"][0]), jnp.asarray(w["nm"][0])), jax.random.key(0))
    tl, (tls, tlc, _) = TS.contrast_step_loss(
        ts, params_from_jax(_np(p)), w["td"], w["tv"], torch.from_numpy(w["cs"][0]).long(),
        torch.from_numpy(w["cm"][0]), torch.from_numpy(w["ns"][0]).long(),
        torch.from_numpy(w["nm"][0]), torch.Generator().manual_seed(0), FANOUTS, 0.7)
    for got, want in ((tl, jl), (tls, jls), (tlc, jlc)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_contrast_epoch_matches(world):
    """3 finetune steps: summed metrics within 1e-5 relative, params (the
    projection head and its batch norm included; ``act`` never reached, so
    unchanged under Adam) within 1e-4. Except the projection's bias: the
    batch norm right after it subtracts the batch mean, so its gradient is
    0 in exact arithmetic and rounding noise in each package, which Adam's
    m / sqrt(v) turns into steps of up to lr of either sign; it is held to
    that bound from its initial value instead."""
    js, ts = _fc_specs()
    opt = optax.adam(LR)
    p = jnets.init_params(jax.random.key(2), js)
    init = _np(p)
    s = TS.state_from_params(params_from_jax(init), lambda q: torch.optim.Adam(q, lr=LR))
    w = world
    epoch = JS.make_contrast_train_epoch(js, opt, FANOUTS, lam=0.7)
    js_, jm = epoch(JS.TrainState(p, opt.init(p)), w["jd"], w["jv"], jnp.asarray(w["cs"]),
                    jnp.asarray(w["cm"]), jnp.asarray(w["ns"]), jnp.asarray(w["nm"]),
                    jax.random.key(3))
    tm = TS.contrast_epoch(ts, s, w["td"], w["tv"], torch.from_numpy(w["cs"]).long(),
                           torch.from_numpy(w["cm"]), torch.from_numpy(w["ns"]).long(),
                           torch.from_numpy(w["nm"]), torch.Generator().manual_seed(3),
                           FANOUTS, 0.7)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want, got = _np(js_.params), params_to_jax(s.params)
    for jc, tc in zip(want["convs"], got["convs"]):
        for k in jc:
            np.testing.assert_allclose(tc[k], jc[k], atol=1e-4, err_msg=k)
    for name, k in (("proj", "w"), ("bnl", "scale"), ("bnl", "bias"), ("act", "alpha")):
        np.testing.assert_allclose(got[name][k], want[name][k], atol=1e-4, err_msg=f"{name}.{k}")
    for b in (got["proj"]["b"], want["proj"]["b"]):
        assert np.abs(b - init["proj"]["b"]).max() <= STEPS * LR * 1.001
    assert got["act"]["alpha"] == init["act"]["alpha"]
    assert not np.allclose(got["proj"]["w"], init["proj"]["w"])


def test_split_matches_jax(tmp_path):
    """``PipelineCT._split`` of the same two nets on the same synthetic
    graph and labels: the port's clean and noisy ids are the JAX package's."""
    over = dict(dataset_name="cora", synthetic_scale=16, algo_type="contrastive",
                module="sageFC", train_type="nalgo", hidden_size=16, num_layers=2,
                nbr_neighbors=[3, 2], num_runs=1, max_epochs=4, warmup=2, ct_tk=1,
                batch_size=64, seed=5, epoch_logger=False, data_parallel=False)
    jp = JP.PipelineCT(dict(copy.deepcopy(JDEFAULTS), **over, out_dir=str(tmp_path / "j")))
    tp = TP.PipelineCT(dict(copy.deepcopy(TDEFAULTS), **over, out_dir=str(tmp_path / "t"),
                            device="cpu"))
    np.testing.assert_array_equal(tp.graph.yhn, jp.graph.yhn)
    js, ts = jp.spec_for(), tp.spec_for()
    p1, p2 = (jnets.init_params(jax.random.key(k), js) for k in (4, 5))
    jc, jn = jp._split(js, p1, p2, 1)
    tc, tn = tp._split(ts, params_from_jax(_np(p1)), params_from_jax(_np(p2)), 1)
    assert 0 < tc.size < tp.split_idx["train"].size and tn.size > 0
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tn, jn)
