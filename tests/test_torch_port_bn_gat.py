"""Batch norm in the SAGE/GCN stacks, the GAT model family, SIMA and
``ct_loss2`` of the port against the JAX package.

Inputs are made with numpy from a seed and fed to both; params are copied
with ``params_from_jax``. The stacks under ``use_bn`` agree at atol 1e-5 in
f32 and at the port's bf16 tolerance (0.1, as the bf16 stack test of
``test_torch_port_models.py``) in bf16, with masked tree rows and a padded
seed present: both packages take each depth array's statistics over all
its rows. The epochs run on a graph whose in-degrees are all <= the
fanouts, with dropout 0, so every sampled tree is deterministic. GAT's
masked adjacency agrees where the JAX package's is defined (node 0 has no
genuine self-loop); the self-loop case is shown as it stands."""

import copy
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noise_gnn_tpu.eval.inference import FullGraphInference as JInfer
from noise_gnn_tpu.graph.containers import CSRGraph as JCSR
from noise_gnn_tpu.losses import coteaching as jct
from noise_gnn_tpu.models import layers as jL
from noise_gnn_tpu.models import nets as jnets
from noise_gnn_tpu.train import steps as JS
from noise_gnn_tpu_torch.eval.inference import FullGraphInference as TInfer
from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.losses import coteaching as tct
from noise_gnn_tpu_torch.main import main as tmain
from noise_gnn_tpu_torch.models import layers as tL
from noise_gnn_tpu_torch.models import nets as tnets
from noise_gnn_tpu_torch.models.convert import params_from_jax, params_to_jax
from noise_gnn_tpu_torch.train import steps as TS
from noise_gnn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from noise_gnn_tpu_torch.utils.config import DEFAULTS as TDEFAULTS

torch.set_num_threads(1)

ATOL, BF16_ATOL, LR = 1e-5, 0.1, 1e-3
N, F, C = 60, 12, 5
FANOUTS, B, STEPS = (3, 2), 16, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(ts, seed, perturb=True):
    """(JAX params, the port's copy): the port's init from ``seed`` as
    numpy, every leaf moved off its init (BN's unit scales and zero biases
    included) so that each changes the output. Made without jax.random, so
    no eager JAX op is compiled for it."""
    pnp = params_to_jax(tnets.init_params(torch.Generator().manual_seed(seed), ts))
    if perturb:
        rng = np.random.default_rng(seed)
        pnp = jax.tree.map(lambda v: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32),
                           pnp)
    return jax.tree.map(jnp.asarray, pnp), params_from_jax(pnp)


def _spec_pair(**kw):
    kw = dict(dict(in_size=F, hidden_size=16, out_size=C, num_layers=3, dropout=0.0), **kw)
    return jnets.NetSpec(**kw), tnets.NetSpec(**kw)


@pytest.fixture(scope="module")
def world():
    """A graph with in-degrees <= min(FANOUTS) and no self-loops, labels,
    and STEPS seed batches, the last padded."""
    rng = np.random.default_rng(0)
    src, dst = [], []
    for v in range(N):
        k = int(rng.integers(0, min(FANOUTS) + 1))
        nb = rng.choice(np.delete(np.arange(N), v), size=k, replace=False)
        src += nb.tolist()
        dst += [v] * k
    ei = np.stack([np.asarray(src, np.int32), np.asarray(dst, np.int32)])
    x = rng.standard_normal((N, F)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    yhn = np.where(rng.random(N) < 0.3, (y + 1) % C, y).astype(np.int32)
    seeds = np.concatenate([rng.permutation(N)[:STEPS * B - 3], np.zeros(3, np.int64)])
    masks = (np.arange(STEPS * B) < STEPS * B - 3).reshape(STEPS, B)
    return dict(ei=ei, x=x, y=y, yhn=yhn, seeds=seeds.reshape(STEPS, B).astype(np.int32),
                masks=masks)


def _datas(w):
    clean = w["y"] == w["yhn"]
    jd = JS.GraphData(jnp.asarray(w["x"]), jnp.asarray(w["y"]), jnp.asarray(w["yhn"]),
                      jnp.asarray(clean), JCSR.from_coo(w["ei"], N), None)
    td = TS.GraphData(torch.from_numpy(w["x"]), torch.from_numpy(w["y"]).long(),
                      torch.from_numpy(w["yhn"]).long(), torch.from_numpy(clean),
                      CSRGraph.from_coo(w["ei"], N))
    return jd, td


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


def _assert_tree(jtree, ttree, atol):
    for a, b in zip(jax.tree.leaves(_np(jtree)), jax.tree.leaves(params_to_jax(ttree))):
        np.testing.assert_allclose(b, a, atol=atol)


# ------------------------------------------------------------ batch norm


@pytest.mark.parametrize("module,dtype", [
    ("sage", "float32"), pytest.param("gcn", "float32", marks=pytest.mark.slow),
    pytest.param("sage", "bfloat16", marks=pytest.mark.slow),
    pytest.param("gcn", "bfloat16", marks=pytest.mark.slow)])
def test_bn_apply_and_tree_match(world, module, dtype):
    """Edge-list forward (with masked edges) and tree forward (with masked
    rows at every depth and a padded seed) under ``use_bn``."""
    js, ts = _spec_pair(module=module, use_bn=True, compute_dtype=dtype, num_layers=2)
    pj, pt = _params(ts, 1)
    assert set(pt) == {"convs", "bn1", "bn2"}
    atol = ATOL if dtype == "float32" else BF16_ATOL
    rng = np.random.default_rng(3)
    x, ei = world["x"], world["ei"]
    em = rng.random(ei.shape[1]) < 0.8
    want = jax.jit(lambda p, x, ei, m: jnets.apply(js, p, x, ei, edge_mask=m))(
        pj, jnp.asarray(x), jnp.asarray(ei), jnp.asarray(em))
    got = tnets.apply(ts, pt, torch.from_numpy(x), torch.from_numpy(ei),
                      edge_mask=torch.from_numpy(em))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=atol)
    fan = (3, 2)
    sizes = np.cumprod((8,) + fan)
    xs = [rng.standard_normal((s, F)).astype(np.float32) for s in sizes]
    ms = [rng.random(s) < 0.7 for s in sizes]
    ms[0][-1] = False  # a padded seed
    want = jax.jit(lambda p, xs, ms: jnets.apply_tree(js, p, xs, ms, fan))(
        pj, [jnp.asarray(v) for v in xs], [jnp.asarray(m) for m in ms])
    got = tnets.apply_tree(ts, pt, [torch.from_numpy(v) for v in xs],
                           [torch.from_numpy(m) for m in ms], fan)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=atol)
    with pytest.raises(ValueError, match="exact-leaf"):
        tnets.apply_tree(ts, pt, [torch.from_numpy(v) for v in xs[:2]],
                         [torch.from_numpy(m) for m in ms[:2]], fan,
                         leaf_agg=torch.zeros(sizes[1], F))


@pytest.mark.parametrize("module", ["sage", pytest.param("gcn", marks=pytest.mark.slow)])
def test_bn_full_graph_eval_matches(world, module):
    """The single and the pair full-graph eval under ``use_bn``: bn1 and bn2
    over all N rows, each net with its own statistics, one SpMM per layer
    for the pair (no x_agg table)."""
    js, ts = _spec_pair(module=module, use_bn=True, num_layers=2)
    (p1, q1), (p2, q2) = _params(ts, 4), _params(ts, 5)
    jd, td = _datas(world)
    scale = 0.3 if module == "gcn" else 1.0  # keep the layers' sums O(1)
    jinf = JInfer(js, None, N, backend="xla", csr=jd.csr, indptr_np=np.asarray(jd.csr.indptr))
    tinf = TInfer(ts, td.csr)
    np.testing.assert_allclose(tinf(q1, td.x * scale).numpy(),
                               np.asarray(jinf(p1, jd.x * scale)), atol=ATOL)
    for a, b in zip(tinf.pair(q1, q2, td.x * scale), jinf.pair(p1, p2, jd.x * scale)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    with pytest.raises(ValueError, match="use_bn"):
        TInfer(ts, td.csr, x_agg=td.x)


@pytest.mark.slow
def test_bn_ct_epoch_matches(world):
    """One co-teaching epoch of sage under ``use_bn`` (bn leaves trained by
    Adam): summed metrics and params at 1e-5."""
    js, ts = _spec_pair(module="sage", use_bn=True, num_layers=2)
    jd, td = _datas(world)
    opt = optax.adam(LR)
    (p1, q1), (p2, q2) = _params(ts, 1), _params(ts, 2)
    s1, s2 = (TS.state_from_params(q, _adam) for q in (q1, q2))
    epoch = jax.jit(JS.ct_epoch_fn(js, opt, FANOUTS, "coteaching", 0.1, False))
    j1, j2, jm = epoch(JS.TrainState(p1, opt.init(p1)), JS.TrainState(p2, opt.init(p2)), jd,
                       jnp.asarray(world["seeds"]), jnp.asarray(world["masks"]),
                       jax.random.key(3), jnp.float32(0.25))
    tm = TS.ct_epoch(ts, s1, s2, td, torch.from_numpy(world["seeds"]).long(),
                     torch.from_numpy(world["masks"]), torch.Generator().manual_seed(3),
                     0.25, FANOUTS)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=ATOL, err_msg=k)
    _assert_tree(j1.params, s1.params, ATOL)
    _assert_tree(j2.params, s2.params, ATOL)


# ------------------------------------------------------------------- GAT


def test_gat_forward_matches(world):
    """``_gat_forward`` without and with an edge mask (node 0 without a
    genuine self-loop: the JAX package's masked adjacency is defined)."""
    js, ts = _spec_pair(module="gat", num_layers=2)
    pj, pt = _params(ts, 6, perturb=False)
    assert [sorted(p) for p in pt["layers"]] == [["a", "w"], ["a", "w"]]
    rng = np.random.default_rng(7)
    x, ei = world["x"], world["ei"]
    em = rng.random(ei.shape[1]) < 0.6
    fwd = jax.jit(lambda p, x, ei, m: jnets._gat_forward(js, p, x, ei, N, m))
    for mask in (None, em):
        want = fwd(pj, jnp.asarray(x), jnp.asarray(ei), None if mask is None else jnp.asarray(mask))
        got = tnets._gat_forward(ts, pt, torch.from_numpy(x), torch.from_numpy(ei), N,
                                 None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # a node without in-edges gets 0, as in the JAX package
    assert (np.bincount(ei[1], minlength=N) == 0).any()


def test_gat_self_loop_quirk(world):
    """With a genuine self-loop on node 0 and masked edges after it, the JAX
    package routes the masked edges to (0, 0) and scatters False there; on
    the CPU the last write wins, so it drops that self-loop (ROADMAP queue
    3). The port keeps it: its row 0 equals the JAX package's on the genuine
    edges alone, and differs from its masked result."""
    js, ts = _spec_pair(module="gat", num_layers=2)
    pj, pt = _params(ts, 8, perturb=False)
    x = jnp.asarray(world["x"])
    ei = np.concatenate([[[0], [0]], world["ei"]], axis=1).astype(np.int32)
    em = np.ones(ei.shape[1], bool)
    em[5:] = False  # masked edges after the genuine (0, 0)
    fwd = jax.jit(lambda p, x, ei, m: jnets._gat_forward(js, p, x, ei, N, m))
    masked = np.asarray(fwd(pj, x, jnp.asarray(ei), jnp.asarray(em)))
    genuine = np.asarray(fwd(pj, x, jnp.asarray(ei[:, em]), None))
    got = tnets._gat_forward(ts, pt, torch.from_numpy(world["x"]), torch.from_numpy(ei), N,
                             torch.from_numpy(em)).numpy()
    np.testing.assert_allclose(got, genuine, atol=ATOL)
    assert np.abs(masked[0] - genuine[0]).max() > 1e-3  # JAX lost the self-loop
    np.testing.assert_allclose(masked[1:], genuine[1:], atol=ATOL)


def test_gat_baseline_epoch_matches(world):
    """The baseline epoch's GAT branch (edge-list forward on the flat
    subgraph of each sampled tree, the seeds' rows kept): summed metrics and
    params at 1e-5; the co-teaching step refuses gat."""
    js, ts = _spec_pair(module="gat", num_layers=2)
    jd, td = _datas(world)
    opt = optax.adam(LR)
    p, q = _params(ts, 9, perturb=False)
    s = TS.state_from_params(q, _adam)
    mat = np.full((C, C), 0.1) + np.eye(C) * 0.5
    epoch = JS.make_baseline_epoch(js, opt, FANOUTS)
    jn, jm = epoch(JS.TrainState(jax.tree.map(jnp.copy, p), opt.init(p)), jd,
                   jnp.asarray(world["seeds"]), jnp.asarray(world["masks"]),
                   jax.random.key(5), jnp.asarray(mat, jnp.float32))
    tm = TS.baseline_epoch(ts, s, td, torch.from_numpy(world["seeds"]).long(),
                           torch.from_numpy(world["masks"]), torch.Generator().manual_seed(5),
                           torch.from_numpy(mat).float(), FANOUTS)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=ATOL, err_msg=k)
    _assert_tree(jn.params, s.params, ATOL)
    with pytest.raises(NotImplementedError, match="gat"):
        TS.ct_epoch(ts, s, s, td, torch.from_numpy(world["seeds"]).long(),
                    torch.from_numpy(world["masks"]), torch.Generator(), 0.2, FANOUTS)


def test_gat_full_graph_eval_matches(world):
    """GAT's eval is dense attention over the full edge list (the JAX
    package's ``FullGraphInference`` calls ``_gat_forward`` without a mask,
    which ``test_gat_forward_matches`` holds against it); its pair is two
    single passes."""
    _, ts = _spec_pair(module="gat", num_layers=2)
    (_, q1), (_, q2) = (_params(ts, k, perturb=False) for k in (10, 11))
    _, td = _datas(world)
    tinf = TInfer(ts, td.csr)
    for q, got in zip((q1, q2), tinf.pair(q1, q2, td.x)):
        want = tnets._gat_forward(ts, q, td.x, torch.from_numpy(world["ei"]), N, None)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# ---------------------------------------------------------- SIMA, ct_loss2


def test_sima_matches(world):
    pt = tL.sima_init(torch.Generator().manual_seed(12), N, F)
    assert {k: tuple(v.shape) for k, v in pt.items()} == {"w_i": (F, N), "w_j": (F, N)}
    pj = {k: jnp.asarray(v.numpy()) for k, v in pt.items()}
    x = world["x"] * 0.3
    want = np.asarray(jax.jit(jL.sima)(pj, jnp.asarray(x)))
    got = tL.sima(pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=ATOL)
    # dropout draws from the generator: kept entries scaled, both factors masked
    got_d = tL.sima(pt, torch.from_numpy(x), rate=0.5, train=True,
                    gen=torch.Generator().manual_seed(1))
    assert got_d.shape == (N, N) and not torch.equal(got_d, got)
    assert torch.equal(tL.sima(pt, torch.from_numpy(x), rate=0.5, train=False), got)


@pytest.mark.parametrize("masked", [pytest.param(False, marks=pytest.mark.slow), True])
def test_ct_loss2_matches(masked):
    rng = np.random.default_rng(13)
    b = 40
    l1, l2 = (rng.standard_normal((b, C)).astype(np.float32) for _ in range(2))
    l1[1::4] = l1[0::4]  # tied losses
    y1, y2 = (rng.integers(0, C, b).astype(np.int32) for _ in range(2))
    clean = rng.random(b) < 0.7
    mask = np.arange(b) < b - 7 if masked else None
    want = jax.jit(jct.ct_loss2)(jnp.asarray(l1), jnp.asarray(l2), jnp.asarray(y1),
                                 jnp.asarray(y2), jnp.float32(0.3), jnp.asarray(clean),
                                 None if mask is None else jnp.asarray(mask))
    got = tct.ct_loss2(torch.from_numpy(l1), torch.from_numpy(l2), torch.from_numpy(y1),
                       torch.from_numpy(y2), 0.3, torch.from_numpy(clean),
                       None if mask is None else torch.from_numpy(mask))
    for k in ("keep_1", "keep_2", "noisy_1", "noisy_2"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    for k in ("loss_1", "loss_2", "pure_ratio_1", "pure_ratio_2"):
        np.testing.assert_allclose(float(getattr(got, k)), float(getattr(want, k)),
                                   atol=1e-6, err_msg=k)


# ----------------------------------------------- checkpoints and the entry


def test_gat_checkpoint_round_trip(tmp_path, world):
    """A GAT state's bundle restores bit for bit and takes the same next
    step."""
    _, ts = _spec_pair(module="gat", num_layers=2)
    s = TS.init_state(torch.Generator().manual_seed(3), ts, _adam)
    x, ei = torch.from_numpy(world["x"]), torch.from_numpy(world["ei"])

    def loss(st):
        return tnets.apply(ts, st.params, x, ei)["logits"].square().mean()

    TS._step((s,), loss(s))
    save_checkpoint(str(tmp_path / "gat"), (TS.state_tree(s),), {"epoch": 0})
    tmpl = TS.fresh_state_tree(tnets.init_params(torch.Generator().manual_seed(0), ts))
    (tree,), _ = load_checkpoint(str(tmp_path / "gat"), (tmpl,))
    back = TS.state_from_tree(tree, _adam)
    for st in (s, back):
        TS._step((st,), loss(st))
    for a, b in zip(tnets.parameters(s.params), tnets.parameters(back.params)):
        assert torch.equal(a, b)


BASE = dict(dataset_name="cora", synthetic_scale=40, num_runs=1, batch_size=64,
            hidden_size=16, num_layers=2, nbr_neighbors=[3, 2], seed=11,
            epoch_logger=False, device="cpu")


def _records(out_dir, event):
    rows = []
    for f in sorted(glob.glob(str(out_dir / "metrics" / "*.jsonl"))):
        rows += [json.loads(line) for line in open(f)]
    return {(r["run"], r["epoch"]): r for r in rows if r.get("event") == event}


def test_bn_kill_and_resume_through_main(tmp_path):
    """Co-teaching under ``use_bn`` through ``main``, killed after epoch 0
    and resumed to 2: the resumed epoch's records equal the uninterrupted
    run's exactly (the bundle carries the bn leaves and their moments)."""
    base = {**TDEFAULTS, **BASE, "use_bn": True, "train_type": "nalgo"}
    tmain(dict(copy.deepcopy(base), max_epochs=2, out_dir=str(tmp_path / "full")))
    ckpt = str(tmp_path / "kr" / "ck")
    killed = dict(copy.deepcopy(base), max_epochs=1, out_dir=str(tmp_path / "kr"),
                  ckpt_every=1, ckpt_path=ckpt)
    tmain(copy.deepcopy(killed))
    tmain(dict(copy.deepcopy(killed), resume=True, max_epochs=2))
    want, got = _records(tmp_path / "full", "epoch_ct"), _records(tmp_path / "kr", "epoch_ct")
    assert set(got) == set(want) == {(0, 0), (0, 1)}
    for k in set(want[(0, 1)]) - {"ts", "epoch_train_s", "epoch_eval_s", "edges_per_s"}:
        assert got[(0, 1)][k] == want[(0, 1)][k], k
    assert np.isfinite(want[(0, 1)]["loss_1"])


def test_gat_baseline_through_main(tmp_path):
    """``module_compare: gat`` with ``train_type: both``: sage co-teaching
    beside a GAT baseline trained on flat subgraphs and evaluated on the
    full edge list."""
    c = {**TDEFAULTS, **BASE, "module_compare": "gat", "train_type": "both",
         "compare_loss": "back", "max_epochs": 1, "out_dir": str(tmp_path / "o")}
    res = tmain(c)
    assert set(res) == {"nalgo", "baseline"}
    base = _records(tmp_path / "o", "epoch_baseline")
    assert len(base) == 1
    assert all(np.isfinite(r["loss"]) and 0.0 <= r["val_acc"] <= 1.0 for r in base.values())
