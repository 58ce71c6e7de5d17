"""Tensor parallelism (``model_parallel`` M > 1) on a (data, model) grid of
gloo ranks on the CPU, held against the JAX package's rule and the port's
own one-process steps and runs (the counterparts of
tests/test_tp_product_path.py).

In one process: the port's rule (``parallel/mesh.py::param_sharding``)
picks the leaves, and each model rank the column block, that the JAX
package's ``param_sharding`` picks on conftest's CPU mesh, for every net
at M = 2 and 4 and out sizes 7, 40 and 47; ``shard_params`` then
``gather_params`` (its all-gather given every rank's blocks) is bit-equal.

One launch of ``python tests/test_torch_port_tp.py <rank> <world> <pg>
<in> <out> tp`` (the spawner of tests/test_torch_port_dist.py) at (D, M)
= (1, 2) runs, from the params the one-process steps start from: one step
each of co-teaching, CoDis, the baseline, CTP, TE (the rewired contrast
on), H (the pseudo net on), the CT finetune, ``use_bn`` co-teaching and the
GAT baseline, and a two-step co-teaching epoch; the first-layer weight
gradient of a 3-layer stack; the round trip of every state's params
through the model axis; and ``main`` on a small ``config_cora.yml`` at
M = 2: the whole run, and a run killed after epoch 0 and resumed. The
steps' summed metrics must be within 1e-5 relative of one process's and
their params within 1e-4 (f32; the model axis sums the input gradients in
another order), the same on every rank; each rank's picked leaves and
their Adam moments [in, out / M]; ``main``'s losses within 1e-4 relative
and its accuracies within 5e-3 (tests/test_tp_product_path.py's bound) of
one process; the resumed epoch's losses and param hash bit-equal to the
uninterrupted TP run's, and its checkpoint, loaded in one process with
``do_train: false``, within 1e-3 of the TP run's last accuracies. (D, M) =
(2, 2) on four ranks is marked slow.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_dist import _finish, _start  # noqa: E402
from test_torch_port_dp_epochs import FANOUTS, TE_RATES, _inputs  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3
F, C = 10, 4  # the inputs' feature width and classes
STEP_KEYS = ("ct", "codi", "base", "ctp", "te", "h", "ctft", "bn", "gat", "epoch")


def _adam(params):
    return torch.optim.Adam(params, lr=LR)


def _flat(tree, prefix: str) -> dict:
    """A params nest as numpy arrays by dotted name."""
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree) for k2, v in _flat(tree[k], f"{prefix}.{k}").items()}
    if isinstance(tree, list):
        return {k2: v for i, t in enumerate(tree) for k2, v in _flat(t, f"{prefix}.{i}").items()}
    return {prefix: tree.detach().numpy().copy()}


def _specs() -> dict:
    """The steps' nets. The co-teaching, CTP, TE, H, CT, BN and GAT output
    layers have 4 columns (sharded at M = 2 and 4); the CoDis and baseline
    ones 5 (whole, as cora's 7 and products' 47 are)."""
    from noise_gnn_tpu_torch.models import nets

    base = dict(in_size=F, hidden_size=16, out_size=C, num_layers=2, dropout=0.5)
    return {"sage": nets.NetSpec(module="sage", **base),
            "sage5": nets.NetSpec(module="sage", **dict(base, out_size=5)),
            "sageH": nets.NetSpec(module="sageH", **base),
            "sageFC": nets.NetSpec(module="sageFC", **base),
            "bn": nets.NetSpec(module="sage", use_bn=True, **base),
            "gat": nets.NetSpec(module="gat", **base)}


def _task_steps(z: dict, mesh) -> dict:
    """One step of each epoch loop (and a two-step co-teaching epoch) from
    params made from fixed seeds, the states sharded by ``mesh``; the
    params gathered whole after it, and each state's local leaf and moment
    widths. ``mesh`` None is the one-process run."""
    from noise_gnn_tpu_torch.graph.containers import CSRGraph
    from noise_gnn_tpu_torch.models import nets
    from noise_gnn_tpu_torch.models.convert import gather_params, whole_widths
    from noise_gnn_tpu_torch.train import steps as S

    def data(p):
        x, y, yhn = (torch.from_numpy(np.asarray(z[f"{p}_{k}"])) for k in ("x", "y", "yhn"))
        return S.GraphData(x, y.long(), yhn.long(), y == yhn,
                           CSRGraph.from_coo(z[f"{p}_ei"], x.shape[0]))

    def states(spec, *keys):
        return [S.state_from_params(nets.init_params(torch.Generator().manual_seed(k), spec),
                                    _adam, mesh) for k in keys]

    def gen():
        return torch.Generator().manual_seed(7)

    out, metrics = {}, {}

    def keep(tag, m, *ss):
        metrics[tag] = m
        for i, s in enumerate(ss):
            out.update(_flat(gather_params(mesh, s.params), f"{tag}.{i}"))
            widths = nets.parameters(whole_widths(s.params))
            rows = []
            for p, w in zip(nets.parameters(s.params), widths):
                st = s.opt.state[p]
                rows.append([p.shape[-1] if p.dim() == 2 else -1, w if w is not None else -1,
                             st["exp_avg"].shape[-1] if p.dim() == 2 else -1,
                             st["exp_avg_sq"].shape[-1] if p.dim() == 2 else -1])
            out[f"{tag}.{i}.widths"] = np.asarray(rows)

    sp = _specs()
    fd, bd = data("f"), data("b")
    fs = torch.from_numpy(z["f_seeds"]).long()[None]
    fm = torch.ones_like(fs, dtype=torch.bool)
    bs = torch.from_numpy(z["b_seeds"]).long()[None]
    bm = torch.from_numpy(z["b_mask"])[None]

    s1, s2 = states(sp["sage"], 1, 2)
    keep("ct", S.ct_epoch(sp["sage"], s1, s2, bd, bs, bm, gen(), 0.25, FANOUTS, mesh=mesh),
         s1, s2)
    s1, s2 = states(sp["sage5"], 3, 4)
    keep("codi", S.ct_epoch(sp["sage5"], s1, s2, bd, bs, bm, gen(), 0.25, FANOUTS, algo="codi",
                            co_lambda=0.3, mesh=mesh), s1, s2)
    (s,) = states(sp["sage5"], 5)
    keep("base", S.baseline_epoch(sp["sage5"], s, bd, bs, bm, gen(), torch.eye(5) * 0.7 + 0.06,
                                  FANOUTS, compare_loss="back", mesh=mesh), s)

    pl = nets.NetSpec(module="sagePL", nbr_nodes=fd.x.shape[0],
                      **{k: getattr(sp["sage"], k) for k in
                         ("in_size", "hidden_size", "out_size", "num_layers", "dropout")})
    s1, s2 = states(pl, 6, 7)
    keep("ctp", S.ctp_epoch(pl, s1, s2, fd, fs, fm, gen(), 0.25, FANOUTS, use_cr=True,
                            use_ncr=True, beta=0.7, mesh=mesh), s1, s2)
    s1, s2 = states(pl, 8, 9)
    keep("te", S.te_epoch(pl, s1, s2, fd, fs, fm, gen(), 0.25, FANOUTS, mesh=mesh,
                          use_contrast=True, spl_cont_beta=0.7, **TE_RATES), s1, s2)
    s1, s2 = states(sp["sageH"], 10, 11)
    (sq,) = states(sp["sage"], 12)
    keep("h", S.h_epoch(sp["sageH"], sp["sage"], s1, s2, sq, fd, fs, fm, gen(), 0.25, FANOUTS,
                        use_pseudo=True, beta=0.7, rewire_rate=0.2, mesh=mesh), s1, s2, sq)

    x, g0 = bd.x, bd.csr
    views = {"orig": (x, g0), "edge_s": (x, CSRGraph.from_coo(z["v1_ei"], x.shape[0])),
             "feat_s": (x[:, torch.from_numpy(z["v_cols"])], g0),
             "large": (x[torch.from_numpy(z["v_rows"])],
                       CSRGraph.from_coo(z["v2_ei"], x.shape[0]))}
    (s,) = states(sp["sageFC"], 13)
    out["ctft.init"] = s.params["proj"]["b"].detach().numpy().copy()
    ns = torch.from_numpy(z["noisy_seeds"]).long()[None]
    keep("ctft", S.contrast_epoch(sp["sageFC"], s, bd, views, bs, bm, ns, torch.ones_like(bm),
                                  gen(), FANOUTS, 0.7, mesh), s)

    s1, s2 = states(sp["bn"], 14, 15)
    keep("bn", S.ct_epoch(sp["bn"], s1, s2, bd, bs, bm, gen(), 0.25, FANOUTS, mesh=mesh),
         s1, s2)
    (s,) = states(sp["gat"], 16)
    keep("gat", S.baseline_epoch(sp["gat"], s, bd, bs, bm, gen(), torch.eye(C), FANOUTS,
                                 mesh=mesh), s)

    # a two-step epoch: the second step starts from the sharded state the
    # first left
    s1, s2 = states(sp["sage"], 17, 18)
    seeds2 = torch.cat([bs, bs.flip(1)])
    keep("epoch", S.ct_epoch(sp["sage"], s1, s2, bd, seeds2, torch.cat([bm, bm.flip(1)]),
                             gen(), 0.25, FANOUTS, mesh=mesh), s1, s2)
    for tag, m in metrics.items():
        out[f"{tag}.metrics"] = torch.stack([m[k] for k in sorted(m)]).numpy()

    out.update(_grad3(z, mesh))
    return out


def _grad3(z: dict, mesh) -> dict:
    """The first layer's weight gradients of a 3-layer SAGE stack (every
    hidden product sharded under TP) on one batch, gathered whole."""
    from noise_gnn_tpu_torch.graph.containers import CSRGraph
    from noise_gnn_tpu_torch.losses.coteaching import cross_entropy
    from noise_gnn_tpu_torch.models import nets
    from noise_gnn_tpu_torch.models.convert import gather_leaves, shard_params, whole_widths
    from noise_gnn_tpu_torch.ops.sampler import sample_khop_tree
    from noise_gnn_tpu_torch.parallel.mesh import all_reduce_sum_, gather_rows
    from noise_gnn_tpu_torch.train.steps import _local

    spec = nets.NetSpec(module="sage", in_size=F, hidden_size=16, out_size=C, num_layers=3,
                        dropout=0.0)
    params = shard_params(mesh, nets.init_params(torch.Generator().manual_seed(21), spec))
    for p in nets.parameters(params):
        p.requires_grad_(True)
    x = torch.from_numpy(z["b_x"])
    csr = CSRGraph.from_coo(z["b_ei"], x.shape[0])
    seeds, mask = torch.from_numpy(z["b_seeds"]).long(), torch.from_numpy(z["b_mask"])
    ls, lm = _local(mesh, seeds, mask)
    tb = sample_khop_tree(torch.Generator().manual_seed(3), csr, ls, (3, 3, 3), lm, mesh)
    o = gather_rows(mesh, nets.apply_tree(spec, params, tb.gather_features(x), list(tb.masks),
                                          tb.fanouts, mesh=mesh)["logits"])
    w = mask.float()
    ((cross_entropy(o, torch.from_numpy(z["b_yhn"]).long()[seeds]) * w).sum()
     / w.sum()).backward()
    first = params["convs"][0]
    widths = [whole_widths(params)["convs"][0][k] for k in ("w_neigh", "w_root")]
    grads = [first[k].grad if mesh is None else all_reduce_sum_(mesh, first[k].grad)
             for k in ("w_neigh", "w_root")]
    grads = gather_leaves(mesh, grads, widths)
    return {"grad3.w_neigh": grads[0].numpy(), "grad3.w_root": grads[1].numpy()}


def _task_roundtrip(mesh) -> dict:
    """Every net's whole params through shard_params and gather_params."""
    from noise_gnn_tpu_torch.models import nets
    from noise_gnn_tpu_torch.models.convert import gather_params, shard_params

    out = {}
    for name, spec in _specs().items():
        for s in (spec, dataclasses.replace(spec, module="sagePL", nbr_nodes=6)) \
                if name == "sage" else (spec,):
            whole = nets.init_params(torch.Generator().manual_seed(31), s)
            back = gather_params(mesh, shard_params(mesh, whole))
            ok = all(torch.equal(a, b) for a, b in zip(nets.parameters(whole),
                                                      nets.parameters(back)))
            out[f"roundtrip.{s.module}.{name}"] = np.asarray(ok)
    return out


def _task_main(z: dict) -> dict:
    from noise_gnn_tpu_torch.main import main

    out = {}
    for i, cfg in enumerate(json.loads(str(z["configs"]))):
        res = main(cfg)
        if isinstance(res, dict):
            out.update({f"main_{i}_{b}": np.asarray(tuple(res[b])) for b in res})
    return out


def _worker(argv) -> None:
    rank, world, pg, inp, outp, task = argv
    sys.path.insert(0, str(ROOT))
    from noise_gnn_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(init_method=f"file://{pg}", world_size=int(world), rank=int(rank),
                         backend="gloo")
    with np.load(inp) as f:
        z = {k: f[k] for k in f.files}
    mesh = make_mesh(model_parallel=int(z["mp"]))
    out = {"rank": np.asarray([mesh.rank, mesh.model_rank])}
    out.update(_task_steps(z, mesh))
    out.update(_task_roundtrip(mesh))
    out.update(_task_main(z))
    np.savez(outp, **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
                      for k, v in out.items()})
    torch.distributed.destroy_process_group()


# ------------------------------------------------------------------ configs


def _cfg(tmp: Path, tag: str, **over) -> dict:
    from noise_gnn_tpu_torch.utils.config import load_config

    c = load_config(str(ROOT / "configs" / "config_cora.yml"))
    c.update(device="cpu", synthetic_scale=10, hidden_size=64, nbr_neighbors=[5, 3],
             batch_size=64, max_epochs=2, num_runs=1, reinit_retries=0, epoch_logger=False,
             out_dir=str(tmp / tag), data_dir=str(tmp / "data"))
    c.update(over)
    return c


def _main_configs(tmp: Path, mp: int) -> list:
    """``main`` at M: the whole run (both branches), then a co-teaching run
    checkpointed every epoch and killed after epoch 0, then its resume."""
    ckpt = str(tmp / "ckpt" / "ct")
    full = _cfg(tmp, "full", model_parallel=mp, ckpt_every=1)
    killed = _cfg(tmp, "killed", model_parallel=mp, train_type="nalgo", max_epochs=1,
                  ckpt_every=1, ckpt_path=ckpt)
    resumed = dict(killed, out_dir=str(tmp / "resumed"), max_epochs=2, resume=True)
    return [full, killed, resumed]


def _records(cfg: dict, event: str) -> list:
    (path,) = (Path(cfg["out_dir"]) / "metrics").glob("*.jsonl")  # rank 0's alone
    return [r for r in (json.loads(line) for line in path.read_text().splitlines())
            if r.get("event") == event]


# ------------------------------------------------------------- in-process


_RULE_CASES = [(module, False) for module in ("sage", "gcn", "sagePL", "sageH", "sageFC",
                                               "gcn_head", "gat")] + [("sage", True)]


@pytest.mark.parametrize("out", [7, 40, 47])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("module,use_bn", _RULE_CASES,
                         ids=[f"{m}{'_bn' if b else ''}" for m, b in _RULE_CASES])
def test_rule_matches_jax(module, use_bn, m, out):
    """The port's rule picks the JAX package's leaves, and each model rank
    holds the column block JAX gives the devices of its model index, on
    conftest's 8-device CPU mesh laid out as (8 / M, M)."""
    import jax
    import jax.numpy as jnp

    from noise_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
    from noise_gnn_tpu.parallel.mesh import param_sharding as jsharding
    from noise_gnn_tpu_torch.models import nets
    from noise_gnn_tpu_torch.models.convert import params_to_jax, shard_params
    from noise_gnn_tpu_torch.parallel.mesh import Mesh, column_block, param_sharding

    spec = nets.NetSpec(module=module, in_size=100, hidden_size=256, out_size=out,
                        num_layers=3, use_bn=use_bn, nbr_nodes=12)
    params = nets.init_params(torch.Generator().manual_seed(0), spec)
    jp = jax.tree.map(jnp.asarray, params_to_jax(params))
    jm = jmake_mesh(model_parallel=m)
    want = jax.tree.leaves(jsharding(jm, jp))
    leaves = jax.tree.leaves(jp)
    meshes = [Mesh({"data": 8 // m, "model": m}, 0, None, None, r) for r in range(m)]
    got = jax.tree.leaves(param_sharding(meshes[0], params_to_jax(params)),
                          is_leaf=lambda t: isinstance(t, tuple))
    assert [tuple(s.spec) for s in want] == [tuple(s) for s in got]
    assert any(got) and not all(got)
    # the blocks: JAX's index of the device at (d, r), every d, is rank r's
    port = [jax.tree.leaves(params_to_jax(shard_params(mesh, params))) for mesh in meshes]
    for i, (sh, leaf) in enumerate(zip(want, leaves)):
        idx = sh.devices_indices_map(leaf.shape)
        for d in range(8 // m):
            for r in range(m):
                cols = idx[jm.devices[d, r]][1] if leaf.ndim == 2 else slice(None)
                full = np.asarray(leaf)
                np.testing.assert_array_equal(port[r][i], full[:, cols] if leaf.ndim == 2
                                              else full)
                if got[i]:
                    assert cols == column_block(meshes[r], leaf.shape[1])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("module", ["sage", "sagePL", "sageFC", "gat"])
def test_shard_then_gather_is_bit_equal(monkeypatch, module, m):
    """``gather_params`` of one rank's blocks, its all-gather given every
    model rank's flat blocks, is the whole params bit for bit; whole
    params pass through ``gather_params`` and blocks through
    ``shard_params`` unchanged."""
    from noise_gnn_tpu_torch.models import convert, nets
    from noise_gnn_tpu_torch.parallel.mesh import Mesh

    spec = nets.NetSpec(module=module, in_size=12, hidden_size=16, out_size=8, num_layers=3,
                        nbr_nodes=5)
    whole = nets.init_params(torch.Generator().manual_seed(1), spec)
    meshes = [Mesh({"data": 1, "model": m}, 0, None, None, r, object()) for r in range(m)]
    local = [convert.shard_params(mesh, whole) for mesh in meshes]

    # the model axis's all-gather: first each rank's flat blocks are
    # recorded, then every call gets them all, in rank order
    flats = []
    monkeypatch.setattr(convert, "all_gather", lambda axis, t: (flats.append(t),
                                                                t.repeat(m, 1))[1])
    for r, mesh in enumerate(meshes):
        convert.gather_params(mesh, local[r])
    monkeypatch.setattr(convert, "all_gather", lambda axis, t: torch.cat(flats))
    for r, mesh in enumerate(meshes):
        back = convert.gather_params(mesh, local[r])
        for a, b in zip(nets.parameters(whole), nets.parameters(back)):
            assert torch.equal(a, b)
        again = convert.gather_params(mesh, whole)
        assert all(a is b for a, b in zip(nets.parameters(whole), nets.parameters(again)))
        twice = convert.shard_params(mesh, local[r])
        assert all(a is b for a, b in zip(nets.parameters(local[r]), nets.parameters(twice)))
    assert any(p.shape != q.shape for p, q in zip(nets.parameters(whole),
                                                  nets.parameters(local[0])))


# ------------------------------------------------------------------ groups


@pytest.fixture(scope="module", params=[(1, 2), pytest.param((2, 2), marks=pytest.mark.slow)],
                ids=["d1m2", "d2m2"])
def grid(request, tmp_path_factory):
    """The TP group at (D, M), and beside it, in this process, the same
    steps and ``main``'s whole run at M = 1 (one process)."""
    from noise_gnn_tpu_torch.main import main

    d, m = request.param
    tmp = tmp_path_factory.mktemp(f"tp{d}{m}")
    (tmp / "ranks").mkdir()
    z = dict(_inputs(), mp=np.asarray(m))
    cfgs = _main_configs(tmp / "ranks", m)
    procs = _start(tmp / "ranks", d * m, "tp", dict(z, configs=np.asarray(json.dumps(cfgs))),
                   script=__file__)
    one = _task_steps(z, None)
    one_cfg = dict(cfgs[0], out_dir=str(tmp / "one"), model_parallel=1, ckpt_every=0)
    one_res = main(one_cfg)
    outs = _finish(tmp / "ranks", procs, timeout=400)
    return dict(d=d, m=m, outs=outs, one=one, cfgs=cfgs, one_cfg=one_cfg, one_res=one_res,
                tmp=tmp)


@pytest.mark.parametrize("key", STEP_KEYS)
def test_tp_step_matches_one_process(grid, key):
    """One step of each epoch loop at (D, M): the summed metrics within
    1e-5 relative of one process's, every param (gathered whole) within
    1e-4 and the same on every rank. sageFC's projection bias feeds a
    batch norm, so its gradient is rounding noise that Adam turns into a
    step of up to lr either way (tests/test_torch_port_ct.py): it is held
    to lr from its initial value instead."""
    one, outs = grid["one"], grid["outs"]
    names = [k for k in one if k.startswith(f"{key}.") and not k.endswith((".metrics",
                                                                          ".widths", ".init"))]
    assert names
    for o in outs:
        np.testing.assert_allclose(o[f"{key}.metrics"], one[f"{key}.metrics"], rtol=1e-5,
                                   atol=1e-6)
        for k in names:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
            if k.endswith(".proj.b") and key == "ctft":
                assert np.abs(o[k] - one["ctft.init"]).max() <= LR * 1.001
            else:
                np.testing.assert_allclose(o[k], one[k], rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("key", STEP_KEYS)
def test_tp_states_sharded(grid, key):
    """Each rank's picked leaves, and their ``exp_avg``/``exp_avg_sq``,
    are [in, out / M] (after the epoch too); the others whole; every state
    has sharded leaves. One process holds them whole."""
    m = grid["m"]
    for o in grid["outs"]:
        tables = [o[k] for k in o if k.startswith(f"{key}.") and k.endswith(".widths")]
        assert tables
        for t in tables:
            for local, width, avg, sq in t:
                if local < 0:
                    continue
                want = width // m if width % m == 0 else width
                assert local == avg == sq == want
            assert any(row[0] < row[1] for row in t)
    for k in grid["one"]:
        if k.startswith(f"{key}.") and k.endswith(".widths"):
            assert all(row[0] == row[1] == row[2] for row in grid["one"][k] if row[0] >= 0)


def test_tp_three_layer_gradient(grid):
    """The first layer's weight gradient of a 3-layer stack equals one
    process's (within 1e-5): it needs the model-axis sum of every hidden
    product's input gradient, without which each rank's is a share."""
    for o in grid["outs"]:
        for k in ("grad3.w_neigh", "grad3.w_root"):
            np.testing.assert_allclose(o[k], grid["one"][k], rtol=0, atol=1e-5, err_msg=k)
            assert np.abs(grid["one"][k]).max() > 1e-3


def test_tp_roundtrip_on_ranks(grid):
    """Every net's params through ``shard_params`` and ``gather_params`` on
    the ranks: bit-equal."""
    for o in grid["outs"]:
        keys = [k for k in o if k.startswith("roundtrip.")]
        assert len(keys) == 7 and all(bool(o[k]) for k in keys)
    assert sorted({tuple(o["rank"]) for o in grid["outs"]}) == [
        (d, m) for d in range(grid["d"]) for m in range(grid["m"])]


def test_tp_main_matches_one_process(grid):
    """``main`` on a small ``config_cora.yml`` at (D, M): every epoch's
    losses within 1e-4 relative of one process's and both branches'
    accuracies within 5e-3; the ranks' results equal; every epoch record
    carries its param hash (checked equal across the ranks as it was
    written)."""
    outs, cfg, one = grid["outs"], grid["cfgs"][0], grid["one_cfg"]
    for b in ("nalgo", "baseline"):
        for o in outs:
            np.testing.assert_array_equal(o[f"main_0_{b}"], outs[0][f"main_0_{b}"])
        np.testing.assert_allclose(outs[0][f"main_0_{b}"], tuple(grid["one_res"][b]), rtol=0,
                                   atol=5e-3)
    for event, keys in (("epoch_ct", ("loss_1", "loss_2")), ("epoch_baseline", ("loss",))):
        tp, solo = _records(cfg, event), _records(one, event)
        assert len(tp) == len(solo) == 2
        for a, b in zip(tp, solo):
            assert len(a["param_hash"]) == 16
            for k in keys:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=f"{event} {k}")


def test_tp_resume_and_load_in_one_process(grid, tmp_path):
    """A co-teaching run at (D, M) killed after epoch 0 and resumed: the
    resumed epoch's losses and param hash equal the uninterrupted TP run's
    bit for bit. The checkpoint, whole (the JAX package's npz format),
    loads in one process with ``do_train: false``: its accuracies within
    1e-3 of the TP run's last epoch."""
    from noise_gnn_tpu_torch.main import main

    full, killed, resumed = grid["cfgs"]
    (want,) = [r for r in _records(full, "epoch_ct") if r["epoch"] == 1]
    (got,) = _records(resumed, "epoch_ct")
    assert got["epoch"] == 1
    for k in ("loss_1", "loss_2", "pure_ratio_1", "param_hash", "val_acc_1", "test_acc_2"):
        assert got[k] == want[k], k
    load = dict(killed, out_dir=str(tmp_path / "load"), model_parallel=1, do_train=False,
                resume=False)
    res = main(load)
    last = got  # the resumed run wrote the checkpoint last, after epoch 1
    for i in ("1", "2"):
        acc = res["loaded"][int(i) - 1]
        assert abs(acc["valid"] - last[f"val_acc_{i}"]) <= 1e-3
        assert abs(acc["test"] - last[f"test_acc_{i}"]) <= 1e-3


if __name__ == "__main__":
    _worker(sys.argv[1:])
